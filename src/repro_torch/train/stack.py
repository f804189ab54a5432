"""Fused projected backward over the layer stack (paper §3.5): the
counterpart of ``repro/train/stack.py::fused_value_and_grad``, written as
an explicit loop.

* The forward saves each layer's input carry and keeps no graph
  (``no_grad``): activation memory is one carry per layer.
* The backward walks the layers in reverse. Per layer it recomputes the
  block with grad enabled and calls ``torch.autograd.grad`` on (carry in,
  the layer's weight shadows and float leaves), with a cotangent for every
  float entry of the carry (``h``; an MoE model's ``aux`` too, whose
  ``dL/daux`` comes from the head); each GaLore cotangent is projected to
  rank r at once, so only one layer's full-rank ``dL/dW`` exists at any
  moment. The recompute runs the forward's kernels at the forward's
  shapes, so it takes the routing decisions the forward took.
* The head and embedding run with grad around the stack; their GaLore
  cotangents (the head) are projected after their own backward.
* ``ctx`` may hold differentiable leaves (a hybrid's shared block, which
  ``embed`` threads to every site): each layer's recompute differentiates
  them too, their full-rank gradients are summed over all layers in
  place, one float32 accumulator a leaf, and the sum goes back through
  ``embed`` with the carry's cotangent (the reference's ``g_ctx``), so it
  joins the non-segment gradients before their projection.
* A segment's ``pre`` (the encoder-decoder's bridge) runs with grad in
  the forward, and its gradient is taken after the segment's layers in
  the backward: w.r.t. its input carry, which goes on into the previous
  segment's layers, and w.r.t. the non-segment leaves it reads, which
  join the embedding's and the head's gradients. The carry's entries may
  change from one segment to the next; each segment's backward follows
  the entries of its own input carry.

INT8 weights enter as ``QVirtual``s (``core.quant.virtualize``): the model
consumes the codes through ``quantized_dense`` and ``dL/dW`` lands on the
zeros shadow, so no full-precision weight is formed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.core import projector, quant
from repro_torch.core.quant import QTensor, QVirtual
from repro_torch.models.base import ModelBundle, layer_params


def _virt(tree):
    """QTensor leaves → QVirtual; float leaves → fresh leaves that require
    grad. The tree's differentiable tensors are listed in ``_diff``."""
    if isinstance(tree, dict):
        return {k: _virt(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return quant.virtualize(tree)
    return tree.detach().requires_grad_(True)


def _diff(tree) -> List[torch.Tensor]:
    """The differentiable tensor of each leaf, in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _diff(tree[k])]
    return [tree.shadow if isinstance(tree, QVirtual) else tree]


def _leaves(tree) -> list:
    """Leaves in sorted-key order (None kept)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _like(tree, flat: list):
    """A tree shaped like ``tree`` holding ``flat`` (sorted-key order)."""
    return _fill(tree, iter(flat))


def _fill(tree, it):
    # module-level recursion: a nested self-referencing function would form
    # a reference cycle that keeps ``it``, and the gradients it iterates,
    # on the device until the garbage collector runs
    if isinstance(tree, dict):
        return {k: _fill(tree[k], it) for k in sorted(tree)}
    return next(it)


def project_leaf(g: torch.Tensor, P, side: Optional[str] = None):
    """Project one full-rank gradient (leading batch dims ride the matmul)
    into the rank-r subspace of ``P``; ``P is None`` passes ``g``."""
    if P is None:
        return g
    side = side or projector.galore_side(g.shape)
    return projector.project(g.to(torch.float32),
                             projector.maybe_dequantize(P), side)


def _project_tree(g, P, side=None):
    """:func:`project_leaf` over a subtree (a non-segment entry such as
    ``mtp_block``), leaf by leaf, as the reference's
    ``_project_cotangents``; ``side`` a like tree of sides, or None."""
    if isinstance(g, dict) and P is not None:
        return {k: _project_tree(v, P.get(k)) if side is None
                else _project_tree(v, P.get(k), side.get(k))
                for k, v in g.items()}
    return project_leaf(g, P, side)


def _grads(out, inputs: List[torch.Tensor], grad_out):
    """``d out / d inputs`` (zeros where unused); ``out`` a tensor or a
    list of tensors with ``grad_out`` the matching cotangents."""
    got = torch.autograd.grad(out, inputs, grad_outputs=grad_out,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, got)]


def _ctx_diff(ctx) -> List[torch.Tensor]:
    """``ctx``'s differentiable tensors (a QVirtual's shadow, a tensor
    that requires grad), in sorted-key order."""
    return [t for t in _diff(ctx) if torch.is_tensor(t) and t.requires_grad]


def _float_keys(carry) -> List[str]:
    """The carry's differentiable entries, in sorted order."""
    return sorted(k for k, v in carry.items() if v.is_floating_point())


def fused_value_and_grad(bundle: ModelBundle, params, batch,
                         proj_trees: Dict[str, Any], acc=None, sides=None):
    """Loss and gradients with the per-layer recompute backward.

    ``proj_trees``: ``{params key: tree like params[key] with P or None per
    leaf}``; cotangents of leaves with a P leave low-rank. ``{}`` gives
    full-rank gradients everywhere (refresh steps). ``sides``: ``{params
    key: a like tree of each leaf's side}`` where a leaf's side is not its
    shape's (a tensor-parallel rank's slice keeps the whole leaf's side);
    None takes each from the gradient's shape.

    Returns ``((loss, metrics), grads)``: ``grads`` is a tree like
    ``params``, float32 w.r.t. the virtual (dequantized) weights. Each
    stacked leaf's gradient is written layer by layer into one tensor. With
    ``acc`` (a gradient tree of an earlier microbatch) the gradients are
    added into it in place, layer by layer, and ``acc`` is returned: a
    second full tree never exists.
    """
    seg_keys = [bundle.seg_key(i) for i in range(len(bundle.segments))]
    nonseg_v = _virt({k: v for k, v in params.items() if k not in seg_keys})
    ns_leaves = _diff(nonseg_v)
    full = {**params, **nonseg_v}

    # ---- forward: embed with grad, the stack without (a segment's
    # ``pre`` with grad, its graph kept for the backward), head with grad
    with torch.enable_grad():
        carry0, ctx = bundle.embed(full, batch)
    ctx_leaves = _ctx_diff(ctx)
    g_ctx: List[torch.Tensor] = []
    saved: List[List[dict]] = []
    pres: List[Optional[tuple]] = []
    carry = {k: v.detach() for k, v in carry0.items()}
    for i, seg in enumerate(bundle.segments):
        pres.append(None)
        if seg.pre is not None:
            c_pre = {k: v.detach().requires_grad_(True)
                     for k, v in carry.items()}
            with torch.enable_grad():
                out = seg.pre(full, c_pre, ctx)
            pres[i] = (c_pre, out)
            carry = {k: v.detach() for k, v in out.items()}
        stack = params[seg_keys[i]]
        ins = []
        with torch.no_grad():
            for layer in range(seg.n_layers):
                ins.append(carry)
                carry = seg.apply(layer_params(stack, layer), carry, ctx)
        saved.append(ins)
    keys = _float_keys(carry)
    c_top = {k: v.detach().requires_grad_(True) for k, v in carry.items()}
    with torch.enable_grad():
        loss, metrics = bundle.head_loss(full, c_top, batch)
        g_all = _grads(loss, [c_top[k] for k in keys] + ns_leaves, None)
    g_c = dict(zip(keys, g_all[: len(keys)]))
    g_ns = g_all[len(keys):]

    def add_ctx(got):
        if not g_ctx:
            g_ctx.extend(g.to(torch.float32, copy=True) for g in got)
        else:
            for a, g in zip(g_ctx, got):
                a.add_(g)

    # ---- backward: per layer, recompute + grad + project ----
    g_segs = {}
    for i in reversed(range(len(bundle.segments))):
        seg = bundle.segments[i]
        stack = params[seg_keys[i]]
        P_tree = proj_trees.get(seg_keys[i])
        out = None if acc is None else _leaves(acc[seg_keys[i]])
        side_list = _leaves(sides[seg_keys[i]]) if sides else \
            [None] * len(_leaves(stack))
        fresh = acc is None
        keys = _float_keys(saved[i][0])
        for layer in reversed(range(seg.n_layers)):
            lp_v = _virt(layer_params(stack, layer))
            leaves = _diff(lp_v)
            c_in = {k: v.detach().requires_grad_(True)
                    for k, v in saved[i][layer].items()}
            with torch.enable_grad():
                res = seg.apply(lp_v, c_in, ctx)
                got = _grads([res[k] for k in keys],
                             [c_in[k] for k in keys] + leaves + ctx_leaves,
                             [g_c[k] for k in keys])
            g_c = dict(zip(keys, got[: len(keys)]))
            del res
            n_own = len(keys) + len(leaves)
            add_ctx(got[n_own:])
            Ps = (_leaves(layer_params(P_tree, layer))
                  if P_tree is not None else [None] * len(leaves))
            gl = [project_leaf(g, P, s) for g, P, s in
                  zip(got[len(keys):n_own], Ps, side_list)]
            del got, lp_v, leaves, c_in
            if out is None:
                out = [torch.empty((seg.n_layers,) + tuple(g.shape),
                                   dtype=g.dtype, device=g.device)
                       for g in gl]
            for o, g in zip(out, gl):
                if fresh:
                    o[layer].copy_(g)
                else:
                    o[layer].add_(g)
            del gl
        g_segs[seg_keys[i]] = _like(stack, out)
        saved[i] = None
        if pres[i] is not None:
            # ``pre``'s gradient: w.r.t. its input carry (on into the
            # previous segment), the non-segment leaves it reads (the
            # bridge's ``enc_final_norm``) and ctx's; entries it passes
            # on unchanged, or twice (``h`` and ``dec_h``), sum
            c_pre, pout = pres[i]
            in_keys = _float_keys(c_pre)
            outs = [(pout[k], g_c[k]) for k in keys if pout[k].requires_grad]
            got = torch.autograd.grad(
                [o for o, _ in outs],
                [c_pre[k] for k in in_keys] + ns_leaves + ctx_leaves,
                grad_outputs=[g for _, g in outs], allow_unused=True)
            n_in, n_ns = len(in_keys), len(ns_leaves)
            g_c = {k: torch.zeros_like(c_pre[k]) if g is None else g
                   for k, g in zip(in_keys, got[:n_in])}
            for a, g in zip(g_ns, got[n_in: n_in + n_ns]):
                if g is not None:
                    a.add_(g)
            add_ctx([torch.zeros_like(x) if g is None else g
                     for x, g in zip(ctx_leaves, got[n_in + n_ns:])])
            pres[i] = None
            del got, outs, c_pre, pout

    # the embedding's cotangents (``aux`` starts as a constant zero) and
    # ctx's, summed over the layers
    outs = [(carry0[k], g) for k, g in g_c.items()
            if carry0[k].requires_grad] + list(zip(ctx_leaves, g_ctx))
    with torch.enable_grad():
        g_emb = _grads([o for o, _ in outs], ns_leaves, [g for _, g in outs])
    g_ns = [a + b for a, b in zip(g_ns, g_emb)]
    g_nonseg = _like(nonseg_v, g_ns)
    for k, P_sub in proj_trees.items():
        if k in g_nonseg and P_sub is not None:
            g_nonseg[k] = _project_tree(g_nonseg[k], P_sub) \
                if sides is None else \
                _project_tree(g_nonseg[k], P_sub, sides.get(k))
    if acc is not None:
        for k in g_nonseg:
            for a, g in zip(_leaves(acc[k]), _leaves(g_nonseg[k])):
                a.add_(g)
            g_nonseg[k] = acc[k]
    grads = {**g_nonseg, **g_segs}
    return (loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                            for k, v in metrics.items()}), \
        {k: grads[k] for k in params}

