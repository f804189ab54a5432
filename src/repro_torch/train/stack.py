"""Fused projected backward over the layer stack (paper §3.5): the
counterpart of ``repro/train/stack.py::fused_value_and_grad``, written as
an explicit loop.

* The forward saves each layer's input carry and keeps no graph
  (``no_grad``): activation memory is one carry per layer.
* The backward walks the layers in reverse. Per layer it recomputes the
  block with grad enabled and calls ``torch.autograd.grad`` on (carry in,
  the layer's weight shadows and float leaves); each GaLore cotangent is
  projected to rank r at once, so only one layer's full-rank ``dL/dW``
  exists at any moment.
* The head and embedding run with grad around the stack; their GaLore
  cotangents (the head) are projected after their own backward.

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


def _grads(out, inputs: List[torch.Tensor], grad_out):
    got = torch.autograd.grad(out, inputs, grad_outputs=grad_out,
                              allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, got)]


def fused_value_and_grad(bundle: ModelBundle, params, batch,
                         proj_trees: Dict[str, Any], acc=None):
    """Loss and gradients with the per-layer recompute backward.

    ``proj_trees``: ``{params key: tree like params[key] with P or None per
    leaf}``; cotangents of leaves with a P leave low-rank. ``{}`` gives
    full-rank gradients everywhere (refresh steps).

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

    # ---- forward: embed with grad, the stack without, head with grad ----
    with torch.enable_grad():
        carry0, ctx = bundle.embed(full, batch)
    saved: List[List[dict]] = []
    carry = {k: v.detach() for k, v in carry0.items()}
    with torch.no_grad():
        for i, seg in enumerate(bundle.segments):
            stack = params[seg_keys[i]]
            ins = []
            for layer in range(seg.n_layers):
                ins.append(carry)
                carry = seg.apply(layer_params(stack, layer), carry, ctx)
            saved.append(ins)
    c_top = {k: v.detach().requires_grad_(True) for k, v in carry.items()}
    with torch.enable_grad():
        loss, metrics = bundle.head_loss(full, c_top, batch)
        g_all = _grads(loss, [c_top["h"]] + ns_leaves, None)
    g_h, g_ns = g_all[0], g_all[1:]

    # ---- backward: per layer, recompute + grad + project ----
    g_segs = {}
    for i in reversed(range(len(bundle.segments))):
        seg = bundle.segments[i]
        stack = params[seg_keys[i]]
        P_tree = proj_trees.get(seg_keys[i])
        out = None if acc is None else _leaves(acc[seg_keys[i]])
        fresh = acc is None
        for layer in reversed(range(seg.n_layers)):
            lp_v = _virt(layer_params(stack, layer))
            leaves = _diff(lp_v)
            c_in = {k: v.detach().requires_grad_(True)
                    for k, v in saved[i][layer].items()}
            with torch.enable_grad():
                res = seg.apply(lp_v, c_in, ctx)
                got = _grads(res["h"], [c_in["h"]] + leaves, g_h)
            g_h = got[0]
            del res
            Ps = (_leaves(layer_params(P_tree, layer))
                  if P_tree is not None else [None] * len(leaves))
            gl = [project_leaf(g, P) for g, P in zip(got[1:], Ps)]
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

    with torch.enable_grad():
        g_emb = _grads(carry0["h"], ns_leaves, g_h)
    g_ns = [a + b for a, b in zip(g_ns, g_emb)]
    g_nonseg = _like(nonseg_v, g_ns)
    for k, P_sub in proj_trees.items():
        if k in g_nonseg and P_sub is not None:
            g_nonseg[k] = project_leaf(g_nonseg[k], P_sub)
    if acc is not None:
        for k in g_nonseg:
            for a, g in zip(_leaves(acc[k]), _leaves(g_nonseg[k])):
                a.add_(g)
            g_nonseg[k] = acc[k]
    grads = {**g_nonseg, **g_segs}
    return (loss.detach(), {k: v.detach() if torch.is_tensor(v) else v
                            for k, v in metrics.items()}), \
        {k: grads[k] for k in params}

