"""The Q-GaLore optimizer (paper §3.5): the counterpart of
``repro/core/qgalore.py``.

Per GaLore leaf ``(m, n)`` (stacked leaves ``(L, m, n)`` are batches of
independent problems) the state is the INT8 weight, an INT4 projection
``P (d, r)`` and two low-rank 8-bit Adam moments. A step either

* refreshes: full-rank gradients, a per-layer mask from the host
  controller (``core/adaptive.py``) picks the layers whose ``P`` is
  recomputed by SVD, and the update runs unfused (Adam, back-projection,
  stochastic-rounding requantization); or
* is steady: low-rank gradients, and every eligible leaf updates through
  the fused kernel (``kernels.ops.fused_qgalore_update``), one layer at a
  time, so the full-rank update never exists in device memory.

Leaves are updated one by one: the JAX package stacks same-shaped leaves
into one scanned program, which its docstring notes does not change the
numbers.

The recipe is a ``QGaLoreConfig`` or a param-group rule-set
(``core/rules.py``): each leaf's rank, bits, scale and learning-rate
multiplier come from its resolved group (``spec.cfg``), and frozen-group
leaves hold no state and pass through untouched. Under
``adaptive_rank`` a refresh also returns each refreshed layer's
explained-variance profile, from the same decomposition; a rank decision
shrinks a leaf's state through :func:`migrate_rank_state` and its specs
through :func:`apply_rank_overrides`.

Randomness: every stochastic rounding draws its uniforms from a caller's
``uniforms(leaf_idx, layer, shape)`` (``layer`` is None for a leaf updated
whole), and the randomized subspace method its Gaussian test matrices
from ``omegas(leaf_idx, unit, shape)`` (``unit``: the layer within the
leaf, 0 for a leaf updated whole), so a test can hand in the JAX
package's own draws.

Trees are nested dicts; a flat order is the JAX package's (sorted keys),
and a leaf's path is its JAX key string, e.g. ``['seg0_dense']['attn']
['wq']``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import QGaLoreConfig
from repro_torch.core import adam8bit, projector, quant
from repro_torch.core.adam8bit import Adam8bitState, AdamHyper
from repro_torch.core.quant import QTensor
from repro_torch.core.rules import as_rules
from repro_torch.kernels import ops as kops

Uniforms = Callable[[int, Optional[int], Tuple[int, ...]], torch.Tensor]
Omegas = Callable[[int, int, Tuple[int, int]], torch.Tensor]

# Test-only: ``fn(path, g (k, m, n), P_new (k, d, r)) -> P_new`` applied to
# freshly computed projections before quantization (a parity harness uses
# it to align singular-vector signs with another solver). None in use.
SUBSPACE_HOOK: Optional[Callable] = None


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def flatten(tree, _prefix: Tuple[str, ...] = ()) -> List[Tuple[tuple, object]]:
    """``[(keys, leaf)]`` in the JAX package's order (sorted dict keys); a
    QTensor is one leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], _prefix + (k,)))
        return out
    return [(_prefix, tree)]


def unflatten(keys: List[tuple], leaves: list) -> dict:
    """Inverse of :func:`flatten`."""
    out: dict = {}
    for ks, leaf in zip(keys, leaves):
        d = out
        for k in ks[:-1]:
            d = d.setdefault(k, {})
        d[ks[-1]] = leaf
    return out


def keystr(keys: tuple) -> str:
    return "".join(f"[{k!r}]" for k in keys)


# ---------------------------------------------------------------------------
# Leaf specs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LeafSpec:
    path: str
    shape: Tuple[int, ...]        # virtual (dequantized) shape
    galore: bool
    side: str                     # "left" | "right" | ""
    rank: int
    batch: Tuple[int, ...]        # leading dims (layer stacks)
    # param-group resolution (core/rules.py)
    frozen: bool = False          # dropped from the optimizer entirely
    lr_scale: float = 1.0         # per-group learning-rate multiplier
    group: str = "default"        # name of the resolved ParamGroup
    # the leaf's effective recipe (base config + group overrides); None
    # only for specs built by hand
    cfg: Optional[QGaLoreConfig] = None

    @property
    def mat_shape(self) -> Tuple[int, int]:
        return self.shape[-2], self.shape[-1]

    @property
    def nbatch(self) -> int:
        return int(np.prod(self.batch)) if self.batch else 1

    @property
    def low_shape(self) -> Tuple[int, ...]:
        return self.batch + projector.lowrank_shape(self.mat_shape, self.rank)

    @property
    def proj_shape(self) -> Tuple[int, ...]:
        return self.batch + (projector.proj_dim(self.mat_shape), self.rank)


def _is_embedding_path(path: str) -> bool:
    p = path.lower()
    return any(k in p for k in ("embed", "lm_head", "unembed", "wte", "wpe"))


def leaf_specs(params, cfg) -> List[LeafSpec]:
    """One spec per leaf, in flat order. ``cfg``: a ``QGaLoreConfig`` or a
    ``ParamRules``; each leaf's path resolves to its first-matching group,
    whose effective recipe lands on ``spec.cfg``."""
    rules = as_rules(cfg)
    specs = []
    for keys, leaf in flatten(params):
        path = keystr(keys)
        shape = tuple(leaf.shape)
        grp = rules.resolve(path)
        eff = grp.apply_to(rules.base)
        galore = (not grp.frozen and eff.enabled and len(shape) >= 2
                  and shape[-1] >= eff.min_dim and shape[-2] >= eff.min_dim
                  and (eff.galore_embeddings or not _is_embedding_path(path)))
        common = dict(lr_scale=grp.lr_scale, group=grp.name, cfg=eff)
        if galore:
            specs.append(LeafSpec(path, shape, True,
                                  projector.galore_side(shape),
                                  min(eff.rank, min(shape[-2], shape[-1])),
                                  shape[:-2], **common))
        else:
            specs.append(LeafSpec(path, shape, False, "", 0, (),
                                  frozen=grp.frozen, **common))
    return specs


def _eff_cfg(spec: LeafSpec, cfg) -> QGaLoreConfig:
    """The leaf's effective recipe (``spec.cfg``), or the base of ``cfg``
    for a spec built by hand."""
    if spec.cfg is not None:
        return spec.cfg
    return as_rules(cfg).base


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

class QGaLoreState(NamedTuple):
    inner: list       # Adam8bitState per leaf (None: frozen), flat order
    proj: list        # QTensor / float P per GaLore leaf, None otherwise
    count: int        # steps taken


def _quantize_p(P: torch.Tensor, cfg: QGaLoreConfig):
    if cfg.proj_bits >= 16:
        return P.to(torch.float32)
    return projector.quantize_projection(P, cfg.proj_bits, cfg.quant_block)


def leaf_device(leaf) -> torch.device:
    return leaf.q.device if isinstance(leaf, QTensor) else leaf.device


def init_projection(spec: LeafSpec, cfg: QGaLoreConfig, seed: int,
                    idx: int, device):
    """Leaf ``idx``'s random orthonormal ``P``, drawn from a generator
    seeded by ``(seed, idx)``; the controller forces a real refresh at
    step 0."""
    gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + idx)
    P = projector.random_orthonormal(gen, projector.proj_dim(spec.mat_shape),
                                     spec.rank, batch=spec.nbatch,
                                     device=device)
    P = P.reshape(spec.proj_shape) if spec.batch else P[0]
    return _quantize_p(P, cfg)


def init(params, cfg, seed: int = 0,
         specs: Optional[List[LeafSpec]] = None) -> QGaLoreState:
    """Zero moments and a random orthonormal ``P`` per GaLore leaf
    (:func:`init_projection`). Frozen-group leaves hold no state."""
    specs = specs or leaf_specs(params, cfg)
    inner, proj = [], []
    for i, ((_, leaf), spec) in enumerate(zip(flatten(params), specs)):
        dev = leaf_device(leaf)
        eff = _eff_cfg(spec, cfg)
        hyper = AdamHyper.from_config(eff)
        if spec.frozen:
            inner.append(None)
            proj.append(None)
        elif spec.galore:
            inner.append(adam8bit.init_state(spec.low_shape, hyper, dev))
            proj.append(init_projection(spec, eff, seed, i, dev))
        else:
            inner.append(adam8bit.init_state(spec.shape, hyper, dev))
            proj.append(None)
    return QGaLoreState(inner, proj, 0)


def state_template(specs: List[LeafSpec], cfg) -> QGaLoreState:
    """The layout :func:`init` gives (QTensor metadata, shapes, dtypes)
    on the ``meta`` device: no draws and no memory. A checkpoint restore
    fills it."""
    inner, proj = [], []
    for spec in specs:
        eff = _eff_cfg(spec, cfg)
        hyper = AdamHyper.from_config(eff)
        if spec.frozen:
            inner.append(None)
            proj.append(None)
        elif spec.galore:
            inner.append(adam8bit.init_state(spec.low_shape, hyper, "meta"))
            proj.append(_quantize_p(torch.empty(spec.proj_shape,
                                                device="meta"), eff))
        else:
            inner.append(adam8bit.init_state(spec.shape, hyper, "meta"))
            proj.append(None)
    return QGaLoreState(inner, proj, 0)


# ---------------------------------------------------------------------------
# Subspace refresh (mask-gated)
# ---------------------------------------------------------------------------

def _flat_batch(P, b: int, nlead: int):
    fn = lambda t: t.reshape((b,) + tuple(t.shape[nlead:]))
    return P.map(fn) if isinstance(P, QTensor) else fn(P)


def _unflat_batch(P, batch: Tuple[int, ...]):
    fn = lambda t: t.reshape(batch + tuple(t.shape[1:]))
    return P.map(fn) if isinstance(P, QTensor) else fn(P)


def refresh_leaf(grad_full: torch.Tensor, P_old, mask, spec: LeafSpec,
                 cfg: QGaLoreConfig,
                 omegas: Optional[Callable[[int, Tuple[int, int]],
                                           torch.Tensor]] = None):
    """Recompute P for the masked layers of one leaf with one batched
    decomposition (``cfg.subspace_method``; ``omegas(unit, (k, p))`` gives
    the randomized method's test matrix of each layer).

    Returns ``(P_new, sims, ratios)``: ``sims (nbatch,)`` float32 on the
    host, ``-1`` where a layer was not refreshed; under
    ``cfg.adaptive_rank`` ``ratios (nbatch, rank)`` is each refreshed
    layer's explained-variance profile under its fresh (unquantized) P,
    ``-1`` rows elsewhere, and None otherwise."""
    b, nlead = spec.nbatch, len(spec.batch)
    m, n = spec.mat_shape
    g = grad_full.reshape(b, m, n)
    P_flat = _flat_batch(P_old, b, nlead)
    sel = [i for i in range(b) if bool(mask[i])]
    sims = np.full((b,), -1.0, np.float32)
    ratios = (np.full((b, spec.rank), -1.0, np.float32)
              if cfg.adaptive_rank else None)
    if not sel:
        return P_old, sims, ratios
    idx = torch.tensor(sel, device=g.device)
    g_sel = g if len(sel) == b else g[idx]
    omega = None
    if cfg.subspace_method == "randomized":
        if omegas is None:
            raise ValueError(f"{spec.path}: the randomized subspace method "
                             "needs an omega source")
        shape = projector.omega_shape((m, n), spec.rank, spec.side)
        omega = torch.stack([omegas(i, shape) for i in sel])
    P_new = projector.compute_subspace(g_sel, spec.rank, spec.side,
                                       cfg.subspace_method, omega,
                                       cfg.subspace_iters)
    if SUBSPACE_HOOK is not None:
        P_new = SUBSPACE_HOOK(spec.path, g_sel, P_new)
    old_sel = (P_flat.map(lambda t: t[idx]) if isinstance(P_flat, QTensor)
               else P_flat[idx])
    sims[sel] = projector.subspace_similarity(
        projector.maybe_dequantize(old_sel), P_new).cpu().numpy()
    if ratios is not None:
        ratios[sel] = projector.explained_ratio(
            g_sel, P_new, spec.side).cpu().numpy()
    del g_sel
    fresh = _quantize_p(P_new, cfg)
    if isinstance(P_flat, QTensor):
        out = P_flat.map(torch.clone)
        out.q[idx] = fresh.q
        out.scale[idx] = fresh.scale
        out.zero[idx] = fresh.zero
        out = out.map(lambda t: t.reshape(spec.batch + tuple(t.shape[1:])))
    else:
        out = P_flat.clone()
        out[idx] = fresh
        out = out.reshape(spec.proj_shape)
    return out, sims, ratios


# ---------------------------------------------------------------------------
# Leaf updates
# ---------------------------------------------------------------------------

def _grad_is_lowrank(grad, spec: LeafSpec) -> bool:
    return spec.galore and tuple(grad.shape) == spec.low_shape \
        and tuple(grad.shape) != spec.shape


def fused_eligible(param, P, spec: LeafSpec, cfg: QGaLoreConfig) -> bool:
    """The fused kernel covers the paper's recipe: symmetric INT8 weights,
    stochastic rounding, an INT4 projection (unless ``cfg.fused_update``
    is off)."""
    return (cfg.fused_update and spec.galore and cfg.stochastic_rounding
            and isinstance(param, QTensor) and param.bits == 8
            and param.symmetric and isinstance(P, QTensor) and P.bits == 4)


def _layer(t, i: int):
    return t.map(lambda x: x[i]) if isinstance(t, QTensor) else t[i]


def _stack(parts: list):
    if isinstance(parts[0], QTensor):
        p0 = parts[0]
        return QTensor(torch.stack([p.q for p in parts]),
                       torch.stack([p.scale for p in parts]),
                       None if p0.zero is None
                       else torch.stack([p.zero for p in parts]),
                       p0.bits, p0.block, p0.orig_last, p0.dtype)
    return torch.stack(parts)


def _low(grad, P, spec: LeafSpec) -> torch.Tensor:
    if _grad_is_lowrank(grad, spec):
        return grad.to(torch.float32)
    return projector.project(grad.to(torch.float32),
                             projector.maybe_dequantize(P), spec.side)


def _empty_stack(x, b: int):
    """An uninitialised stack of ``b`` tensors (or QTensors) like ``x``."""
    alloc = lambda t: torch.empty((b,) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device)
    return x.map(alloc) if isinstance(x, QTensor) else alloc(x)


def _set_layer(out, i: int, x) -> None:
    if isinstance(out, QTensor):
        out.q[i].copy_(x.q)
        out.scale[i].copy_(x.scale)
        if out.zero is not None:
            out.zero[i].copy_(x.zero)
    else:
        out[i].copy_(x)


def _update_leaf_fused(param, grad, inner: Adam8bitState, P, spec: LeafSpec,
                       cfg: QGaLoreConfig, lr: float, count: int,
                       uniforms: Callable) -> tuple:
    """Steady-state update of one GaLore leaf through the fused kernel.

    A stacked leaf runs one layer at a time: the layer's moments are
    dequantized, updated and requantized into the stacked outputs, so no
    float32 copy of a whole stack's moments exists (the quantization blocks
    run along the last axis, so a layer gets the codes the whole stack
    would)."""
    low = _low(grad, P, spec)
    hyper = AdamHyper.from_config(cfg)
    kw = dict(side=spec.side, gscale=cfg.scale, beta1=cfg.beta1,
              beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    if not spec.batch:
        m32, v32 = adam8bit.moments_fp32(inner)
        new_param, m_new, v_new = kops.fused_qgalore_update(
            param, low, m32, v32, P, count, lr,
            uniforms(None, tuple(param.q.shape)), **kw)
        return new_param, adam8bit.pack_moments(m_new, v_new, hyper)
    b, nlead = spec.nbatch, len(spec.batch)
    flat = lambda t: _flat_batch(t, b, nlead)
    p_f, P_f, m_f, v_f = flat(param), flat(P), flat(inner.m), flat(inner.v)
    low_f = low.reshape((b,) + tuple(low.shape[nlead:]))
    p_out = _empty_stack(_layer(p_f, 0), b)
    m_out = v_out = None
    for i in range(b):
        m32, v32 = adam8bit.moments_fp32(
            Adam8bitState(_layer(m_f, i), _layer(v_f, i)))
        new_p, m_new, v_new = kops.fused_qgalore_update(
            _layer(p_f, i), low_f[i], m32, v32, _layer(P_f, i), count, lr,
            uniforms(i, tuple(p_f.q.shape[1:])), **kw)
        packed = adam8bit.pack_moments(m_new, v_new, hyper)
        del m32, v32, m_new, v_new
        if m_out is None:
            m_out, v_out = (_empty_stack(x, b) for x in packed)
        for out, x in ((p_out, new_p), (m_out, packed.m), (v_out, packed.v)):
            _set_layer(out, i, x)
        del new_p, packed
    unflat = lambda t: _unflat_batch(t, spec.batch)
    return unflat(p_out), Adam8bitState(unflat(m_out), unflat(v_out))


def _apply_weight_update(param, direction, P_deq, spec: LeafSpec,
                         cfg: QGaLoreConfig, lr: float, u01):
    """Back-project (GaLore) and apply the update to one (sub-)leaf with
    no stacked dims; ``u01`` is a thunk giving the uniforms."""
    if P_deq is not None:
        upd = cfg.scale * projector.project_back(
            direction.to(torch.float32), P_deq, spec.side)
    else:
        upd = direction.to(torch.float32)
    if isinstance(param, QTensor):
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * quant.dequantize(param,
                                                            torch.float32)
        delta = -lr * upd
        if cfg.stochastic_rounding:
            return quant.requantize_sr(param, delta, u01())
        w = quant.dequantize(param, torch.float32) + delta
        return quant.quantize_blockwise(w, bits=param.bits,
                                        block=param.block,
                                        symmetric=param.symmetric)
    w = param.to(torch.float32)
    if cfg.weight_decay:
        upd = upd + cfg.weight_decay * w
    return (w - lr * upd).to(param.dtype)


def update_leaf(param, grad, inner: Adam8bitState, P, spec: LeafSpec,
                cfg: QGaLoreConfig, lr: float, count: int, mask,
                uniforms: Callable, refresh: bool,
                omegas: Optional[Callable] = None):
    """One leaf's update. ``uniforms(layer, shape)`` draws this leaf's SR
    uniforms, ``omegas(unit, shape)`` its randomized test matrices.
    Returns ``(new_param, new_inner, new_P, sims or None, ratios or
    None)``."""
    if not refresh and fused_eligible(param, P, spec, cfg):
        new_param, new_inner = _update_leaf_fused(
            param, grad, inner, P, spec, cfg, lr, count, uniforms)
        return new_param, new_inner, P, None, None
    hyper = AdamHyper.from_config(cfg)
    sims = ratios = None
    new_P = P
    if not spec.galore:
        direction, new_inner = adam8bit.update(grad.to(torch.float32), inner,
                                               count, hyper)
        new_param = _apply_weight_update(
            param, direction, None, spec, cfg, lr,
            lambda: uniforms(None, tuple(param.q.shape)))
        return new_param, new_inner, new_P, sims, ratios
    if refresh:
        if _grad_is_lowrank(grad, spec):
            raise ValueError(f"refresh step needs full-rank grad for "
                             f"{spec.path}")
        new_P, sims, ratios = refresh_leaf(grad, P, mask, spec, cfg, omegas)
    direction, new_inner = adam8bit.update(_low(grad, new_P, spec), inner,
                                           count, hyper)
    if spec.batch:
        b, nlead = spec.nbatch, len(spec.batch)
        p_f = _flat_batch(param, b, nlead)
        P_f = _flat_batch(new_P, b, nlead)
        d_f = direction.reshape((b,) + tuple(direction.shape[nlead:]))
        parts = []
        for i in range(b):
            p_l = _layer(p_f, i)
            parts.append(_apply_weight_update(
                p_l, d_f[i], projector.maybe_dequantize(_layer(P_f, i)),
                spec, cfg, lr,
                lambda i=i, p_l=p_l: uniforms(i, tuple(p_l.q.shape))))
        new_param = _unflat_batch(_stack(parts), spec.batch)
    else:
        new_param = _apply_weight_update(
            param, direction, projector.maybe_dequantize(new_P), spec, cfg,
            lr, lambda: uniforms(None, tuple(param.q.shape)))
    return new_param, new_inner, new_P, sims, ratios


def _lr_for(spec: LeafSpec, lr: float) -> float:
    """The group's learning rate; the unit scale skips the multiply."""
    return lr if spec.lr_scale == 1.0 else lr * spec.lr_scale


def apply_updates(params, grads, state: QGaLoreState, cfg, lr: float,
                  uniforms: Uniforms,
                  refresh_masks: Optional[Dict[int, np.ndarray]] = None,
                  refresh: bool = False,
                  specs: Optional[List[LeafSpec]] = None,
                  omegas: Optional[Omegas] = None):
    """One optimizer step. ``cfg``: a ``QGaLoreConfig`` or a ``ParamRules``.

    ``grads``: a tree like ``params`` with one gradient per leaf, full-rank
    or (GaLore leaves, steady steps) low-rank. ``refresh_masks``:
    ``{leaf_index: (nbatch,) bool}`` for GaLore leaves whose P is due
    (consulted only when ``refresh``). ``uniforms(leaf_idx, layer, shape)``
    supplies every stochastic-rounding draw, ``omegas(leaf_idx, unit,
    (k, p))`` every randomized test matrix.

    Returns ``(new_params, new_state, {"sims": {path: (nbatch,)},
    "ratios": {path: (nbatch, rank)}})``; ratios only under
    ``adaptive_rank``.
    """
    specs = specs or leaf_specs(params, cfg)
    flat = flatten(params)
    keys = [k for k, _ in flat]
    g_flat = [g for _, g in flatten(grads)]
    count = state.count + 1
    refresh_masks = refresh_masks or {}
    new_p, new_i, new_pr, sims_out, ratios_out = [], [], [], {}, {}
    for idx, ((_, param), grad, inner, P, spec) in enumerate(
            zip(flat, g_flat, state.inner, state.proj, specs)):
        if spec.frozen:
            new_p.append(param)
            new_i.append(inner)
            new_pr.append(P)
            continue
        do_refresh = refresh and spec.galore and idx in refresh_masks
        mask = refresh_masks.get(idx)
        if do_refresh and mask is None:
            mask = np.ones((spec.nbatch,), bool)
        leaf_uniforms = lambda layer, shape, idx=idx: uniforms(idx, layer,
                                                               shape)
        leaf_omegas = None if omegas is None else \
            (lambda unit, shape, idx=idx: omegas(idx, unit, shape))
        np_, ni_, npr_, sims, ratios = update_leaf(
            param, grad, inner, P, spec, _eff_cfg(spec, cfg),
            _lr_for(spec, lr), count, mask, leaf_uniforms, do_refresh,
            leaf_omegas)
        new_p.append(np_)
        new_i.append(ni_)
        new_pr.append(npr_)
        if sims is not None:
            sims_out[spec.path] = sims
        if ratios is not None:
            ratios_out[spec.path] = ratios
    return (unflatten(keys, new_p), QGaLoreState(new_i, new_pr, count),
            {"sims": sims_out, "ratios": ratios_out})


# ---------------------------------------------------------------------------
# Global-norm clipping (``repro/core/transform.py::clip_by_global_norm``)
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads, max_norm: float,
                        specs: Optional[List[LeafSpec]] = None):
    """Clip a gradient tree to ``max_norm`` (no-op when falsy), scaling
    the tree's tensors in place (the products the reference rounds to
    each gradient's dtype), so a step holds one tree of full-rank
    gradients, not two. Returns ``(grads, norm)``; the norm stays a
    float32 tensor on the device. With ``specs``, frozen-group leaves
    neither enter the norm nor get scaled."""
    frozen = {i for i, s in enumerate(specs or []) if s.frozen}
    flat = flatten(grads)
    norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for i, (_, g) in enumerate(flat)
                          if i not in frozen))
    if not max_norm:
        return grads, norm
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for i, (_, g) in enumerate(flat):
        if i not in frozen:
            g.mul_(scale)
    return grads, norm


# ---------------------------------------------------------------------------
# Memory model (paper Tables 1/2)
# ---------------------------------------------------------------------------

def _qtensor_nbytes(qt: QTensor) -> int:
    return sum(t.numel() * t.element_size()
               for t in (qt.q, qt.scale, qt.zero) if t is not None)


def memory_report(params, cfg, fp_state_bytes: int = 2,
                  specs: Optional[List[LeafSpec]] = None
                  ) -> Dict[str, float]:
    """Analytic GiB of weights and optimizer state (the paper's estimated
    memory): the reference's ``memory_report``, field for field. Float
    Adam states count at ``fp_state_bytes`` (bf16 by the paper's
    convention), float weights at most 2 bytes; frozen leaves count their
    weights only. ``specs`` carries runtime rank overrides. Leaves may lie
    on the ``meta`` device: only shapes are read."""
    rules = as_rules(cfg)
    specs = specs if specs is not None else leaf_specs(params, rules)
    w_bytes = opt_bytes = proj_bytes = 0
    for (_, leaf), spec in zip(flatten(params), specs):
        eff = _eff_cfg(spec, rules)
        n = int(np.prod(spec.shape))
        if isinstance(leaf, QTensor):
            w_bytes += _qtensor_nbytes(leaf)
        else:
            w_bytes += n * min(leaf.element_size(), 2)
        if spec.frozen:
            continue
        state_elems = int(np.prod(spec.low_shape)) if spec.galore else n
        bytes_per = 1 if eff.adam_bits == 8 else fp_state_bytes
        opt_bytes += 2 * state_elems * bytes_per
        if eff.adam_bits == 8:
            opt_bytes += 2 * (state_elems // eff.quant_block + 1) * 8
        if spec.galore:
            d = projector.proj_dim(spec.mat_shape) * spec.rank * spec.nbatch
            if eff.proj_bits >= 16:
                proj_bytes += d * 4
            else:
                proj_bytes += d * eff.proj_bits // 8
    return {
        "weights_gb": w_bytes / 2**30,
        "optimizer_gb": (opt_bytes + proj_bytes) / 2**30,
        "projection_gb": proj_bytes / 2**30,
        "total_gb": (w_bytes + opt_bytes + proj_bytes) / 2**30,
    }


def optimizer_state_bytes(params, cfg,
                          specs: Optional[List[LeafSpec]] = None) -> int:
    """Analytic optimizer-state bytes (moments and projections)."""
    rep = memory_report(params, cfg, specs=specs)
    return int(round(rep["optimizer_gb"] * 2**30))


def dp_payload_bytes(specs: List[LeafSpec]) -> int:
    """Bytes a data-parallel step would reduce per replica: low-rank f32
    gradients for GaLore leaves, full-rank f32 for the rest (the
    reference's accounting; the port runs on one device)."""
    return 4 * sum(int(np.prod(s.low_shape if s.galore else s.shape))
                   for s in specs if not s.frozen)


# ---------------------------------------------------------------------------
# Dynamic rank adaptation: spec overrides and low-rank state migration
# ---------------------------------------------------------------------------

def apply_rank_overrides(specs: List[LeafSpec],
                         overrides: Dict[str, int]) -> List[LeafSpec]:
    """Specs with per-path rank overrides (path → new rank) applied to
    ``spec.rank`` and ``spec.cfg.rank``. Ranks only shrink."""
    if not overrides:
        return specs
    unknown = set(overrides) - {s.path for s in specs}
    if unknown:
        raise ValueError(f"rank overrides for unknown leaves: "
                         f"{sorted(unknown)}")
    out = []
    for spec in specs:
        r = overrides.get(spec.path)
        if r is None or r == spec.rank:
            out.append(spec)
            continue
        if not spec.galore:
            raise ValueError(f"rank override on non-galore leaf {spec.path}")
        if r > spec.rank:
            raise ValueError(f"rank override must shrink: {spec.path} "
                             f"{spec.rank} -> {r}")
        cfg2 = None if spec.cfg is None else \
            dataclasses.replace(spec.cfg, rank=r)
        out.append(dataclasses.replace(spec, rank=r, cfg=cfg2))
    return out


def truncate_lowrank(x: torch.Tensor, side: str, new_rank: int
                     ) -> torch.Tensor:
    """The leading ``new_rank`` directions of a low-rank array
    ``(batch..., m, r)`` (right) or ``(batch..., r, n)`` (left)."""
    if side == "right":
        return x[..., :new_rank]
    return x[..., :new_rank, :]


def migrate_rank_state(inner: Adam8bitState, P, spec: LeafSpec,
                       new_rank: int, cfg=None):
    """Shrink one GaLore leaf's state from ``spec.rank`` to ``new_rank``:
    truncate the 8-bit moments and requantize the leading ``new_rank``
    columns of P (singular-value ordered, so the top directions stay), by
    round to nearest. Returns ``(new_inner, new_P)``."""
    if not spec.galore:
        raise ValueError(f"cannot migrate non-galore leaf {spec.path}")
    if not 0 < new_rank < spec.rank:
        raise ValueError(f"{spec.path}: bad rank transition {spec.rank} -> "
                         f"{new_rank}")
    eff = _eff_cfg(spec, cfg if cfg is not None else spec.cfg)
    m32, v32 = adam8bit.moments_fp32(inner)
    new_inner = adam8bit.pack_moments(
        truncate_lowrank(m32, spec.side, new_rank).contiguous(),
        truncate_lowrank(v32, spec.side, new_rank).contiguous(),
        AdamHyper.from_config(eff))
    P_trunc = projector.maybe_dequantize(P)[..., :new_rank].contiguous()
    return new_inner, _quantize_p(P_trunc, eff)
