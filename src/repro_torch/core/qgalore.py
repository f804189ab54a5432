"""The Q-GaLore optimizer (paper §3.5), single parameter group: the
counterpart of ``repro/core/qgalore.py``.

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

Randomness: every stochastic rounding draws its uniforms from a caller's
``uniforms(leaf_idx, layer, shape)`` (``layer`` is None for a leaf updated
whole), so a test can hand in the JAX package's own draws.

Trees are nested dicts; a flat order is the JAX package's (sorted keys),
and a leaf's path is its JAX key string, e.g. ``['seg0_dense']['attn']
['wq']``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import QGaLoreConfig
from repro_torch.core import adam8bit, projector, quant
from repro_torch.core.adam8bit import Adam8bitState, AdamHyper
from repro_torch.core.quant import QTensor
from repro_torch.kernels import ops as kops

Uniforms = Callable[[int, Optional[int], Tuple[int, ...]], torch.Tensor]

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


def _check_cfg(cfg) -> QGaLoreConfig:
    if not isinstance(cfg, QGaLoreConfig):
        raise TypeError(f"the port takes one QGaLoreConfig; parameter-group "
                        f"rules are not ported (got {type(cfg).__name__})")
    return cfg


def _is_embedding_path(path: str) -> bool:
    p = path.lower()
    return any(k in p for k in ("embed", "lm_head", "unembed", "wte", "wpe"))


def leaf_specs(params, cfg: QGaLoreConfig) -> List[LeafSpec]:
    """One spec per leaf, in flat order."""
    cfg = _check_cfg(cfg)
    specs = []
    for keys, leaf in flatten(params):
        path = keystr(keys)
        shape = tuple(leaf.shape)
        galore = (cfg.enabled and len(shape) >= 2
                  and shape[-1] >= cfg.min_dim and shape[-2] >= cfg.min_dim
                  and (cfg.galore_embeddings or not _is_embedding_path(path)))
        if galore:
            specs.append(LeafSpec(path, shape, True,
                                  projector.galore_side(shape),
                                  min(cfg.rank, min(shape[-2], shape[-1])),
                                  shape[:-2]))
        else:
            specs.append(LeafSpec(path, shape, False, "", 0, ()))
    return specs


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

class QGaLoreState(NamedTuple):
    inner: list       # Adam8bitState per leaf, flat order
    proj: list        # QTensor / float P per GaLore leaf, None otherwise
    count: int        # steps taken


def _quantize_p(P: torch.Tensor, cfg: QGaLoreConfig):
    if cfg.proj_bits >= 16:
        return P.to(torch.float32)
    return projector.quantize_projection(P, cfg.proj_bits, cfg.quant_block)


def init(params, cfg: QGaLoreConfig, seed: int = 0,
         specs: Optional[List[LeafSpec]] = None) -> QGaLoreState:
    """Zero moments and a random orthonormal ``P`` per GaLore leaf (drawn
    from a generator seeded by ``(seed, leaf index)``); the controller
    forces a real refresh at step 0."""
    cfg = _check_cfg(cfg)
    specs = specs or leaf_specs(params, cfg)
    hyper = AdamHyper.from_config(cfg)
    inner, proj = [], []
    for i, ((_, leaf), spec) in enumerate(zip(flatten(params), specs)):
        dev = leaf.q.device if isinstance(leaf, QTensor) else leaf.device
        if spec.galore:
            inner.append(adam8bit.init_state(spec.low_shape, hyper, dev))
            gen = torch.Generator(device=dev).manual_seed(
                seed * 1_000_003 + i)
            d = projector.proj_dim(spec.mat_shape)
            P = projector.random_orthonormal(gen, d, spec.rank,
                                             batch=spec.nbatch, device=dev)
            P = P.reshape(spec.proj_shape) if spec.batch else P[0]
            proj.append(_quantize_p(P, cfg))
        else:
            inner.append(adam8bit.init_state(spec.shape, hyper, dev))
            proj.append(None)
    return QGaLoreState(inner, proj, 0)


# ---------------------------------------------------------------------------
# Subspace refresh (mask-gated)
# ---------------------------------------------------------------------------

def _flat_batch(P, b: int, nlead: int):
    fn = lambda t: t.reshape((b,) + tuple(t.shape[nlead:]))
    return P.map(fn) if isinstance(P, QTensor) else fn(P)


def refresh_leaf(grad_full: torch.Tensor, P_old, mask, spec: LeafSpec,
                 cfg: QGaLoreConfig):
    """Recompute P for the masked layers of one leaf with one batched SVD.

    Returns ``(P_new, sims)``: ``sims (nbatch,)`` float32 on the host,
    ``-1`` where a layer was not refreshed."""
    b, nlead = spec.nbatch, len(spec.batch)
    m, n = spec.mat_shape
    g = grad_full.reshape(b, m, n)
    P_flat = _flat_batch(P_old, b, nlead)
    sel = [i for i in range(b) if bool(mask[i])]
    sims = np.full((b,), -1.0, np.float32)
    if not sel:
        return P_old, sims
    idx = torch.tensor(sel, device=g.device)
    P_new = projector.compute_subspace(g[idx].to(torch.float32), spec.rank,
                                       spec.side, cfg.subspace_method)
    if SUBSPACE_HOOK is not None:
        P_new = SUBSPACE_HOOK(spec.path, g[idx], P_new)
    old_sel = (P_flat.map(lambda t: t[idx]) if isinstance(P_flat, QTensor)
               else P_flat[idx])
    sims[sel] = projector.subspace_similarity(
        projector.maybe_dequantize(old_sel), P_new).cpu().numpy()
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
    return out, sims


# ---------------------------------------------------------------------------
# Leaf updates
# ---------------------------------------------------------------------------

def _grad_is_lowrank(grad, spec: LeafSpec) -> bool:
    return spec.galore and tuple(grad.shape) == spec.low_shape \
        and tuple(grad.shape) != spec.shape


def fused_eligible(param, P, spec: LeafSpec, cfg: QGaLoreConfig) -> bool:
    """The fused kernel covers the paper's recipe: symmetric INT8 weights,
    stochastic rounding, an INT4 projection."""
    return (spec.galore and cfg.stochastic_rounding
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


def _update_leaf_fused(param, grad, inner: Adam8bitState, P, spec: LeafSpec,
                       cfg: QGaLoreConfig, lr: float, count: int,
                       uniforms: Callable) -> tuple:
    """Steady-state update of one GaLore leaf through the fused kernel,
    one layer at a time for stacked leaves."""
    low = _low(grad, P, spec)
    m32, v32 = adam8bit.moments_fp32(inner)
    kw = dict(side=spec.side, gscale=cfg.scale, beta1=cfg.beta1,
              beta2=cfg.beta2, eps=cfg.eps, weight_decay=cfg.weight_decay)
    if spec.batch:
        b, nlead = spec.nbatch, len(spec.batch)
        flat = lambda t: _flat_batch(t, b, nlead)
        p_f, P_f = flat(param), flat(P)
        low_f, m_f, v_f = (t.reshape((b,) + tuple(t.shape[nlead:]))
                           for t in (low, m32, v32))
        outs = [kops.fused_qgalore_update(
            _layer(p_f, i), low_f[i], m_f[i], v_f[i], _layer(P_f, i), count,
            lr, uniforms(i, tuple(p_f.q.shape[1:])), **kw) for i in range(b)]
        new_param = _stack([o[0] for o in outs]).map(
            lambda t: t.reshape(spec.batch + tuple(t.shape[1:])))
        m_new = torch.stack([o[1] for o in outs]).reshape(m32.shape)
        v_new = torch.stack([o[2] for o in outs]).reshape(v32.shape)
    else:
        new_param, m_new, v_new = kops.fused_qgalore_update(
            param, low, m32, v32, P, count, lr,
            uniforms(None, tuple(param.q.shape)), **kw)
    return new_param, adam8bit.pack_moments(m_new, v_new,
                                            AdamHyper.from_config(cfg))


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
                uniforms: Callable, refresh: bool):
    """One leaf's update. ``uniforms(layer, shape)`` draws this leaf's SR
    uniforms. Returns ``(new_param, new_inner, new_P, sims or None)``."""
    if not refresh and fused_eligible(param, P, spec, cfg):
        new_param, new_inner = _update_leaf_fused(
            param, grad, inner, P, spec, cfg, lr, count, uniforms)
        return new_param, new_inner, P, None
    hyper = AdamHyper.from_config(cfg)
    sims = None
    new_P = P
    if not spec.galore:
        direction, new_inner = adam8bit.update(grad.to(torch.float32), inner,
                                               count, hyper)
        new_param = _apply_weight_update(
            param, direction, None, spec, cfg, lr,
            lambda: uniforms(None, tuple(param.q.shape)))
        return new_param, new_inner, new_P, sims
    if refresh:
        if _grad_is_lowrank(grad, spec):
            raise ValueError(f"refresh step needs full-rank grad for "
                             f"{spec.path}")
        new_P, sims = refresh_leaf(grad, P, mask, spec, cfg)
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
        new_param = _stack(parts)
        new_param = (new_param.map(
            lambda t: t.reshape(spec.batch + tuple(t.shape[1:])))
            if isinstance(new_param, QTensor)
            else new_param.reshape(spec.batch + new_param.shape[1:]))
    else:
        new_param = _apply_weight_update(
            param, direction, projector.maybe_dequantize(new_P), spec, cfg,
            lr, lambda: uniforms(None, tuple(param.q.shape)))
    return new_param, new_inner, new_P, sims


def apply_updates(params, grads, state: QGaLoreState, cfg: QGaLoreConfig,
                  lr: float, uniforms: Uniforms,
                  refresh_masks: Optional[Dict[int, np.ndarray]] = None,
                  refresh: bool = False,
                  specs: Optional[List[LeafSpec]] = None):
    """One optimizer step.

    ``grads``: a tree like ``params`` with one gradient per leaf, full-rank
    or (GaLore leaves, steady steps) low-rank. ``refresh_masks``:
    ``{leaf_index: (nbatch,) bool}`` for GaLore leaves whose P is due
    (consulted only when ``refresh``). ``uniforms(leaf_idx, layer, shape)``
    supplies every stochastic-rounding draw.

    Returns ``(new_params, new_state, {"sims": {path: (nbatch,) array}})``.
    """
    cfg = _check_cfg(cfg)
    specs = specs or leaf_specs(params, cfg)
    flat = flatten(params)
    keys = [k for k, _ in flat]
    g_flat = [g for _, g in flatten(grads)]
    count = state.count + 1
    refresh_masks = refresh_masks or {}
    new_p, new_i, new_pr, sims_out = [], [], [], {}
    for idx, ((_, param), grad, inner, P, spec) in enumerate(
            zip(flat, g_flat, state.inner, state.proj, specs)):
        do_refresh = refresh and spec.galore and idx in refresh_masks
        mask = refresh_masks.get(idx)
        if do_refresh and mask is None:
            mask = np.ones((spec.nbatch,), bool)
        leaf_uniforms = lambda layer, shape, idx=idx: uniforms(idx, layer,
                                                               shape)
        np_, ni_, npr_, sims = update_leaf(param, grad, inner, P, spec, cfg,
                                           lr, count, mask, leaf_uniforms,
                                           do_refresh)
        new_p.append(np_)
        new_i.append(ni_)
        new_pr.append(npr_)
        if sims is not None:
            sims_out[spec.path] = sims
    return (unflatten(keys, new_p), QGaLoreState(new_i, new_pr, count),
            {"sims": sims_out})


# ---------------------------------------------------------------------------
# Global-norm clipping (``repro/core/transform.py::clip_by_global_norm``)
# ---------------------------------------------------------------------------

def clip_by_global_norm(grads, max_norm: float):
    """Clip a gradient tree to ``max_norm`` (no-op when falsy). Returns
    ``(clipped, norm)``; the norm stays a float32 tensor on the device."""
    flat = flatten(grads)
    norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for _, g in flat))
    if not max_norm:
        return grads, norm
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return unflatten([k for k, _ in flat],
                     [(g * scale).to(g.dtype) for _, g in flat]), norm
