"""Optax-style gradient-transformation chain over the Q-GaLore recipe (the
counterpart of ``repro/core/transform.py``).

The optimizer's public surface is a :class:`GradientTransformation`, an
``init``/``update`` pair, built by composing named stages::

    tx = chain(
        clip_global_norm(1.0),
        project(rules),          # GaLore: full-rank grad -> rank-r subspace
        quantized_adam(rules),   # 8-bit Adam on the low-rank statistics
        backproject(rules),      # subspace direction -> full-rank update
        sr_requant(rules),       # SR INT8 weight write (+ weight decay)
    )
    state = tx.init(params, seed=0)
    new_params, state, metrics = tx.update(grads, state, params, lr=1e-3,
                                           uniforms=draw)

``update`` returns the new params, not additive updates: the weights are
block-wise INT8 ``QTensor``s whose update is a stochastic-rounding
requantization. Stages talk through a per-call context (the projection
``project`` chose is what ``backproject`` inverts).

Randomness is the port's: ``init`` takes a ``seed`` (the projections of
:func:`qgalore.init_projection`), and ``update`` takes the uniform source
``uniforms(leaf_idx, layer, shape)`` (``layer`` None for a leaf updated
whole) and the randomized subspace method's normal source ``omegas(leaf_idx,
unit, (k, p))``, exactly as :func:`qgalore.apply_updates` does; they stand
where the reference folds its ``rng`` with the leaf index and the layer.

Param groups (``core/rules.py``) thread through every stage: each leaf
uses its resolved recipe, and frozen-group leaves pass through untouched
with no state.

:func:`qgalore_transform` is the production executor (the train step's):
``qgalore.init`` / ``qgalore.apply_updates``, which runs each eligible
steady leaf through the fused kernel. :func:`qgalore_reference_chain`
composes the four stages literally, in plain PyTorch (the reference's
stages reach no kernel either); it equals the executor bit for bit with
``fused_update=False`` and is within one INT8 quantum of it otherwise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import adam8bit, projector, qgalore, quant
from repro_torch.core.adam8bit import AdamHyper
from repro_torch.core.qgalore import LeafSpec, QGaLoreState, _eff_cfg
from repro_torch.core.rules import ParamRules, as_rules


class GradientTransformation(NamedTuple):
    """``init(params, seed=0, specs=None) -> state`` and ``update(grads,
    state, params, *, lr, uniforms, omegas=None, refresh_masks=None,
    refresh=False, specs=None) -> (new_params, new_state, metrics)``."""
    init: Callable
    update: Callable


class Stage(NamedTuple):
    """One chain stage. ``init(params_flat, specs, rules, seed) -> state``;
    ``apply(ctx, vals, state) -> (vals, new_state)``, where ``vals`` is the
    flat per-leaf value list flowing down the chain (grads -> low-rank
    grads -> Adam directions -> full-rank updates -> new params)."""
    name: str
    rules: Optional[ParamRules]
    init: Callable
    apply: Callable


class ChainState(NamedTuple):
    stages: Tuple[Any, ...]
    count: int


class _Ctx:
    """Per-update scratch shared by the stages of one chain call."""

    def __init__(self, params_flat, specs, rules, lr, uniforms, omegas,
                 count, refresh, refresh_masks):
        self.params_flat = params_flat
        self.specs = specs
        self.rules = rules
        self.lr = lr
        self.uniforms = uniforms
        self.omegas = omegas
        self.count = count
        self.refresh = refresh
        self.refresh_masks = refresh_masks or {}
        self.metrics: Dict[str, Any] = {"sims": {}, "ratios": {}}
        self.proj: Optional[List] = None     # written by project()

    def draw(self, idx: int, layer: Optional[int], shape) -> torch.Tensor:
        # the monolith's draw for the same leaf and layer
        return self.uniforms(idx, layer, tuple(shape))

    def omegas_for(self, idx: int):
        return None if self.omegas is None else \
            (lambda unit, shape: self.omegas(idx, unit, shape))

    def lr_for(self, spec: LeafSpec) -> float:
        return qgalore._lr_for(spec, self.lr)


def _noop_init(params_flat, specs, rules, seed):
    return None


def _layers(x, spec: LeafSpec):
    """A stacked leaf's (or QTensor's) layers as a flat batch."""
    return qgalore._flat_batch(x, spec.nbatch, len(spec.batch))


# ---------------------------------------------------------------------------
# Global-norm clipping (the train step calls it directly)
# ---------------------------------------------------------------------------

def global_norm(grads) -> torch.Tensor:
    """The float32 norm of a gradient tree's floating-point leaves."""
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for _, g in qgalore.flatten(grads)
                          if torch.is_tensor(g) and g.is_floating_point()))


clip_by_global_norm = qgalore.clip_by_global_norm


def clip_global_norm(max_norm) -> Stage:
    """Stage form of :func:`clip_by_global_norm` (put it first); like the
    train step's clip, it scales the gradients in place."""

    def apply(ctx: _Ctx, vals, _state):
        tree = dict(enumerate(vals))
        _, norm = clip_by_global_norm(tree, max_norm, specs=ctx.specs)
        ctx.metrics["grad_norm"] = norm
        return [tree[i] for i in range(len(vals))], None

    return Stage("clip_global_norm", None, _noop_init, apply)


# ---------------------------------------------------------------------------
# The four core stages
# ---------------------------------------------------------------------------

def project(cfg_or_rules) -> Stage:
    """GaLore projection: owns the per-leaf projections P (INT4 QTensors
    under the paper's recipe) and, at refresh steps, the mask-gated
    subspace refresh. Emits low-rank gradients for GaLore leaves
    (passthrough for everything else, and for gradients that arrive
    low-rank from the fused backward)."""
    rules = as_rules(cfg_or_rules)

    def init(params_flat, specs, rules_, seed):
        return [qgalore.init_projection(spec, _eff_cfg(spec, rules_), seed,
                                        i, qgalore.leaf_device(leaf))
                if spec.galore else None
                for i, (leaf, spec) in enumerate(zip(params_flat, specs))]

    def apply(ctx: _Ctx, vals, P_flat):
        new_P = list(P_flat)
        out = list(vals)
        for idx, spec in enumerate(ctx.specs):
            if spec.frozen or not spec.galore:
                continue
            g, P = vals[idx], P_flat[idx]
            if ctx.refresh and idx in ctx.refresh_masks:
                if qgalore._grad_is_lowrank(g, spec):
                    raise ValueError(f"refresh step needs full-rank grad "
                                     f"for {spec.path}")
                mask = ctx.refresh_masks[idx]
                if mask is None:
                    mask = np.ones((spec.nbatch,), bool)
                P, sims, ratios = qgalore.refresh_leaf(
                    g, P, mask, spec, _eff_cfg(spec, ctx.rules),
                    ctx.omegas_for(idx))
                ctx.metrics["sims"][spec.path] = sims
                if ratios is not None:
                    ctx.metrics["ratios"][spec.path] = ratios
            new_P[idx] = P
            out[idx] = qgalore._low(g, P, spec)
        ctx.proj = new_P
        return out, new_P

    return Stage("project", rules, init, apply)


def quantized_adam(cfg_or_rules) -> Stage:
    """8-bit Adam on the (low-rank, for GaLore leaves) gradient statistics.
    Owns the block-wise INT8 moment pairs; emits bias-corrected
    directions. A group's ``adam_bits`` selects float32 moments."""
    rules = as_rules(cfg_or_rules)

    def init(params_flat, specs, rules_, seed):
        return [None if spec.frozen else adam8bit.init_state(
            spec.low_shape if spec.galore else spec.shape,
            AdamHyper.from_config(_eff_cfg(spec, rules_)),
            qgalore.leaf_device(leaf))
            for leaf, spec in zip(params_flat, specs)]

    def apply(ctx: _Ctx, vals, inner_flat):
        out = list(vals)
        new_inner = list(inner_flat)
        for idx, spec in enumerate(ctx.specs):
            if spec.frozen:
                continue
            out[idx], new_inner[idx] = adam8bit.update(
                vals[idx].to(torch.float32), inner_flat[idx], ctx.count,
                AdamHyper.from_config(_eff_cfg(spec, ctx.rules)))
        return out, new_inner

    return Stage("quantized_adam", rules, init, apply)


def backproject(cfg_or_rules) -> Stage:
    """Map subspace directions back to full-rank updates with the P the
    ``project`` stage used this step, scaled by the group's GaLore alpha;
    a stacked leaf one layer at a time, as the monolith does."""
    rules = as_rules(cfg_or_rules)

    def apply(ctx: _Ctx, vals, _state):
        if ctx.proj is None:
            raise ValueError("backproject() needs a project() stage earlier "
                             "in the chain")
        out = list(vals)
        for idx, spec in enumerate(ctx.specs):
            if spec.frozen or not spec.galore:
                continue
            scale = _eff_cfg(spec, ctx.rules).scale
            back = lambda d, P: scale * projector.project_back(
                d.to(torch.float32), projector.maybe_dequantize(P),
                spec.side)
            P, direction = ctx.proj[idx], vals[idx]
            if spec.batch:
                P_f = _layers(P, spec)
                d_f = _layers(direction, spec)
                out[idx] = torch.stack([
                    back(d_f[i], qgalore._layer(P_f, i))
                    for i in range(spec.nbatch)]).reshape(spec.shape)
            else:
                out[idx] = back(direction, P)
        return out, None

    return Stage("backproject", rules, _noop_init, apply)


def sr_requant(cfg_or_rules) -> Stage:
    """Terminal stage: apply ``-lr * update`` to the weights. INT8 weights
    are requantized with stochastic rounding (a group's
    ``stochastic_rounding=False``: to nearest), float weights get the plain
    subtraction; the group's weight decay and learning-rate multiplier
    apply. The chain's value list becomes the new params."""
    rules = as_rules(cfg_or_rules)

    def apply(ctx: _Ctx, vals, _state):
        out = []
        for idx, spec in enumerate(ctx.specs):
            param = ctx.params_flat[idx]
            if spec.frozen:
                out.append(param)
                continue
            eff = _eff_cfg(spec, ctx.rules)
            upd, lr = vals[idx], ctx.lr_for(spec)
            if spec.galore and spec.batch:
                # one layer at a time, with the monolith's per-layer draws
                p_f, u_f = _layers(param, spec), _layers(upd, spec)
                parts = []
                for i in range(spec.nbatch):
                    p_l = qgalore._layer(p_f, i)
                    parts.append(qgalore._apply_weight_update(
                        p_l, u_f[i], None, spec, eff, lr,
                        lambda i=i, p_l=p_l: ctx.draw(idx, i, p_l.q.shape)))
                out.append(qgalore._unflat_batch(qgalore._stack(parts),
                                                 spec.batch))
            else:
                out.append(qgalore._apply_weight_update(
                    param, upd, None, spec, eff, lr,
                    lambda: ctx.draw(idx, None, param.q.shape)))
        return out, None

    return Stage("sr_requant", rules, _noop_init, apply)


def add_weight_decay(wd: Optional[float] = None) -> Stage:
    """Explicit decoupled weight decay (adds ``wd * W`` to the update
    before ``sr_requant``). ``sr_requant`` already honours the group's
    ``weight_decay``: use this stage only in chains whose configs keep it
    0 (to decay one group, or to decay before clipping)."""

    def apply(ctx: _Ctx, vals, _state):
        out = list(vals)
        for idx, spec in enumerate(ctx.specs):
            if spec.frozen:
                continue
            decay = _eff_cfg(spec, ctx.rules).weight_decay if wd is None \
                else wd
            if not decay:
                continue
            param = ctx.params_flat[idx]
            w = quant.dequantize(param, torch.float32) \
                if isinstance(param, quant.QTensor) \
                else param.to(torch.float32)
            out[idx] = vals[idx].to(torch.float32) + decay * w
        return out, None

    return Stage("add_weight_decay", None, _noop_init, apply)


# ---------------------------------------------------------------------------
# Chain combinator
# ---------------------------------------------------------------------------

def chain(*stages: Stage, rules=None) -> GradientTransformation:
    """Compose stages into one transformation (optax's ``chain``).
    ``rules`` defaults to the first stage that carries one."""
    if rules is None:
        rules = next((s.rules for s in stages if s.rules is not None), None)
    if rules is None:
        raise ValueError("chain() needs rules: pass rules= or include a "
                         "stage built from a config or rule-set")
    rules = as_rules(rules)

    def init(params, seed: int = 0, specs=None):
        specs = specs or qgalore.leaf_specs(params, rules)
        params_flat = [l for _, l in qgalore.flatten(params)]
        return ChainState(tuple(s.init(params_flat, specs, rules, seed)
                                for s in stages), 0)

    def update(grads, state: ChainState, params, *, lr: float, uniforms,
               omegas=None, refresh_masks=None, refresh: bool = False,
               specs=None):
        specs = specs or qgalore.leaf_specs(params, rules)
        flat = qgalore.flatten(params)
        vals = [g for _, g in qgalore.flatten(grads)]
        count = state.count + 1
        ctx = _Ctx([l for _, l in flat], specs, rules, lr, uniforms, omegas,
                   count, refresh, refresh_masks)
        new_states = []
        for s, st in zip(stages, state.stages):
            vals, st = s.apply(ctx, vals, st)
            new_states.append(st)
        return (qgalore.unflatten([k for k, _ in flat], vals),
                ChainState(tuple(new_states), count), ctx.metrics)

    return GradientTransformation(init, update)


# ---------------------------------------------------------------------------
# The canonical chains
# ---------------------------------------------------------------------------

def qgalore_reference_chain(cfg_or_rules) -> GradientTransformation:
    """The four canonical stages composed literally: the unfused per-leaf
    reference. Its state is ``ChainState((P per leaf, Adam state per leaf,
    None, None), count)``."""
    rules = as_rules(cfg_or_rules)
    return chain(project(rules), quantized_adam(rules), backproject(rules),
                 sr_requant(rules), rules=rules)


def chain_state(opt: QGaLoreState) -> ChainState:
    """A ``qgalore_transform`` state as :func:`qgalore_reference_chain`'s,
    sharing its tensors."""
    return ChainState((list(opt.proj), list(opt.inner), None, None),
                      opt.count)


def qgalore_transform(cfg_or_rules, specs=None) -> GradientTransformation:
    """The canonical Q-GaLore transformation: the ``project ->
    quantized_adam -> backproject -> sr_requant`` chain executed by
    ``qgalore.init`` / ``qgalore.apply_updates``, where every eligible
    steady leaf runs Adam, the INT4 back-projection and the SR requant as
    one fused kernel. Its state is a plain ``QGaLoreState`` (checkpoints
    take it). The train step runs it."""
    rules = as_rules(cfg_or_rules)
    _specs = specs

    def init(params, seed: int = 0, specs=None):
        return qgalore.init(params, rules, seed, specs=specs or _specs)

    def update(grads, state: QGaLoreState, params, *, lr: float, uniforms,
               omegas=None, refresh_masks=None, refresh: bool = False,
               specs=None, zero=None):
        return qgalore.apply_updates(
            params, grads, state, rules, lr, uniforms,
            refresh_masks=refresh_masks, refresh=refresh,
            specs=specs or _specs, omegas=omegas, zero=zero)

    return GradientTransformation(init, update)
