"""The single-device training step: fused projected backward + Q-GaLore
update (the counterpart of the single-device ``impl="fused"`` path of
``repro/train/step.py``, no mesh).

A steady step emits GaLore gradients low-rank straight out of the
per-layer backward and updates them through the fused kernel; a refresh
step (a non-empty mask from the controller) takes full-rank gradients so
the masked per-layer subspace refresh can run. With ``accum > 1`` the
batch splits into ``accum`` microbatches along its first axis; their
gradients (low-rank on steady steps, full-rank on refresh steps) are
summed in float32 and divided by ``accum``, the loss is their mean and the
other metrics are the last microbatch's, as the reference's scan does.

Every stochastic rounding draws from a *uniform source*
``uniforms(step, leaf_idx, layer or None, shape) -> float32 tensor``, and
the randomized subspace method from a *normal source* ``omegas(step,
leaf_idx, unit, (k, p))``. The defaults, :func:`generator_uniforms` and
:func:`generator_normals`, seed a ``torch.Generator`` on the device from
the step and the leaf; a test passes the JAX package's own draws instead.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.core import qgalore, transform
from repro_torch.core.qgalore import LeafSpec, QGaLoreState
from repro_torch.core.quant import true_div
from repro_torch.core.rules import as_rules
from repro_torch.models.base import ModelBundle
from repro_torch.serve.params import quantize_leaf
from repro_torch.train import stack

UniformSource = Callable[[int, int, Optional[int], Tuple[int, ...]],
                         torch.Tensor]
NormalSource = Callable[[int, int, int, Tuple[int, int]], torch.Tensor]


class TrainState(NamedTuple):
    params: dict
    opt: QGaLoreState


def prepare_params(params, qcfg, param_dtype=torch.float32,
                   keys: Tuple[str, ...] = ()):
    """INT8 symmetric QTensors where the leaf's ``weight_bits == 8``,
    ``ndim >= 2`` and the last axis is at least 32; other leaves stay
    float32 (1-D norms) or are cast to ``param_dtype`` (float baselines).
    ``qcfg``: a ``QGaLoreConfig`` or a ``ParamRules`` (each leaf's bits
    from its group, by its path; ``keys`` is the path of ``params``)."""
    rules = as_rules(qcfg)
    if isinstance(params, dict):
        return {k: prepare_params(v, rules, param_dtype, keys + (k,))
                for k, v in params.items()}
    eff = rules.config_for(qgalore.keystr(keys))
    if eff.weight_bits == 8:
        return quantize_leaf(params, eff.quant_block)
    if params.ndim >= 2 and params.is_floating_point():
        return params.to(param_dtype)
    return params


def init_state(bundle: ModelBundle, qcfg, seed: int,
               param_dtype=torch.float32,
               specs: Optional[List[LeafSpec]] = None) -> TrainState:
    """Weights drawn from ``seed`` on the bundle's device, quantized one
    group at a time, and a fresh optimizer state (shaped by ``specs``
    where given, e.g. rank-overridden)."""
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    params = bundle.init_params(
        gen, leaf_fn=lambda keys, t: prepare_params(t, qcfg, param_dtype,
                                                    keys))
    return TrainState(params, qgalore.init(params, qcfg, seed + 1, specs))


def abstract_params(bundle: ModelBundle, qcfg, param_dtype=torch.float32):
    """The prepared parameters' layout on the ``meta`` device (no memory):
    leaf specs and restore templates come from it."""
    return bundle.init_params(
        torch.Generator(), device_="meta",
        leaf_fn=lambda keys, t: prepare_params(t, qcfg, param_dtype, keys))


def abstract_state(bundle: ModelBundle, qcfg, param_dtype=torch.float32,
                   specs: Optional[List[LeafSpec]] = None) -> TrainState:
    """:func:`init_state`'s layout on the ``meta`` device; ``specs`` carry
    rank overrides, so the low-rank state matches a shrunk checkpoint."""
    params = abstract_params(bundle, qcfg, param_dtype)
    specs = specs or qgalore.leaf_specs(params, qcfg)
    return TrainState(params, qgalore.state_template(specs, qcfg))


def generator_uniforms(seed: int, device) -> UniformSource:
    """Uniform [0, 1) draws from a ``torch.Generator`` on ``device`` seeded
    by ``(seed, step, leaf_idx, layer)``."""
    def draw(step, leaf_idx, layer, shape):
        key = ((seed * 1_000_003 + step) * 4099 + leaf_idx) * 1031 \
            + (0 if layer is None else layer + 1)
        gen = torch.Generator(device=device).manual_seed(key % (2 ** 63))
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)
    return draw


def generator_normals(seed: int, device) -> NormalSource:
    """Standard normal ``(k, p)`` draws from a ``torch.Generator`` on
    ``device`` seeded by ``(seed, step, leaf_idx, unit)``."""
    def draw(step, leaf_idx, unit, shape):
        key = ((seed * 1_000_033 + step) * 4111 + leaf_idx) * 1049 + unit
        gen = torch.Generator(device=device).manual_seed(key % (2 ** 63))
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)
    return draw


def _microbatch(batch, accum: int, i: int):
    """Microbatch ``i`` of ``accum``: contiguous rows of every input."""
    return {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def accumulated_value_and_grad(bundle: ModelBundle, params, batch,
                               proj_trees, accum: int):
    """``((loss, metrics), grads)`` over ``accum`` microbatches: gradients
    summed in float32 (each microbatch's added into the first's in place,
    layer by layer) then divided by ``accum``, the mean loss, the last
    microbatch's metrics."""
    if accum == 1:
        return stack.fused_value_and_grad(bundle, params, batch, proj_trees)
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{accum} microbatches")
    acc, loss_sum = None, None
    for i in range(accum):
        (loss, metrics), g = stack.fused_value_and_grad(
            bundle, params, _microbatch(batch, accum, i), proj_trees, acc)
        if acc is None:
            flat = qgalore.flatten(g)
            acc = qgalore.unflatten([k for k, _ in flat],
                                    [x.to(torch.float32) for _, x in flat])
            loss_sum = loss.to(torch.float32)
        else:
            loss_sum = loss_sum + loss
        del g
    flat = qgalore.flatten(acc)
    div = torch.full((), accum, dtype=torch.float32, device=loss_sum.device)
    for _, a in flat:
        a.div_(div)
    return (true_div(loss_sum, accum), metrics), acc


def build_train_step(bundle: ModelBundle, qcfg, tcfg: TrainConfig,
                     specs: List[LeafSpec], accum: int = 1):
    """``step(state, batch, lr, step_idx, uniforms, refresh_masks,
    omegas)`` → ``(state, metrics, opt_metrics)``; a non-empty
    ``refresh_masks`` (``{leaf_idx: (nbatch,) bool}``) makes it a refresh
    step. ``qcfg``: a ``QGaLoreConfig`` or a ``ParamRules``; ``accum``
    microbatches a step. The optimizer half is the canonical transform
    (``transform.qgalore_transform``: project -> quantized_adam ->
    backproject -> sr_requant), executed by ``qgalore.apply_updates``.

    A bundle built with ``flash_attention=True`` is refused: the flash
    kernel has no backward."""
    if bundle.flash_attention:
        raise ValueError("training through the flash-attention route needs "
                         "a backward kernel, which is not ported; build the "
                         "bundle with flash_attention=False")
    if accum < 1:
        raise ValueError(f"accum must be at least 1, got {accum}")
    tx = transform.qgalore_transform(qcfg, specs=specs)
    any_galore = any(s.galore for s in specs)

    def step(state: TrainState, batch, lr: float, step_idx: int,
             uniforms: UniformSource,
             refresh_masks: Optional[Dict[int, np.ndarray]] = None,
             omegas: Optional[NormalSource] = None):
        params, opt = state
        refresh = bool(refresh_masks)
        proj_trees = {}
        if any_galore and not refresh:
            proj_trees = qgalore.unflatten(
                [k for k, _ in qgalore.flatten(params)], opt.proj)
        (loss, metrics), grads = accumulated_value_and_grad(
            bundle, params, batch, proj_trees, accum)
        grads, gnorm = transform.clip_by_global_norm(grads, tcfg.grad_clip,
                                                     specs=specs)
        new_params, new_opt, opt_metrics = tx.update(
            grads, opt, params, lr=lr,
            uniforms=lambda leaf, layer, shape: uniforms(step_idx, leaf,
                                                         layer, shape),
            omegas=None if omegas is None else
            (lambda leaf, unit, shape: omegas(step_idx, leaf, unit, shape)),
            refresh_masks=refresh_masks, refresh=refresh)
        metrics = {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_params, new_opt), metrics, opt_metrics

    return step

