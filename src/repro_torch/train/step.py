"""The single-device training step: fused projected backward + Q-GaLore
update (the counterpart of the single-device ``impl="fused"`` path of
``repro/train/step.py``, with ``accum=1`` and no mesh).

A steady step emits GaLore gradients low-rank straight out of the
per-layer backward and updates them through the fused kernel; a refresh
step (a non-empty mask from the controller) takes full-rank gradients so
the masked per-layer SVD can run.

Every stochastic rounding draws from a *uniform source*
``uniforms(step, leaf_idx, layer or None, shape) -> float32 tensor``. The
default, :func:`generator_uniforms`, seeds a ``torch.Generator`` on the
device from ``(seed, step, leaf_idx, layer)``; a test passes the JAX
package's own draws instead.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import QGaLoreConfig, TrainConfig
from repro_torch.core import qgalore
from repro_torch.core.qgalore import LeafSpec, QGaLoreState
from repro_torch.models.base import ModelBundle
from repro_torch.serve.params import quantize_leaf
from repro_torch.train import stack

UniformSource = Callable[[int, int, Optional[int], Tuple[int, ...]],
                         torch.Tensor]


class TrainState(NamedTuple):
    params: dict
    opt: QGaLoreState


def prepare_params(params, qcfg: QGaLoreConfig, param_dtype=torch.float32):
    """INT8 symmetric QTensors where ``weight_bits == 8``, ``ndim >= 2`` and
    the last axis is at least 32; other leaves stay float32 (1-D norms) or
    are cast to ``param_dtype`` (float baselines)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if qcfg.weight_bits == 8:
            return quantize_leaf(t, qcfg.quant_block)
        if t.ndim >= 2 and t.is_floating_point():
            return t.to(param_dtype)
        return t
    return walk(params)


def init_state(bundle: ModelBundle, qcfg: QGaLoreConfig, seed: int,
               param_dtype=torch.float32) -> TrainState:
    """Weights drawn from ``seed`` on the bundle's device, quantized one
    group at a time, and a fresh optimizer state."""
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    params = bundle.init_params(
        gen, leaf_fn=lambda t: prepare_params(t, qcfg, param_dtype))
    return TrainState(params, qgalore.init(params, qcfg, seed + 1))


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


def build_train_step(bundle: ModelBundle, qcfg: QGaLoreConfig,
                     tcfg: TrainConfig, specs: List[LeafSpec]):
    """``step(state, batch, lr, step_idx, uniforms, refresh_masks)`` →
    ``(state, metrics, opt_metrics)``; a non-empty ``refresh_masks``
    (``{leaf_idx: (nbatch,) bool}``) makes it a refresh step.

    A bundle built with ``flash_attention=True`` is refused: the flash
    kernel has no backward."""
    if bundle.flash_attention:
        raise ValueError("training through the flash-attention route needs "
                         "a backward kernel, which is not ported; build the "
                         "bundle with flash_attention=False")
    any_galore = any(s.galore for s in specs)

    def step(state: TrainState, batch, lr: float, step_idx: int,
             uniforms: UniformSource,
             refresh_masks: Optional[Dict[int, np.ndarray]] = None):
        params, opt = state
        refresh = bool(refresh_masks)
        proj_trees = {}
        if any_galore and not refresh:
            proj_trees = qgalore.unflatten(
                [k for k, _ in qgalore.flatten(params)], opt.proj)
        (loss, metrics), grads = stack.fused_value_and_grad(
            bundle, params, batch, proj_trees)
        grads, gnorm = qgalore.clip_by_global_norm(grads, tcfg.grad_clip)
        new_params, new_opt, opt_metrics = qgalore.apply_updates(
            params, grads, opt, qcfg, lr,
            lambda leaf, layer, shape: uniforms(step_idx, leaf, layer, shape),
            refresh_masks=refresh_masks, refresh=refresh, specs=specs)
        metrics = {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_params, new_opt), metrics, opt_metrics

    return step

