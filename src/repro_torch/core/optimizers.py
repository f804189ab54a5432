"""Learning-rate schedules and optimizer presets (the counterpart of
``repro/core/optimizers.py``). Every baseline of the paper is a
``QGaLoreConfig`` preset over one implementation."""
from __future__ import annotations

import math

from repro_torch.config import QGaLoreConfig, TrainConfig, replace


def lr_at(step: int, cfg: TrainConfig) -> float:
    """Host-side schedule: linear warm-up, then cosine / linear / constant."""
    base = cfg.learning_rate
    warm = max(cfg.warmup_steps, 1)
    if step < cfg.warmup_steps:
        return base * (step + 1) / warm
    if cfg.lr_schedule == "constant":
        return base
    total = max(cfg.steps - cfg.warmup_steps, 1)
    frac = min((step - cfg.warmup_steps) / total, 1.0)
    floor = cfg.min_lr_ratio * base
    if cfg.lr_schedule == "linear":
        return base + (floor - base) * frac
    return floor + 0.5 * (base - floor) * (1 + math.cos(math.pi * frac))


PRESET_OVERRIDES = {
    "full": dict(enabled=False, adam_bits=32, weight_bits=0,
                 stochastic_rounding=False),
    "adamw": dict(enabled=False, adam_bits=32, weight_bits=0,
                  stochastic_rounding=False),
    "adam": dict(enabled=False, adam_bits=32, weight_bits=0,
                 stochastic_rounding=False),
    "adam8bit": dict(enabled=False, adam_bits=8, weight_bits=0,
                     stochastic_rounding=False),
    "galore": dict(enabled=True, adam_bits=32, weight_bits=0,
                   proj_bits=32, stochastic_rounding=False, adaptive=False),
    "galore8bit": dict(enabled=True, adam_bits=8, weight_bits=0,
                       proj_bits=32, stochastic_rounding=False,
                       adaptive=False),
    "qgalore": dict(enabled=True, adam_bits=8, weight_bits=8,
                    proj_bits=4, stochastic_rounding=True, adaptive=True),
    "qgalore_nosr": dict(enabled=True, adam_bits=8, weight_bits=8,
                         proj_bits=4, stochastic_rounding=False,
                         adaptive=True),
}


def preset(name: str, base: QGaLoreConfig = QGaLoreConfig()) -> QGaLoreConfig:
    """The preset's ``QGaLoreConfig``: ``base`` with its overrides."""
    try:
        return replace(base, **PRESET_OVERRIDES[name.lower()])
    except KeyError:
        raise ValueError(f"unknown optimizer preset: {name}") from None
