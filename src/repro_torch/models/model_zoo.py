"""Architecture registry of the port: the LLaMA family only."""
from __future__ import annotations

import importlib
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.base import ModelBundle

ARCH_IDS = ("llama-60m", "llama-130m", "llama-350m", "llama-1b",
            "llama-7b")


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise ValueError(f"{arch_id!r} is not ported; the port has "
                         f"{', '.join(ARCH_IDS)}")
    mod = importlib.import_module(
        "repro_torch.configs." + arch_id.replace("-", "_"))
    return mod.smoke_config() if smoke else mod.CONFIG


def build(cfg: ModelConfig, *, device=None, dtype=torch.bfloat16,
          flash_attention: bool = False,
          split_layers: int = 0) -> ModelBundle:
    """Bundle for ``cfg`` on ``device`` (default ``cuda``, which must be
    present). ``flash_attention`` routes prefill attention through the
    flash kernel (the JAX package's ``REPRO_FLASH_ATTENTION=1``);
    ``split_layers`` splits the block stack into two segments
    (``transformer.build``)."""
    if (cfg.family, cfg.attention, cfg.ffn_activation) != \
            ("dense", "gqa", "silu") or cfg.moe or cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: only the LLaMA shape is ported (dense GQA, "
            "SwiGLU, no qk-norm)")
    from repro_torch.models import transformer
    return transformer.build(cfg, device=resolve_device(device), dtype=dtype,
                             flash_attention=flash_attention,
                             split_layers=split_layers)


def build_arch(arch_id: str, smoke: bool = False,
               device: Optional[str] = None, **kw) -> ModelBundle:
    return build(get_config(arch_id, smoke=smoke), device=device, **kw)
