"""8-bit Adam (Dettmers et al.): block-wise quantized first and second
moments, the counterpart of ``repro/core/adam8bit.py``.

Moments are block-wise INT8 ``QTensor``s (block 256, or the largest power
of two under a shorter last axis): ``m`` symmetric, ``v`` asymmetric and
stored as ``sqrt(v)`` to halve its dynamic range. With ``bits == 32`` the
states stay float32. Quantization here rounds to nearest, so the two
packages store the same codes for the same moments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.core import quant
from repro_torch.core.quant import QTensor


class Adam8bitState(NamedTuple):
    m: Any          # QTensor | torch.Tensor
    v: Any          # QTensor | torch.Tensor


@dataclass(frozen=True)
class AdamHyper:
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    bits: int = 8
    block: int = 256

    @classmethod
    def from_config(cls, cfg) -> "AdamHyper":
        return cls(cfg.beta1, cfg.beta2, cfg.eps, cfg.adam_bits,
                   cfg.quant_block)


def _eff_block(shape, hyper: AdamHyper) -> int:
    return quant.auto_block(shape[-1], hyper.block)


def init_state(shape, hyper: AdamHyper, device="cpu") -> Adam8bitState:
    z = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
    if hyper.bits == 32:
        return Adam8bitState(z, z.clone())
    blk = _eff_block(shape, hyper)
    m = quant.quantize_blockwise(z, bits=8, block=blk, symmetric=True)
    v = quant.quantize_blockwise(z, bits=8, block=blk, symmetric=False)
    return Adam8bitState(m, v)


def _deq(x) -> torch.Tensor:
    if isinstance(x, QTensor):
        return quant.dequantize(x, torch.float32)
    return x.to(torch.float32)


def moments_fp32(state: Adam8bitState) -> Tuple[torch.Tensor, torch.Tensor]:
    """The moment pair in float32 (``v`` leaves the sqrt domain)."""
    m = _deq(state.m)
    if isinstance(state.v, QTensor):
        s = _deq(state.v)
        return m, s * s
    return m, _deq(state.v)


def pack_moments(m: torch.Tensor, v: torch.Tensor,
                 hyper: AdamHyper) -> Adam8bitState:
    """Float32 moments back into the stored form (``v`` into the sqrt
    domain for 8 bits)."""
    if hyper.bits == 32:
        return Adam8bitState(m, v)
    blk = _eff_block(m.shape, hyper)
    return Adam8bitState(
        quant.quantize_blockwise(m, bits=8, block=blk, symmetric=True),
        quant.quantize_blockwise(torch.sqrt(v), bits=8, block=blk,
                                 symmetric=False))


def update(grad: torch.Tensor, state: Adam8bitState, count: int,
           hyper: AdamHyper) -> Tuple[torch.Tensor, Adam8bitState]:
    """One Adam step on (possibly low-rank) ``grad``; ``count`` is the
    1-based step after this update. Returns the bias-corrected direction
    ``m̂ / (sqrt(v̂) + eps)`` and the new state."""
    g = grad.to(torch.float32)
    m_prev, v_prev = moments_fp32(state)
    m = hyper.beta1 * m_prev + (1.0 - hyper.beta1) * g
    v = hyper.beta2 * v_prev + (1.0 - hyper.beta2) * (g * g)
    c = float(count)
    m_hat = m / bias_correction(hyper.beta1, c)
    v_hat = v / bias_correction(hyper.beta2, c)
    direction = m_hat / (torch.sqrt(v_hat) + hyper.eps)
    return direction.to(grad.dtype), pack_moments(m, v, hyper)


def bias_correction(beta: float, c: float) -> float:
    """``1 - beta**c`` in float32, as the JAX package computes it on a
    float32 count (and the fused kernel takes it)."""
    return float(torch.tensor(1.0, dtype=torch.float32)
                 - torch.tensor(beta, dtype=torch.float32)
                 ** torch.tensor(c, dtype=torch.float32))
