"""Shared building blocks (the counterpart of ``repro/models/layers.py``).

Every matmul goes through :func:`dense`, which streams INT8 QTensor weights
through ``kernels.ops.quantized_dense``; embedding tables are read through
:func:`embed_lookup`, which gathers INT8 rows per token. Parameter trees
are nested dicts with the JAX package's leaf names (wq/wk/wv/wo, wi/wg/wd,
embedding, head, *_norm).

For training a weight arrives as a ``QVirtual`` (codes plus a zeros
``shadow`` that requires grad): matmuls route ``dL/dW`` to the shadow
through ``quantized_dense``'s backward, an embedding lookup as a row
scatter-add, and a materialized weight (norm scales) as the identity.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.quant import QTensor, QVirtual
from repro_torch.kernels import ops as kops


# ---------------------------------------------------------------------------
# Init helpers (same distributions as the JAX package; other numbers)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               scale: Optional[float] = None, *, num: Optional[int] = None,
               device="cpu") -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init; ``num`` stacks a layer axis."""
    std = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    shape = (in_dim, out_dim) if num is None else (num, in_dim, out_dim)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               device="cpu") -> torch.Tensor:
    return torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                       device=device).mul_(0.02)


def rmsnorm_init(dim: int, *, num: Optional[int] = None,
                 device="cpu") -> torch.Tensor:
    # stored as offset from 1 (zero-centred scale)
    shape = (dim,) if num is None else (num, dim)
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Quantization-aware matmul
# ---------------------------------------------------------------------------

def materialize(w, dtype=torch.bfloat16) -> torch.Tensor:
    """Full-precision view of a (possibly quantized) weight; for a
    QVirtual the gradient flows to its shadow (``+ shadow`` adds zeros)."""
    if isinstance(w, QVirtual):
        return (quant.dequantize(w.qt, torch.float32) + w.shadow).to(dtype)
    if isinstance(w, QTensor):
        return quant.dequantize(w, dtype)
    return w.to(dtype)


def dense(x: torch.Tensor, w, dtype=torch.bfloat16) -> torch.Tensor:
    """x (..., d) @ w (d, f); INT8 weights stream through the
    ``quantized_dense`` kernel (never materialized)."""
    qt = w.qt if isinstance(w, QVirtual) else w
    if isinstance(qt, QTensor) and qt.bits == 8 and qt.zero is None \
            and qt.ndim == 2:
        return kops.quantized_dense(x, w, dtype=dtype)
    return torch.einsum("...d,df->...f", x.to(dtype), materialize(w, dtype))


def embed_lookup(w, tokens: torch.Tensor, dtype=torch.bfloat16
                 ) -> torch.Tensor:
    """Embedding rows for ``tokens``. INT8 tables gather codes and scales
    per token and dequantize only those rows; a QVirtual's gradient reaches
    its shadow as a row scatter-add (the backward of ``shadow[tokens]``)."""
    if isinstance(w, QVirtual) and w.ndim == 2:
        rows = quant.dequantize(quant.gather_rows(w.qt, tokens))
        return (rows + w.shadow[tokens.long()]).to(dtype)
    if isinstance(w, QTensor) and w.ndim == 2:
        return quant.dequantize(quant.gather_rows(w, tokens)).to(dtype)
    return materialize(w, dtype)[tokens.long()]


# ---------------------------------------------------------------------------
# Norms / activations / rotary
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    # stacked norm scales arrive quantized (2-D leaves), so materialize
    return (y * (1.0 + materialize(w, torch.float32))).to(dt)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) → (sin, cos), each (..., S, head_dim // 2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, hd); sin/cos (..., S, hd//2) — rotate-half."""
    dt = x.dtype
    xf = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]   # broadcast over heads
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             num: Optional[int] = None, device="cpu") -> dict:
    return {
        "wi": dense_init(gen, d_model, d_ff, num=num, device=device),
        "wg": dense_init(gen, d_model, d_ff, num=num, device=device),
        "wd": dense_init(gen, d_ff, d_model, num=num, device=device),
    }


def ffn_apply(p: dict, x: torch.Tensor, dtype=torch.bfloat16
              ) -> torch.Tensor:
    """SwiGLU FFN (the LLaMA family's ``ffn_activation="silu"``)."""
    h = swiglu(dense(x, p["wg"], dtype), dense(x, p["wi"], dtype))
    return dense(h, p["wd"], dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return torch.tanh(logits / cap) * cap


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor):
    """Token-mean cross-entropy in float32; labels == -1 are ignored.
    Returns ``(loss, {"accuracy", "tokens"})``."""
    lf = logits.to(torch.float32)
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, safe[..., None])[..., 0]
    nll = (logz - gold) * valid
    denom = torch.clamp_min(valid.sum(), 1)
    loss = nll.sum() / denom
    acc = ((lf.argmax(-1) == safe) & valid).sum() / denom
    return loss, {"accuracy": acc, "tokens": denom}
