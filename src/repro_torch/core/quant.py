"""Block-wise uniform quantization (paper §3.1, §3.4), in PyTorch.

The counterpart of ``repro/core/quant.py`` with the same arithmetic, so the
two packages produce bit-identical codes and scales from the same input::

    W_q = clamp(round(W / s) + z, -2^{n-1}, 2^{n-1} - 1)

with a float32 scale ``s`` (and zero point ``z`` when asymmetric) per block
of ``block`` (default 256) elements along the last axis, which is first
zero-padded to a multiple of ``block``. ``torch.round`` rounds half to
even, as ``jnp.round`` does. INT4 codes are nibble-packed two per uint8,
low nibble first.

Stochastic rounding is ``floor(t + u)`` with ``u ~ U[0, 1)`` passed in as
an explicit tensor (``uniforms``): the port does not try to reproduce
``jax.random``, so a caller that wants both packages to agree hands both
the same uniforms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_BLOCK = 256
_EPS = 1e-12

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` → ``"float32"`` (the JAX package's spelling)."""
    return str(dtype).replace("torch.", "")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def true_div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as an IEEE division. PyTorch's CUDA
    kernels turn a division by a Python scalar into a product with its
    reciprocal, which rounds twice; dividing by a 0-d tensor filled on
    ``a``'s device (no host copy) keeps the reference's rounding, and the
    kernels', on the card too."""
    return a / torch.full((), b, dtype=a.dtype, device=a.device)


def _qrange(bits: int) -> Tuple[int, int]:
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def auto_block(last_dim: int, block: int = DEFAULT_BLOCK) -> int:
    """Largest sensible block ≤ last_dim (avoids 2× padding waste when
    quantizing tensors whose last dim is smaller than the block)."""
    if last_dim >= block:
        return block
    b = 2
    while b * 2 <= last_dim:
        b *= 2
    return b


@dataclass
class QTensor:
    """A block-wise quantized tensor.

    ``q``      int8 codes (bits==8) or uint8 nibble-packed codes (bits==4),
               shape (..., padded_last) or (..., padded_last // 2).
    ``scale``  float32 per-block scales, shape (..., padded_last // block).
    ``zero``   float32 per-block zero points (None when symmetric).
    ``dtype``  dequantization dtype name, e.g. ``"float32"``.
    """
    q: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    bits: int
    block: int
    orig_last: int
    dtype: str

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.q.shape[:-1]) + (self.orig_last,)

    @property
    def ndim(self) -> int:
        return self.q.ndim

    @property
    def symmetric(self) -> bool:
        return self.zero is None

    def map(self, fn) -> "QTensor":
        """Apply ``fn`` to every tensor (codes, scales, zeros)."""
        return QTensor(fn(self.q), fn(self.scale),
                       None if self.zero is None else fn(self.zero),
                       self.bits, self.block, self.orig_last, self.dtype)

    def to(self, device) -> "QTensor":
        return self.map(lambda t: t.to(device))


@dataclass
class QVirtual:
    """A quantized weight paired with a gradient slot for its virtual value
    (``repro/core/quant.py::QVirtual``).

    The INT8 codes stay the compute format; ``shadow`` is a zeros tensor of
    the virtual (dequantized, float32) shape with ``requires_grad``, never
    read, onto which the model's ops route ``dL/dW``."""
    qt: QTensor
    shadow: torch.Tensor

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.qt.shape

    @property
    def ndim(self) -> int:
        return self.qt.ndim


def virtualize(qt: QTensor) -> QVirtual:
    """Pair a QTensor with a zeros gradient slot of its virtual shape."""
    shadow = torch.zeros(qt.shape, dtype=torch_dtype(qt.dtype),
                         device=qt.q.device, requires_grad=True)
    return QVirtual(qt, shadow)


def gather_rows(qt: QTensor, idx: torch.Tensor) -> QTensor:
    """Row gather of a 2-D QTensor (embedding rows for a token batch)
    without dequantizing the table; the result dequantizes to
    ``(*idx.shape, orig_last)``."""
    if qt.ndim != 2:
        raise ValueError(f"gather_rows needs a 2-D QTensor, got {qt.shape}")
    idx = idx.long()
    return qt.map(lambda t: t[idx])


# ---------------------------------------------------------------------------
# INT4 packing
# ---------------------------------------------------------------------------

def pack_int4(u: torch.Tensor) -> torch.Tensor:
    """Pack unsigned nibbles (0..15, uint8) in pairs, low nibble first.
    The last axis must be even; it is halved."""
    lo = u[..., 0::2]
    hi = u[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8).contiguous()


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`."""
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(*p.shape[:-1], p.shape[-1] * 2)


# ---------------------------------------------------------------------------
# Quantize / dequantize
# ---------------------------------------------------------------------------

def _pad_last(x: torch.Tensor, block: int) -> torch.Tensor:
    pad = (-x.shape[-1]) % block
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    return x


def _block_view(x: torch.Tensor, block: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], x.shape[-1] // block, block)


def quantize_blockwise(x: torch.Tensor, bits: int = 8,
                       block: int = DEFAULT_BLOCK, symmetric: bool = False,
                       uniforms: Optional[torch.Tensor] = None) -> QTensor:
    """Block-wise uniform quantization along the last axis.

    ``uniforms`` (same shape as the padded input, values in [0, 1)) makes
    the rounding stochastic; otherwise it rounds to nearest, half to even.
    Scales and zeros are float32.
    """
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8, got {bits}")
    orig_last = x.shape[-1]
    dtype = dtype_name(x.dtype)
    xf = _pad_last(x.to(torch.float32), block)
    xb = _block_view(xf, block)
    qmin, qmax = _qrange(bits)

    if symmetric:
        absmax = xb.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp_min(true_div(absmax, qmax), _EPS)
        zero = None
        t = xb / scale
    else:
        mx = xb.amax(dim=-1, keepdim=True)
        mn = xb.amin(dim=-1, keepdim=True)
        scale = torch.clamp_min(true_div(mx - mn, qmax - qmin), _EPS)
        zero = qmin - mn / scale
        t = xb / scale + zero

    if uniforms is not None:
        codes = torch.floor(t + _block_view(uniforms.to(torch.float32),
                                            block))
    else:
        codes = torch.round(t)
    codes = torch.clamp(codes, qmin, qmax)

    flat_codes = codes.reshape(xf.shape)
    scale_out = scale[..., 0]
    zero_out = None if zero is None else zero[..., 0]
    if bits == 8:
        q = flat_codes.to(torch.int8)
    else:
        u8 = (flat_codes - qmin).to(torch.uint8)
        q = pack_int4(u8) if bits == 4 else u8
    return QTensor(q, scale_out, zero_out, bits, block, orig_last, dtype)


def dequantize(qt: QTensor, dtype=None) -> torch.Tensor:
    """``(q - z) * s`` cropped to the original last axis."""
    out_dtype = dtype if dtype is not None else torch_dtype(qt.dtype)
    qmin, _ = _qrange(qt.bits)
    if qt.bits == 8:
        codes = qt.q.to(torch.float32)
    elif qt.bits == 4:
        codes = unpack_int4(qt.q).to(torch.float32) + qmin
    else:
        codes = qt.q.to(torch.float32) + qmin
    cb = _block_view(codes, qt.block)
    if qt.zero is None:
        xb = cb * qt.scale[..., None]
    else:
        xb = (cb - qt.zero[..., None]) * qt.scale[..., None]
    x = xb.reshape(codes.shape)
    if x.shape[-1] != qt.orig_last:
        x = x[..., : qt.orig_last]
    return x.to(out_dtype)


def requantize_sr(qt: QTensor, update: torch.Tensor,
                  uniforms: torch.Tensor) -> QTensor:
    """The Q-GaLore weight update ``W' = SR_quant(dequant(W) + update)``
    (``repro/core/quant.py::requantize_sr``): per-block scales are
    recomputed from the updated values, and ``uniforms`` (shaped like the
    padded codes ``qt.q`` for INT8) drive the stochastic rounding."""
    w = dequantize(qt, torch.float32) + update.to(torch.float32)
    return quantize_blockwise(w, bits=qt.bits, block=qt.block,
                              symmetric=qt.symmetric, uniforms=uniforms)


# ---------------------------------------------------------------------------
# numpy hand-off (the JAX package exchanges QTensors as these tuples)
# ---------------------------------------------------------------------------

def to_numpy(qt: QTensor) -> tuple:
    """``(q, scale, zero, bits, block, orig_last, dtype)`` with numpy
    arrays (``zero`` may be None)."""
    return (qt.q.cpu().numpy(), qt.scale.cpu().numpy(),
            None if qt.zero is None else qt.zero.cpu().numpy(),
            qt.bits, qt.block, qt.orig_last, qt.dtype)


def from_numpy(t: tuple, device="cpu") -> QTensor:
    """Inverse of :func:`to_numpy`, placing the tensors on ``device``."""
    q, scale, zero, bits, block, orig_last, dtype = t
    as_t = lambda a: torch.from_numpy(np.array(a)).to(device)
    return QTensor(as_t(q), as_t(scale),
                   None if zero is None else as_t(zero),
                   int(bits), int(block), int(orig_last), str(dtype))
