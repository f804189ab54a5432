"""Model-facing INT8 matmuls over plain (serving) QTensor weights.

The counterpart of the serving half of ``repro/kernels/ops.py``. A weight
is a symmetric INT8 QTensor ``(K, Npad)`` with ``orig_last`` real columns.
On a CUDA tensor the CUDA kernel streams the codes; on a CPU tensor the
JAX package's CPU model path runs instead: dequantize, then one float32
matmul (``ref.deq_matmul``). The transposed op (tied head) and the
gradients come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor
from repro_torch.kernels import int8_matmul as _i8mm
from repro_torch.kernels import ref


def _check_weight(qt: QTensor) -> None:
    if not isinstance(qt, QTensor) or qt.bits != 8 or qt.zero is not None:
        raise TypeError("need a symmetric INT8 QTensor weight")
    if qt.ndim != 2:
        raise ValueError(f"need a 2-D weight, got {qt.shape}")


def int8_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """``x (..., K) @ deq(qt (K, N))`` → ``(..., orig_last)`` float32."""
    _check_weight(qt)
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.device.type == "cpu":
        out = ref.deq_matmul(x2, qt.q, qt.scale, qt.block, qt.orig_last)
    else:
        out = _i8mm.int8_matmul(x2.contiguous(), qt.q, qt.scale,
                                qt.block)[:, : qt.orig_last]
    return out.reshape(*lead, qt.orig_last)


def quantized_dense(x: torch.Tensor, qt: QTensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``x (..., K) @ deq(W (K, N))`` with W consumed as INT8 codes: a
    float32 result cast to ``dtype`` (``repro/kernels/ops.py:344``)."""
    return int8_matmul(x, qt).to(dtype)
