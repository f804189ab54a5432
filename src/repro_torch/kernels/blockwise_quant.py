"""Wrapper of the CUDA ``blockwise_quant`` kernel
(``csrc/blockwise_quant.cu``): the port of
``repro/kernels/blockwise_quant.py``.

x ``(R, C)`` f32 → codes ``(R, C)`` int8 and scales ``(R, C/256)`` f32:
symmetric INT8, round half to even. For a CUDA tensor it launches the
kernel, whose codes and scales equal the plain version's bit for bit; for
a CPU tensor it runs ``ref.blockwise_quant_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, ref

GROUP = 256          # the kernel's quant block along C


def _check(x: torch.Tensor, block: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"need a 2-D input, got {tuple(x.shape)}")
    R, C = x.shape
    if block != GROUP or C % GROUP:
        raise ValueError(f"need quant block {GROUP} and C % {GROUP} == 0, "
                         f"got block={block}, C={C}")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned")
        if -(-R // 32) > 65535:
            raise ValueError(f"too many rows for one launch: {R}")


def blockwise_quant(x: torch.Tensor, block: int = GROUP):
    """See the module docstring."""
    _check(x, block)
    if x.device.type == "cpu":
        return ref.blockwise_quant_ref(x, block)
    R, C = x.shape
    q = torch.empty((R, C), dtype=torch.int8, device=x.device)
    s = torch.empty((R, C // block), dtype=torch.float32, device=x.device)
    fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCHES["blockwise_quant"] += 1
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), R, C, stream)
    if err != 0:
        raise RuntimeError(f"blockwise_quant launch failed: CUDA error {err} "
                           f"(R={R}, C={C})")
    return q, s


def _entry():
    lib = build.load("blockwise_quant")
    fn = lib.qgl_blockwise_quant
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, vp]
        fn.restype = i
    return fn
