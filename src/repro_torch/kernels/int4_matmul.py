"""Wrapper of the CUDA ``int4_matmul`` kernel (``csrc/int4_matmul.cu``):
the port of ``repro/kernels/int4_matmul.py``.

``g (M, K) @ deq_int4(packed (K, R/2), scale/zero (K, R/block))`` →
``(M, R)`` f32: the GaLore projection onto an INT4 P (nibbles interleaved,
low first, each minus 8; asymmetric ``(u - zero) * scale`` per (row,
block)). g is float32 or bfloat16; M and K may be ragged. For a CUDA
tensor it launches the kernel; for a CPU tensor it runs
``ref.int4_matmul_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, ref


def _check(g, packed, scale, zero, block: int) -> None:
    if g.ndim != 2 or packed.ndim != 2:
        raise ValueError(f"need 2-D g and packed P; got {tuple(g.shape)}, "
                         f"{tuple(packed.shape)}")
    M, K = g.shape
    R = packed.shape[1] * 2
    if packed.shape[0] != K:
        raise ValueError(f"g has K={K}, P has {packed.shape[0]} rows")
    if block < 1 or R % block:
        raise ValueError(f"R={R} not a multiple of block {block}")
    if packed.dtype != torch.uint8:
        raise TypeError(f"packed P must be uint8, got {packed.dtype}")
    for name, t in (("scale", scale), ("zero", zero)):
        if tuple(t.shape) != (K, R // block) or t.dtype != torch.float32:
            raise ValueError(f"{name}: need {(K, R // block)} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g must be float32 or bfloat16, got {g.dtype}")
    if not (g.device == packed.device == scale.device == zero.device):
        raise ValueError("g, packed, scale, zero on different devices")
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g.device}")
    if g.device.type == "cuda":
        for name, t in (("g", g), ("packed", packed), ("scale", scale),
                        ("zero", zero)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if -(-M // 64) > 65535:
            raise ValueError(f"too many rows for one launch: {M}")


def int4_matmul(g: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zero: torch.Tensor, block: int) -> torch.Tensor:
    """See the module docstring."""
    _check(g, packed, scale, zero, block)
    if g.device.type == "cpu":
        return ref.int4_matmul_ref(g, packed, scale, zero, block)
    M, K = g.shape
    R = packed.shape[1] * 2
    out = torch.empty((M, R), dtype=torch.float32, device=g.device)
    fn = _entry()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    LAUNCHES["int4_matmul"] += 1
    err = fn(g.data_ptr(), int(g.dtype == torch.bfloat16), packed.data_ptr(),
             scale.data_ptr(), zero.data_ptr(), out.data_ptr(), M, K, R,
             block, stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {err} "
                           f"(M={M}, K={K}, R={R}, block={block})")
    return out


def _entry():
    lib = build.load("int4_matmul")
    fn = lib.qgl_int4_matmul
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, vp]
        fn.restype = i
    return fn
