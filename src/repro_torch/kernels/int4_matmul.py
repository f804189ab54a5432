"""Wrapper of the CUDA ``int4_matmul`` kernel (``csrc/int4_matmul.cu``):
the port of ``repro/kernels/int4_matmul.py``.

``g (M, K) @ deq_int4(packed (K, R/2), scale/zero (K, R/block))`` →
``(M, R)`` f32: the GaLore projection onto an INT4 P (nibbles interleaved,
low first, each minus 8; asymmetric ``(u - zero) * scale`` per (row,
block)). g is float32 or bfloat16; M and K may be ragged. For a CUDA
tensor it launches the kernel; for a CPU tensor it runs
``ref.int4_matmul_ref``.

The kernel runs on the tensor cores (``mma.sync`` bf16, f32 sums): a block
owns an output tile inside one block of R, so ``A = g * s`` has one scale
a k row; B is the exact ``nibble - 8``; the zero point is an f32
correction ``sum_k (g * s) * z`` subtracted in the epilogue. bf16 g takes
one pass, f32 g two (hi/lo of ``g * s``). The output tile is 64 x 128
(a block of R narrower than 128 masks the rest); :func:`plan` chooses the
K split from the shapes alone, in Python, so the CPU tests reach it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, build, ref

TILE_M = 64          # the kernel's output rows a block
TILE_N = 128         # its output columns a block, inside one block of R
TILE_K = 32          # its k step (a split's rows are a multiple)
H100_SMS = 132


class Plan(NamedTuple):
    kc: int          # K rows per split
    splits: int      # K splits (> 1: partials + ordered reduction)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, K: int, R: int, block: int, sms: int = H100_SMS) -> Plan:
    """Launch plan for ``g (M, K) @ P (K, R)`` with P quantized in blocks
    of ``block`` columns.

    The 64 x 128 output tiles never straddle a block of R (a block's last
    tile is ragged). K is split only when the tiles cannot fill one wave,
    with at least 256 rows a split, at most 16 splits, each a multiple of
    the 32-row k step.
    """
    tiles = (R // block) * _cdiv(block, TILE_N) * _cdiv(M, TILE_M)
    splits = max(1, min(_cdiv(sms, tiles), K // 256, 16))
    kc = max(TILE_K, _cdiv(_cdiv(K, splits), TILE_K) * TILE_K)
    return Plan(kc, max(1, _cdiv(K, kc)))


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
        if _cdiv(M, TILE_M) > 65535:
            raise ValueError(f"too many rows for one launch: {M}")
        if block % 2:       # a block of R starts on a whole byte
            raise ValueError(f"the kernel needs an even block, got {block}")


def int4_matmul(g: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                zero: torch.Tensor, block: int) -> torch.Tensor:
    """See the module docstring."""
    _check(g, packed, scale, zero, block)
    if g.device.type == "cpu":
        return ref.int4_matmul_ref(g, packed, scale, zero, block)
    M, K = g.shape
    R = packed.shape[1] * 2
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    p = plan(M, K, R, block, sms)
    out = torch.empty((M, R), dtype=torch.float32, device=g.device)
    ws = (torch.empty((p.splits, M, R), dtype=torch.float32,
                      device=g.device) if p.splits > 1 else out)
    # a k pair is one load when K is even and g is aligned to two elements
    vec = int(K % 2 == 0 and g.data_ptr() % (2 * g.element_size()) == 0)
    fn = _entry()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    LAUNCHES["int4_matmul"] += 1
    err = fn(g.data_ptr(), int(g.dtype == torch.bfloat16), packed.data_ptr(),
             scale.data_ptr(), zero.data_ptr(), out.data_ptr(), ws.data_ptr(),
             M, K, R, block, p.kc, p.splits, vec, stream)
    if err != 0:
        raise RuntimeError(f"int4_matmul launch failed: CUDA error {err} "
                           f"(M={M}, K={K}, R={R}, block={block}, {p})")
    return out


def _entry():
    lib = build.load("int4_matmul")
    fn = lib.qgl_int4_matmul
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
        fn.restype = i
    return fn
