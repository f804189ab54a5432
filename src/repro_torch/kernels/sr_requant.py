"""Wrapper of the CUDA ``sr_requant`` kernel (``csrc/sr_requant.cu``): the
port of ``repro/kernels/sr_requant.py``.

``W' = SR_quant(deq(W) + U)`` for an INT8 weight: q ``(R, C)`` int8,
scale ``(R, C/256)`` f32, update and uniforms u01 ``(R, C)`` f32 →
``(q' int8, scale' f32)``. For a CUDA tensor it launches the kernel, whose
codes equal the plain version's bit for bit; for a CPU tensor it runs
``ref.sr_requant_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, build, ref

GROUP = 256          # the kernel's quant block along C


def _check(q, scale, update, u01, block: int) -> None:
    if q.ndim != 2:
        raise ValueError(f"need 2-D codes, got {tuple(q.shape)}")
    R, C = q.shape
    if block != GROUP or C % GROUP:
        raise ValueError(f"need quant block {GROUP} and C % {GROUP} == 0, "
                         f"got block={block}, C={C}")
    want = {"q": (q, (R, C), torch.int8),
            "scale": (scale, (R, C // block), torch.float32),
            "update": (update, (R, C), torch.float32),
            "u01": (u01, (R, C), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: need {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if q.device.type == "cuda":
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and -(-R // 32) > 65535:
        raise ValueError(f"too many rows for one launch: {R}")


def sr_requant(q: torch.Tensor, scale: torch.Tensor, update: torch.Tensor,
               u01: torch.Tensor, block: int = GROUP):
    """See the module docstring."""
    _check(q, scale, update, u01, block)
    if q.device.type == "cpu":
        return ref.sr_requant_ref(q, scale, update, u01, block)
    R, C = q.shape
    q_out = torch.empty_like(q)
    s_out = torch.empty_like(scale)
    fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    LAUNCHES["sr_requant"] += 1
    err = fn(q.data_ptr(), scale.data_ptr(), update.data_ptr(),
             u01.data_ptr(), q_out.data_ptr(), s_out.data_ptr(), R, C, stream)
    if err != 0:
        raise RuntimeError(f"sr_requant launch failed: CUDA error {err} "
                           f"(R={R}, C={C})")
    return q_out, s_out


def _entry():
    lib = build.load("sr_requant")
    fn = lib.qgl_sr_requant
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 6 + [i, i, vp]
        fn.restype = i
    return fn
