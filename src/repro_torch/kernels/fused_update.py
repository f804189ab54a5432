"""Wrapper of the CUDA ``fused_qgalore_update`` kernel
(``csrc/fused_update.cu``): the port of ``repro/kernels/fused_update.py``.

One Q-GaLore step for one 2-D INT8 weight: low-rank f32 Adam, INT4 ``P``
unpack, back-projection, optional weight decay, ``deq(W) - lr * U`` and a
per-256-column absmax stochastic-rounding requantization, with the
uniforms ``u01`` passed in. Arrays arrive padded as the JAX kernel takes
them (``kernels.ops.fused_qgalore_update`` pads and crops):

* ``side="right"``: g/m/v ``(M, r)``; P packed ``(N, r/2)`` uint8 with
  scale/zero ``(N, r/pblock)``; q ``(M, N)`` int8; wscale ``(M, N/256)``;
  u01 ``(M, N)`` f32.
* ``side="left"``: g/m/v ``(r, N)``; P packed ``(M, r/2)``; the rest as
  above.

Returns ``(q', wscale', m', v')``. For a CUDA tensor it launches the
kernel; for a CPU tensor it runs ``ref.fused_qgalore_update_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.adam8bit import bias_correction
from repro_torch.kernels import LAUNCHES, build, ref

GROUP = 256          # the kernel's weight quant block along N


def _check(g, m, v, p_packed, p_scale, p_zero, q, wscale, u01, side: str,
           pblock: int, wblock: int) -> None:
    if side not in ("right", "left"):
        raise ValueError(f"side must be 'right' or 'left', got {side!r}")
    M, N = q.shape
    R = p_packed.shape[-1] * 2
    low = (M, R) if side == "right" else (R, N)
    d = N if side == "right" else M
    want = {"g": (g, low, torch.float32), "m": (m, low, torch.float32),
            "v": (v, low, torch.float32),
            "p_packed": (p_packed, (d, R // 2), torch.uint8),
            "p_scale": (p_scale, (d, R // pblock), torch.float32),
            "p_zero": (p_zero, (d, R // pblock), torch.float32),
            "q": (q, (M, N), torch.int8),
            "wscale": (wscale, (M, N // wblock), torch.float32),
            "u01": (u01, (M, N), torch.float32)}
    if wblock != GROUP or N % GROUP or R % pblock:
        raise ValueError(f"need weight block {GROUP}, N % {GROUP} == 0 and "
                         f"r % pblock == 0; got wblock={wblock}, N={N}, "
                         f"r={R}, pblock={pblock}")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: need {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if q.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def fused_qgalore_update(g, m, v, p_packed, p_scale, p_zero, q, wscale, u01,
                         count: float, lr: float, *, side: str, pblock: int,
                         wblock: int = GROUP, beta1: float = 0.9,
                         beta2: float = 0.999, eps: float = 1e-8,
                         gscale: float = 0.25, wd: float = 0.0):
    """See the module docstring. ``count`` is the 1-based step."""
    _check(g, m, v, p_packed, p_scale, p_zero, q, wscale, u01, side, pblock,
           wblock)
    if q.device.type == "cpu":
        return ref.fused_qgalore_update_ref(
            g, m, v, p_packed, p_scale, p_zero, q, wscale, u01, count, lr,
            side=side, pblock=pblock, wblock=wblock, beta1=beta1,
            beta2=beta2, eps=eps, gscale=gscale, wd=wd)
    for name, t in (("q", q), ("u01", u01)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if pblock % 2:
        raise ValueError(f"the kernel needs an even pblock, got {pblock}")
    M, N = q.shape
    R = p_packed.shape[-1] * 2
    lib = build.load("fused_update")
    fn = _entry(lib)
    q_out = torch.empty_like(q)
    ws_out = torch.empty_like(wscale)
    m_out, v_out = torch.empty_like(g), torch.empty_like(g)
    # the direction as bf16 hi and lo, each block of the rank padded to the
    # kernel's step, and its f32 block sums
    nb, kb = R // pblock, lib.qgl_fused_update_block_ranks(pblock)
    low = (M, nb * kb) if side == "right" else (nb * kb, N)
    dh, dl = (torch.empty(low, dtype=torch.bfloat16, device=q.device)
              for _ in range(2))
    dsum = torch.empty((M, nb) if side == "right" else (nb, N),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    c = float(count)
    LAUNCHES["fused_qgalore_update"] += 1
    err = fn(g.data_ptr(), m.data_ptr(), v.data_ptr(), p_packed.data_ptr(),
             p_scale.data_ptr(), p_zero.data_ptr(), q.data_ptr(),
             wscale.data_ptr(), u01.data_ptr(), q_out.data_ptr(),
             ws_out.data_ptr(), m_out.data_ptr(), v_out.data_ptr(),
             dh.data_ptr(), dl.data_ptr(), dsum.data_ptr(), M, N, R, pblock,
             int(side == "right"),
             beta1, 1.0 - beta1, beta2, 1.0 - beta2,
             bias_correction(beta1, c), bias_correction(beta2, c), eps, lr,
             gscale, wd, stream)
    if err != 0:
        raise RuntimeError(f"fused_qgalore_update launch failed: CUDA error "
                           f"{err} (M={M}, N={N}, r={R}, side={side})")
    return q_out, ws_out, m_out, v_out


def _entry(lib):
    fn = lib.qgl_fused_update
    if fn.argtypes is None:
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 16 + [i] * 5 + [f] * 10 + [vp]
        fn.restype = i
        lib.qgl_fused_update_block_ranks.argtypes = [i]
        lib.qgl_fused_update_block_ranks.restype = i
    return fn
