"""Wrapper of the CUDA ``flash_attention`` kernels
(``csrc/flash_attention.cu``): the port of
``repro/kernels/flash_attention.py``.

``q (B, S, H, d)``, ``k (B, S, KH, d)``, ``v (B, S, KH, dv)`` →
``(B, S, H, dv)`` in q's type: online-softmax attention, causal or full,
scores scaled by ``1/sqrt(d)`` in f32. GQA is native: query head ``h``
reads kv head ``h // (H / KH)``. Inputs are float32 or bfloat16, all of
one type; ``d, dv <= 128``; any S. For a CUDA tensor it launches a kernel
chosen by the type, both counted as ``LAUNCHES["flash_attention"]`` and
both the FlashAttention-2 shape on the tensor cores (``mma.sync`` bf16
products with f32 sums, the online softmax in f32 on the accumulators,
64-row K and V tiles streamed through shared memory, each warp owning 16
query rows):

* bf16 (every serving bundle): one pass; four warps a 64-row query tile,
  Q kept in registers. What bounds it at S 512 is the bytes of q, k, v
  and o and the softmax; at long S the ``mma.sync`` issue rate.
* f32 (the f32 bundles, the parity phases and tests): split precision,
  eight warps a 128-row query tile. Q, K, V and P become ``hi =
  bf16(x)`` and ``lo = bf16(x - hi)``, and each product takes three
  passes (``hi·hi + hi·lo + lo·hi``) into the same f32 sums, which keeps
  f32 callers within ~2^-16 of the f32 product. Each K and V tile is
  split once in shared memory for the block's warps.

For a CPU tensor it runs ``ref.flash_attention_ref`` (cast to q's type).
There is no backward (the JAX package has no backward kernel), so an
input that requires grad is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LAUNCHES, build, ref

MAX_HEAD_DIM = 128


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"need 4-D q, k, v (B, S, heads, dim); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, S, H, d = q.shape
    KH = k.shape[2]
    if tuple(k.shape) != (B, S, KH, d) or tuple(v.shape[:3]) != (B, S, KH):
        raise ValueError(f"k must be (B, S, KH, d) and v (B, S, KH, dv) "
                         f"for q {tuple(q.shape)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if H % KH:
        raise ValueError(f"query heads {H} not a multiple of kv heads {KH}")
    dv = v.shape[3]
    if not (1 <= d <= MAX_HEAD_DIM and 1 <= dv <= MAX_HEAD_DIM):
        raise ValueError(f"head dims must be 1..{MAX_HEAD_DIM}; got d={d}, "
                         f"dv={dv}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward: call it on "
                           "tensors that do not require grad")
    if q.device.type == "cuda":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if B * H >= 2 ** 31 or -(-S // 64) > 65535:
            raise ValueError(f"grid too large: B*H={B * H}, S={S}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """See the module docstring."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal).to(q.dtype)
    B, S, H, d = q.shape
    KH, dv = k.shape[2], v.shape[3]
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    fn = _entry()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    LAUNCHES["flash_attention"] += 1
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             int(q.dtype == torch.bfloat16), B, S, H, KH, d, dv, int(causal),
             1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"(B={B}, S={S}, H={H}, KH={KH}, d={d}, dv={dv})")
    return out


def _entry():
    lib = build.load("flash_attention")
    fn = lib.qgl_flash_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [i] * 8 + [ctypes.c_float, vp]
        fn.restype = i
    return fn
