"""Plain PyTorch versions of the kernels (the counterparts of
``repro/kernels/ref.py``), and the CPU model path's dequantize-first
matmul."""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    block: int) -> torch.Tensor:
    """x (M, K) @ dequant(q (K, N) int8, scale (K, N/block)) → (M, N) f32.

    Scale-on-activation association, as the kernel computes it: the scale
    varies along the contraction axis K, so it folds into the activation
    per quant group, ``out[:, g] = (x * s[:, g]) @ q[:, g]``.
    """
    LAUNCHES["int8_matmul_ref"] += 1
    K, N = q.shape
    G = N // block
    xf = x.to(torch.float32)
    q3 = q.to(torch.float32).reshape(K, G, block)
    xs = xf[:, :, None] * scale[None, :, :]            # (M, K, G)
    return torch.einsum("mkg,kgb->mgb", xs, q3).reshape(x.shape[0], N)


def deq_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
               block: int, orig: int) -> torch.Tensor:
    """x (M, K) @ deq(q (K, Np))[:, :orig] → (M, orig) f32.

    Dequantize first, then one float32 matmul: the JAX package's CPU model
    path (``repro/kernels/ops.py`` ``_deq_cropped`` and the ref branch of
    ``_i8_call``). It is what the port runs for a CPU tensor, and what the
    model-level parity tests hold it against.
    """
    LAUNCHES["deq_matmul"] += 1
    K, Np = q.shape
    w = (q.to(torch.float32).reshape(K, Np // block, block)
         * scale[..., None]).reshape(K, Np)
    if orig != Np:
        w = w[:, :orig]
    return x.to(torch.float32) @ w
