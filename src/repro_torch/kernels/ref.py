"""Plain PyTorch versions of the kernels (the counterparts of
``repro/kernels/ref.py``), and the CPU model path's dequantize-first
matmuls. Each adds one to its ``LAUNCHES`` entry per call."""
from __future__ import annotations

import torch

from repro_torch.core.adam8bit import bias_correction
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


def int8_matmul_t_ref(g: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      block: int) -> torch.Tensor:
    """g (M, N) @ dequant(q (K, N) int8, scale (K, N/block))^T → (M, K) f32.

    The contraction runs along the quant axis, so raw codes dot first and
    the per-group scale lands once on each (M, K) partial sum, as the
    kernel accumulates it (``repro/kernels/ref.py::int8_matmul_t_ref``).
    """
    LAUNCHES["int8_matmul_t_ref"] += 1
    K, N = q.shape
    G = N // block
    g3 = g.to(torch.float32).reshape(g.shape[0], G, block)
    q3 = q.to(torch.float32).reshape(K, G, block)
    pdot = torch.einsum("mgb,kgb->mgk", g3, q3)
    return torch.einsum("mgk,kg->mk", pdot, scale)


def deq_matmul_t(g: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 block: int) -> torch.Tensor:
    """g (M, orig) @ deq(q (K, Np))[:, :orig]^T → (M, K) f32: the JAX
    package's CPU model path for ``dL/dx`` (the ref branch of
    ``_i8t_call``), run by the port for a CPU tensor."""
    LAUNCHES["deq_matmul_t"] += 1
    K, Np = q.shape
    w = (q.to(torch.float32).reshape(K, Np // block, block)
         * scale[..., None]).reshape(K, Np)[:, : g.shape[-1]]
    return g.to(torch.float32) @ w.T


def fused_qgalore_update_ref(g, m, v, p_packed, p_scale, p_zero, q, wscale,
                             u01, count: float, lr: float, *, side: str,
                             pblock: int, wblock: int, beta1: float = 0.9,
                             beta2: float = 0.999, eps: float = 1e-8,
                             gscale: float = 0.25, wd: float = 0.0):
    """The fused Q-GaLore update (``repro/kernels/fused_update.py``'s
    ``_adam`` → ``_dequant_p`` → back-projection → ``_deq_w`` →
    ``_sr_requant``), on arrays the wrapper padded.

    side="right": g/m/v (M, r), P packed (N, r/2) + scale/zero (N, r/pblock),
    q (M, N) int8, wscale (M, N/wblock), u01 (M, N).
    side="left":  g/m/v (r, N), P packed (M, r/2), the rest as above.
    Returns ``(q', wscale', m', v')``.
    """
    LAUNCHES["fused_qgalore_update_ref"] += 1
    g = g.to(torch.float32)
    m_new = beta1 * m + (1.0 - beta1) * g
    v_new = beta2 * v + (1.0 - beta2) * (g * g)
    m_hat = m_new / bias_correction(beta1, count)
    v_hat = v_new / bias_correction(beta2, count)
    dirn = m_hat / (torch.sqrt(v_hat) + eps)

    lo = (p_packed & 0xF).to(torch.float32)
    hi = ((p_packed >> 4) & 0xF).to(torch.float32)
    u4 = torch.stack([lo, hi], dim=-1).reshape(p_packed.shape[0], -1) - 8.0
    d, r = u4.shape
    P = ((u4.reshape(d, r // pblock, pblock) - p_zero[..., None])
         * p_scale[..., None]).reshape(d, r)
    upd = gscale * (dirn @ P.T if side == "right" else P @ dirn)

    R, C = q.shape
    w = (q.to(torch.float32).reshape(R, C // wblock, wblock)
         * wscale[..., None]).reshape(R, C)
    if wd:
        upd = upd + wd * w
    wn = (w - lr * upd).reshape(R, C // wblock, wblock)
    new_scale = torch.clamp_min(wn.abs().amax(dim=-1) / 127.0, 1e-12)
    codes = torch.floor(wn / new_scale[..., None]
                        + u01.reshape(R, C // wblock, wblock))
    q_new = torch.clamp(codes, -128, 127).reshape(R, C).to(torch.int8)
    return q_new, new_scale, m_new, v_new

