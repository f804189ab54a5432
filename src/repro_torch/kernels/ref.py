"""Plain PyTorch versions of the kernels (the counterparts of
``repro/kernels/ref.py``), and the CPU model path's dequantize-first
matmuls. Each adds one to its ``LAUNCHES`` entry per call."""
from __future__ import annotations

import math

import torch

from repro_torch.core.adam8bit import bias_correction
from repro_torch.core.quant import true_div
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
    new_scale = torch.clamp_min(true_div(wn.abs().amax(dim=-1), 127.0),
                                1e-12)
    codes = torch.floor(wn / new_scale[..., None]
                        + u01.reshape(R, C // wblock, wblock))
    q_new = torch.clamp(codes, -128, 127).reshape(R, C).to(torch.int8)
    return q_new, new_scale, m_new, v_new



def int4_matmul_ref(g: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, zero: torch.Tensor,
                    block: int) -> torch.Tensor:
    """g (M, K) @ dequant_int4(packed (K, R/2), scale/zero (K, R/block))
    → (M, R) f32: nibbles interleaved, low first, each minus 8, then
    ``(u - zero) * scale`` (``repro/kernels/ref.py::int4_matmul_ref``)."""
    LAUNCHES["int4_matmul_ref"] += 1
    lo = (packed & 0xF).to(torch.float32)
    hi = ((packed >> 4) & 0xF).to(torch.float32)
    u = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1) - 8.0
    K, R = u.shape
    w = (u.reshape(K, R // block, block) - zero[..., None]) \
        * scale[..., None]
    return g.to(torch.float32) @ w.reshape(K, R)


def sr_requant_ref(q: torch.Tensor, scale: torch.Tensor,
                   update: torch.Tensor, u01: torch.Tensor, block: int):
    """``W' = SR_quant(deq(W) + update)`` (``repro/kernels/ref.py::
    sr_requant_ref``): q (R, C) int8, scale (R, C/block), update and the
    uniforms u01 (R, C). Returns ``(q' int8, scale' f32)``."""
    LAUNCHES["sr_requant_ref"] += 1
    R, C = q.shape
    w = q.to(torch.float32).reshape(R, C // block, block) * scale[..., None]
    w = w.reshape(R, C) + update.to(torch.float32)
    wb = w.reshape(R, C // block, block)
    new_scale = torch.clamp_min(true_div(wb.abs().amax(dim=-1), 127.0),
                                1e-12)
    t = wb / new_scale[..., None]
    codes = torch.clamp(torch.floor(t + u01.reshape(R, C // block, block)),
                        -128, 127)
    return codes.reshape(R, C).to(torch.int8), new_scale


def blockwise_quant_ref(x: torch.Tensor, block: int):
    """x (R, C) → symmetric int8 codes (round half to even) and per-block
    f32 scales (``repro/kernels/ref.py::blockwise_quant_ref``)."""
    LAUNCHES["blockwise_quant_ref"] += 1
    R, C = x.shape
    xb = x.to(torch.float32).reshape(R, C // block, block)
    scale = torch.clamp_min(true_div(xb.abs().amax(dim=-1), 127.0), 1e-12)
    codes = torch.clamp(torch.round(xb / scale[..., None]), -128, 127)
    return codes.reshape(R, C).to(torch.int8), scale


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """q (B, S, H, d), k (B, S, KH, d), v (B, S, KH, dv) → (B, S, H, dv)
    f32 softmax attention (``repro/kernels/ref.py::flash_attention_ref``).
    Query head h reads kv head ``h // (H / KH)``: the kv heads are
    repeated, as ``repro/models/attention.py`` folds GQA."""
    LAUNCHES["flash_attention_ref"] += 1
    B, S, H, d = q.shape
    G = H // k.shape[2]
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
