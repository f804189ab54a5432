"""Mamba2 blocks through the chunked SSD (state-space duality) algorithm:
the counterpart of ``repro/models/ssm.py``, one group (B and C shared
across heads), as the Mamba2 paper's ``ssd_minimal_discrete``.

A full sequence runs chunkwise: the intra-chunk term as masked matmuls
over the chunk, each chunk's end state, and a Python loop over chunks
carrying the ``(b, h, p, n)`` state (the reference's ``lax.scan``).
Decode is the O(1) recurrent step (:func:`ssd_recurrent_step`).

The scan runs in float32 whatever the activation dtype; the conv window
that decode keeps is in the pool's dtype and the SSM state in float32.
Every stacked per-layer vector (``conv_w``, ``conv_b``, ``A_log``, ``D``,
``dt_bias``, the norms) is read through ``layers.materialize``, as such
leaves arrive quantized. Decode writes the new window and state into the
cache tensors it was handed, in place, as attention decode writes its
K/V row.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import dense, dense_init, materialize, \
    rmsnorm, rmsnorm_init


class Mamba2Cache(NamedTuple):
    conv: torch.Tensor      # (B, K-1, conv_channels) rolling window
    ssm: torch.Tensor       # (B, H, P, N) float32


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., L) → (..., L, L) with out[..., i, j] = sum_{j < t <= i} x_t
    (-inf above the diagonal, chosen before any ``exp``)."""
    L = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, out, torch.full((), -math.inf, dtype=x.dtype,
                                             device=x.device))


def ssd_chunked(x, A, B, C, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x (b, l, h, p), already multiplied by dt; A (b, l, h), dt·A (negative
    reals); B, C (b, l, n), one group. S is padded to the chunk with
    identity steps (A = 0: no decay; x = B = C = 0: no state update).
    Returns ``(y (b, l, h, p), final_state (b, h, p, n))``."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    l_orig = l
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        A = F.pad(A, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        l += pad
    c = l // chunk
    xr = x.reshape(b, c, chunk, h, p)
    Ar = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)       # (b,h,c,L)
    Br = B.reshape(b, c, chunk, n)
    Cr = C.reshape(b, c, chunk, n)

    A_cum = torch.cumsum(Ar, dim=-1)                         # (b,h,c,L)
    # 1. intra-chunk (diagonal blocks): (C_l · B_s) exp(segsum)_ls x_s
    Lmat = torch.exp(_segsum(Ar))                            # (b,h,c,L,L)
    scores = torch.einsum("bcln,bcsn->bcls", Cr, Br)[:, None] * Lmat
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xr)
    # 2. per-chunk end states
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # (b,h,c,L)
    states = torch.einsum("bcln,bclhp->bchpn", Br,
                          xr * decay_states.permute(0, 2, 3, 1)[..., None])
    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(A_cum[..., -1])                  # (b,h,c)
    st = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) \
        if initial_state is None else initial_state
    prev = []
    for i in range(c):
        prev.append(st)
        st = st * chunk_decay[..., i][..., None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                   # (b,c,h,p,n)
    # 4. inter-chunk contribution to the outputs
    state_decay_out = torch.exp(A_cum).permute(0, 2, 3, 1)   # (b,c,L,h)
    Y_off = torch.einsum("bcln,bchpn->bclhp", Cr, prev_states) \
        * state_decay_out[..., None]
    y = (Y_diag + Y_off).reshape(b, l, h, p)
    return y[:, :l_orig], st


def ssd_recurrent_step(state, x_t, A_t, B_t, C_t):
    """One decode step: state (b, h, p, n); x_t (b, h, p) (dt-scaled); A_t
    (b, h) (dt·A); B_t, C_t (b, n). Returns ``(y (b, h, p), new_state)``
    (new tensors)."""
    decay = torch.exp(A_t)[..., None, None]
    new_state = state * decay + torch.einsum("bhp,bn->bhpn", x_t, B_t)
    y = torch.einsum("bhpn,bn->bhp", new_state, C_t)
    return y, new_state


def ssd_reference(x, A, B, C, initial_state=None):
    """The sequential oracle of :func:`ssd_chunked` (for tests)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device) \
        if initial_state is None else initial_state
    ys = []
    for t in range(l):
        y, state = ssd_recurrent_step(state, x[:, t], A[:, t], B[:, t],
                                      C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _widths(cfg: ModelConfig):
    """``(d_inner, conv_ch, H)``: the inner width, the conv's channels
    (x, B and C) and the SSM heads."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return d_inner, d_inner + 2 * sc.state_dim, d_inner // sc.head_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig, lead: tuple = (),
                device="cpu") -> dict:
    """One Mamba2 block's float32 leaves (the JAX package's distributions;
    other numbers), stacked on ``lead`` axes. ``in_proj``'s columns are
    ordered ``[z (d_inner), xBC (conv_ch), dt (H)]``."""
    sc = cfg.ssm
    d = cfg.d_model
    d_inner, conv_ch, H = _widths(cfg)
    num = math.prod(lead) if lead else None

    def shaped(t):
        return t.reshape(lead + tuple(t.shape[1:])) if lead else t

    f32 = dict(dtype=torch.float32, device=device)
    u = layers.draw(torch.rand, lead + (H,), gen, device)
    # on the meta device the layout alone (meta clamp decomposes)
    dt_bias = torch.empty_like(u) if u.is_meta else torch.log(torch.expm1(
        torch.clamp(torch.exp(u * 3.5 - 4.6), 1e-4, 0.1)))
    return {
        "in_proj": shaped(dense_init(gen, d, d_inner + conv_ch + H, num=num,
                                     device=device)),
        "conv_w": layers.draw(torch.randn, lead + (sc.conv_kernel, conv_ch),
                              gen, device).mul_(0.1),
        "conv_b": torch.zeros(lead + (conv_ch,), **f32),
        "A_log": torch.empty_like(u) if u.is_meta else torch.log(
            torch.linspace(1.0, 16.0, H, **f32)).expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), **f32),
        "dt_bias": dt_bias,
        "ssm_norm": shaped(rmsnorm_init(d_inner, num=num, device=device)),
        "out_proj": shaped(dense_init(gen, d_inner, d,
                                      scale=1.0 / math.sqrt(d_inner),
                                      num=num, device=device)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv: x (B, S, C), w (K, C), b (C,)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = xp[:, 0: S] * w[0]
    for i in range(1, K):
        out = out + xp[:, i: i + S] * w[i]
    return out + b


def _split_proj(p, x, cfg: ModelConfig, dtype):
    d_inner, conv_ch, _ = _widths(cfg)
    zxbcdt = dense(x, p["in_proj"], dtype)
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner: d_inner + conv_ch],
            zxbcdt[..., d_inner + conv_ch:])


def _ssm_params(p, dt_raw):
    """``dt = softplus(dt_raw + dt_bias)`` and ``A = -exp(A_log)``, f32."""
    dt = F.softplus(dt_raw.to(torch.float32)
                    + materialize(p["dt_bias"], torch.float32))
    return dt, -torch.exp(materialize(p["A_log"], torch.float32))


def _out(p, y, xh, z, cfg: ModelConfig, dtype):
    """``y + x·D``, gated by ``silu(z)``, normed, and ``out_proj``."""
    B, S = z.shape[:2]
    y = y + xh * materialize(p["D"], torch.float32)[:, None]
    y = y.reshape(B, S, -1).to(dtype)
    y = rmsnorm(y * F.silu(z), p["ssm_norm"], cfg.rmsnorm_eps)
    return dense(y, p["out_proj"], dtype)


def mamba2_apply(p: dict, x, cfg: ModelConfig, *, dtype=torch.bfloat16,
                 return_cache: bool = False):
    """The full-sequence (training, prefill) block; with ``return_cache``
    also its :class:`Mamba2Cache`: the last ``K - 1`` *pre-conv* inputs
    (left-padded with zeros when S < K - 1) and the final state."""
    sc = cfg.ssm
    Bb, S, _ = x.shape
    d_inner = _widths(cfg)[0]
    z, xBC_pre, dt_raw = _split_proj(p, x, cfg, dtype)
    xBC = F.silu(_causal_conv(
        xBC_pre.to(torch.float32), materialize(p["conv_w"], torch.float32),
        materialize(p["conv_b"], torch.float32))).to(dtype)
    Bmat = xBC[..., d_inner: d_inner + sc.state_dim].to(torch.float32)
    Cmat = xBC[..., d_inner + sc.state_dim:].to(torch.float32)
    dt, A = _ssm_params(p, dt_raw)
    xh = xBC[..., :d_inner].reshape(Bb, S, -1, sc.head_dim) \
        .to(torch.float32)
    y, final = ssd_chunked(xh * dt[..., None], dt * A, Bmat, Cmat,
                           chunk=min(sc.chunk_size, S))
    out = _out(p, y, xh, z, cfg, dtype)
    if not return_cache:
        return out
    K = sc.conv_kernel
    conv = F.pad(xBC_pre, (0, 0, max(K - 1 - S, 0), 0))[:, -(K - 1):]
    return out, Mamba2Cache(conv.to(dtype), final)


def mamba2_decode(p: dict, x, cfg: ModelConfig, *, cache: Mamba2Cache,
                  dtype=torch.bfloat16):
    """One token a row (x (B, 1, d)). The rolling window and the state
    are copied into the ``cache`` tensors (views of the pool), which are
    returned."""
    sc = cfg.ssm
    Bb = x.shape[0]
    d_inner = _widths(cfg)[0]
    z, xBC_raw, dt_raw = _split_proj(p, x, cfg, dtype)
    window = torch.cat([cache.conv, xBC_raw.to(dtype)], dim=1)
    conv_out = (window.to(torch.float32)
                * materialize(p["conv_w"], torch.float32)).sum(dim=1) \
        + materialize(p["conv_b"], torch.float32)
    xBC = F.silu(conv_out).to(dtype)                         # (B, conv_ch)
    Bmat = xBC[:, d_inner: d_inner + sc.state_dim].to(torch.float32)
    Cmat = xBC[:, d_inner + sc.state_dim:].to(torch.float32)
    dt, A = _ssm_params(p, dt_raw[:, 0])
    xh = xBC[:, :d_inner].reshape(Bb, -1, sc.head_dim).to(torch.float32)
    y, new_ssm = ssd_recurrent_step(cache.ssm, xh * dt[..., None], dt * A,
                                    Bmat, Cmat)
    cache.conv.copy_(window[:, 1:])
    cache.ssm.copy_(new_ssm)
    return _out(p, y[:, None], xh[:, None], z, cfg, dtype), cache


def mamba2_cache_shapes(cfg: ModelConfig, batch: int, lead: tuple = ()):
    """A Mamba2 cache's ``(shape, dtype)`` leaves, each ``(batch,) + lead +
    ...`` (``lead``: an inner block stack): the conv window in the pool's
    dtype (None), the state float32."""
    sc = cfg.ssm
    _, conv_ch, H = _widths(cfg)
    b = (batch,) + lead
    return ((b + (sc.conv_kernel - 1, conv_ch), None),
            (b + (H, sc.head_dim, sc.state_dim), torch.float32))
