"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory with recurrent mixing, a loop over time): the counterpart
of ``repro/models/xlstm.py``.

mLSTM recurrence (per head, stabilized with a running max ``m``)::

    C_t = f_t C_{t-1} + i_t v_t k_t^T        n_t = f_t n_{t-1} + i_t k_t
    h_t = (C_t q̃_t) / max(|n_t·q̃_t|, exp(-m_t))      q̃ = q / sqrt(d)

with an exponential input gate and a sigmoid forget gate in log space.
A full sequence runs chunkwise: the intra-chunk term as attention-like
matmuls, and a loop over chunks carrying the (C, n, m) state. Decode
runs one step (:func:`mlstm_step`).

The sLSTM's recurrent weights mix the previous hidden state into the
gates, so it runs step by step over time (:func:`slstm_scan`).

All recurrent arithmetic is float32 and the states are float32 whatever
the activation dtype. Every weight goes through ``layers.dense`` or
``layers.materialize`` (stacked per-layer vectors arrive quantized).
Decode writes the new state into the cache tensors it was handed, in
place, as attention decode writes its K/V row.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.quant import true_div
from repro_torch.models import layers
from repro_torch.models.layers import dense, dense_init, ffn_apply, \
    ffn_init, materialize, rmsnorm, rmsnorm_init

NEG = -1e30          # the empty state's stabilizer; a padded step's log i


class MLSTMState(NamedTuple):
    C: torch.Tensor      # (B, H, d, d)
    n: torch.Tensor      # (B, H, d)
    m: torch.Tensor      # (B, H) log-stabilizer


class SLSTMState(NamedTuple):
    c: torch.Tensor      # (B, D)
    n: torch.Tensor      # (B, D)
    h: torch.Tensor      # (B, D)
    m: torch.Tensor      # (B, D)


# ---------------------------------------------------------------------------
# mLSTM core
# ---------------------------------------------------------------------------

def mlstm_chunked(q, k, v, logi, logf, chunk: int,
                  initial: Optional[MLSTMState] = None):
    """q, k, v (B, S, H, d); logi, logf (B, S, H) float32. Returns ``(h (B,
    S, H, d) in q's dtype, final MLSTMState)``. S is padded to the chunk
    with steps that neither write (log i = -1e30) nor decay (log f = 0).
    The stabilizers' maxima are ``amax`` and ``torch.maximum``, which
    split the gradient among tied maxima as the reference's do."""
    B, S, H, d = q.shape
    f32 = torch.float32
    pad = (-S) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        logi = F.pad(logi, (0, 0, 0, pad), value=NEG)
        logf = F.pad(logf, (0, 0, 0, pad))
    nc = q.shape[1] // chunk
    qc = true_div(q.reshape(B, nc, chunk, H, d).to(f32), math.sqrt(d))
    kc = k.reshape(B, nc, chunk, H, d).to(f32)
    vc = v.reshape(B, nc, chunk, H, d).to(f32)
    li = logi.reshape(B, nc, chunk, H).permute(0, 3, 1, 2)     # (B,H,c,L)
    lf = logf.reshape(B, nc, chunk, H).permute(0, 3, 1, 2)
    b_cum = torch.cumsum(lf, dim=-1)

    if initial is None:
        C = torch.zeros((B, H, d, d), dtype=f32, device=q.device)
        n = torch.zeros((B, H, d), dtype=f32, device=q.device)
        m_prev = torch.full((B, H), NEG, dtype=f32, device=q.device)
    else:
        C, n, m_prev = initial

    # intra-chunk log-decay D[t, s] = b_t - b_s + logi_s (s <= t)
    Dlog = b_cum[..., :, None] - b_cum[..., None, :] + li[..., None, :]
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=q.device).tril()
    Dlog = torch.where(tri, Dlog, torch.full((), -math.inf, dtype=f32,
                                             device=q.device))
    m_intra = Dlog.amax(dim=-1)                                 # (B,H,c,L)

    hs = []
    for idx in range(nc):
        dl = Dlog[:, :, idx]                                    # (B,H,L,L)
        bc = b_cum[:, :, idx]                                   # (B,H,L)
        lc = li[:, :, idx]
        m_inter = m_prev[..., None] + bc
        m_t = torch.maximum(m_intra[:, :, idx], m_inter)
        m_t = torch.maximum(m_t, torch.full((), NEG, dtype=f32,
                                            device=q.device))
        dexp = torch.exp(dl - m_t[..., None])
        qi, ki, vi = qc[:, idx], kc[:, idx], vc[:, idx]         # (B,L,H,d)
        s = torch.einsum("blhd,bshd->bhls", qi, ki) * dexp
        carry_w = torch.exp(m_inter - m_t)                      # (B,H,L)
        numer = torch.einsum("bhls,bshd->blhd", s, vi) \
            + carry_w.transpose(1, 2)[..., None] \
            * torch.einsum("blhd,bhde->blhe", qi, C)
        denom = s.sum(dim=-1) + carry_w * torch.einsum("blhd,bhd->bhl",
                                                       qi, n)
        floor = torch.maximum(denom.abs(), torch.exp(-m_t))
        hs.append(numer / floor.transpose(1, 2)[..., None])
        # the state brought to the chunk's end
        bL = bc[..., -1]                                        # (B,H)
        to_end = bL[..., None] - bc + lc                        # (B,H,L)
        m_new = torch.maximum(m_prev + bL, to_end.amax(dim=-1))
        decay_in = torch.exp(to_end - m_new[..., None])
        keep = torch.exp(m_prev + bL - m_new)
        C = keep[..., None, None] * C + torch.einsum(
            "bhl,blhd,blhe->bhde", decay_in, ki, vi)
        n = keep[..., None] * n + torch.einsum("bhl,blhd->bhd", decay_in,
                                               ki)
        m_prev = m_new
    h = torch.cat(hs, dim=1)[:, :S]
    return h.to(q.dtype), MLSTMState(C, n, m_prev)


def mlstm_step(state: MLSTMState, q, k, v, logi, logf):
    """One decode step: q, k, v (B, H, d); logi, logf (B, H). Returns
    ``(h in q's dtype, new MLSTMState)`` (new tensors)."""
    C, n, m_prev = state
    f32 = torch.float32
    qf = true_div(q.to(f32), math.sqrt(q.shape[-1]))
    kf, vf = k.to(f32), v.to(f32)
    m_t = torch.maximum(logf + m_prev, logi)
    f_ = torch.exp(logf + m_prev - m_t)
    i_ = torch.exp(logi - m_t)
    C_new = f_[..., None, None] * C \
        + i_[..., None, None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n_new = f_[..., None] * n + i_[..., None] * kf
    numer = torch.einsum("bhd,bhde->bhe", qf, C_new)
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                          torch.exp(-m_t))
    return (numer / denom[..., None]).to(q.dtype), \
        MLSTMState(C_new, n_new, m_t)


def mlstm_reference(q, k, v, logi, logf, initial=None):
    """The sequential oracle of :func:`mlstm_chunked`."""
    B, S, H, d = q.shape
    f32 = torch.float32
    state = initial or MLSTMState(
        torch.zeros((B, H, d, d), dtype=f32, device=q.device),
        torch.zeros((B, H, d), dtype=f32, device=q.device),
        torch.full((B, H), NEG, dtype=f32, device=q.device))
    hs = []
    for t in range(S):
        h, state = mlstm_step(state, q[:, t], k[:, t], v[:, t],
                              logi[:, t], logf[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), state


# ---------------------------------------------------------------------------
# sLSTM core
# ---------------------------------------------------------------------------

def slstm_scan(gates_x, R, state: SLSTMState, num_heads: int):
    """gates_x (B, S, 4D) the input's pre-activations; R (4, H, dh, dh)
    block-diagonal recurrent weights; gate order ``[i, f, z, o]``
    interleaved along the last axis. Returns ``(h (B, S, D) float32,
    final SLSTMState)``."""
    B, S, D4 = gates_x.shape
    D = D4 // 4
    gx = gates_x.to(torch.float32).reshape(B, S, D, 4)
    one = torch.ones((), dtype=torch.float32, device=gx.device)
    # a state held in another dtype computes in float32, as the
    # reference's type promotion does
    c, n, h, m = (t.to(torch.float32) for t in state)
    hs = []
    for t in range(S):
        # all four gates' recurrent terms in one contraction, (B, D, 4)
        rec = torch.einsum("bhd,ghde->bheg",
                           h.reshape(B, num_heads, -1), R).reshape(B, D, 4)
        it, ft, zt, ot = (gx[:, t] + rec).unbind(-1)
        m_new = torch.maximum(ft + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(ft + m - m_new)
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        h = torch.sigmoid(ot) * c / torch.maximum(n, one)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), SLSTMState(c, n, h, m)


def slstm_init_state(batch: int, d: int, device="cpu") -> SLSTMState:
    z = torch.zeros((batch, d), dtype=torch.float32, device=device)
    return SLSTMState(z, z, z, torch.full((batch, d), NEG,
                                          dtype=torch.float32,
                                          device=device))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _lead(t: torch.Tensor, lead: tuple) -> torch.Tensor:
    """A drawn stack of ``prod(lead)`` layers as ``lead + shape``."""
    return t.reshape(lead + tuple(t.shape[1:])) if lead else t


def _num(lead: tuple):
    return math.prod(lead) if lead else None


def mlstm_inner(cfg: ModelConfig) -> int:
    return int(cfg.xlstm.proj_factor * cfg.d_model)


def mlstm_block_init(gen: torch.Generator, cfg: ModelConfig,
                     lead: tuple = (), device="cpu") -> dict:
    """One mLSTM block's float32 leaves, stacked on ``lead`` axes."""
    d, H = cfg.d_model, cfg.num_heads
    inner = mlstm_inner(cfg)
    n = _num(lead)

    def w(i, o, scale=None):
        return _lead(dense_init(gen, i, o, scale, num=n, device=device),
                     lead)

    bias = torch.cat([torch.zeros(H), torch.linspace(3.0, 6.0, H)]) \
        .to(device=device, dtype=torch.float32)
    return {
        "norm": _lead(rmsnorm_init(d, num=n, device=device), lead),
        "w_up": w(d, 2 * inner),
        "wq": w(inner, inner),
        "wk": w(inner, inner),
        "wv": w(inner, inner),
        "w_gates": w(inner, 2 * H, 0.02),
        "gate_bias": bias.expand(lead + (2 * H,)).clone(),
        "out_norm": _lead(rmsnorm_init(inner, num=n, device=device), lead),
        "w_down": w(inner, d, 1.0 / math.sqrt(inner)),
    }


def _mlstm_qkvg(p, u, cfg: ModelConfig, dtype):
    B, S, inner = u.shape
    H = cfg.num_heads
    dh = inner // H
    q = dense(u, p["wq"], dtype).reshape(B, S, H, dh)
    k = dense(u, p["wk"], dtype).reshape(B, S, H, dh)
    v = dense(u, p["wv"], dtype).reshape(B, S, H, dh)
    gates = dense(u, p["w_gates"], torch.float32) \
        + materialize(p["gate_bias"], torch.float32)
    return q, k, v, gates[..., :H], F.logsigmoid(gates[..., H:])


def _mlstm_out(p, x, h, u_g, cfg: ModelConfig, dtype):
    h = rmsnorm(h, p["out_norm"], cfg.rmsnorm_eps) * F.silu(u_g)
    return x + dense(h, p["w_down"], dtype)


def mlstm_block_apply(p, x, cfg: ModelConfig, *, dtype=torch.bfloat16,
                      cache: Optional[MLSTMState] = None,
                      return_cache: bool = False):
    B, S, _ = x.shape
    u = dense(rmsnorm(x, p["norm"], cfg.rmsnorm_eps), p["w_up"], dtype)
    inner = u.shape[-1] // 2
    q, k, v, logi, logf = _mlstm_qkvg(p, u[..., :inner], cfg, dtype)
    h, final = mlstm_chunked(q, k, v, logi, logf,
                             chunk=min(cfg.xlstm.chunk_size, max(S, 2)),
                             initial=cache)
    out = _mlstm_out(p, x, h.reshape(B, S, inner), u[..., inner:], cfg,
                     dtype)
    return (out, final) if return_cache else out


def mlstm_block_decode(p, x, cfg: ModelConfig, *, cache: MLSTMState,
                       dtype=torch.bfloat16):
    """One token a row (x (B, 1, d)); the new state is copied into the
    ``cache`` tensors (views of the pool), which are returned."""
    B = x.shape[0]
    u = dense(rmsnorm(x, p["norm"], cfg.rmsnorm_eps), p["w_up"], dtype)
    inner = u.shape[-1] // 2
    q, k, v, logi, logf = _mlstm_qkvg(p, u[..., :inner], cfg, dtype)
    h, new = mlstm_step(cache, q[:, 0], k[:, 0], v[:, 0], logi[:, 0],
                        logf[:, 0])
    for dst, src in zip(cache, new):
        dst.copy_(src)
    return _mlstm_out(p, x, h.reshape(B, 1, inner), u[..., inner:], cfg,
                      dtype), cache


def slstm_ffn_width(d: int) -> int:
    return int(4 * d / 3 / 64) * 64 or 4 * d // 3


def slstm_block_init(gen: torch.Generator, cfg: ModelConfig,
                     lead: tuple = (), device="cpu") -> dict:
    """One sLSTM block's float32 leaves, stacked on ``lead`` axes."""
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    n = _num(lead)
    r = layers.draw(torch.randn, lead + (4, H, dh, dh), gen, device)
    return {
        "norm": _lead(rmsnorm_init(d, num=n, device=device), lead),
        "w_gates": _lead(dense_init(gen, d, 4 * d, num=n, device=device),
                         lead),
        "r_gates": true_div(r, math.sqrt(dh)),
        "gate_bias": torch.zeros(lead + (4 * d,), dtype=torch.float32,
                                 device=device),
        "out_norm": _lead(rmsnorm_init(d, num=n, device=device), lead),
        "ffn": {k: _lead(t, lead) for k, t in ffn_init(
            gen, d, slstm_ffn_width(d), num=n, device=device).items()},
        "ffn_norm": _lead(rmsnorm_init(d, num=n, device=device), lead),
    }


def slstm_block_apply(p, x, cfg: ModelConfig, *, dtype=torch.bfloat16,
                      cache: Optional[SLSTMState] = None,
                      return_cache: bool = False):
    B, S, d = x.shape
    u = rmsnorm(x, p["norm"], cfg.rmsnorm_eps)
    gx = dense(u, p["w_gates"], torch.float32) \
        + materialize(p["gate_bias"], torch.float32)
    st = cache if cache is not None else slstm_init_state(B, d, x.device)
    hs, final = slstm_scan(gx, materialize(p["r_gates"], torch.float32), st,
                           cfg.num_heads)
    y = x + rmsnorm(hs.to(dtype), p["out_norm"], cfg.rmsnorm_eps)
    y = y + ffn_apply(p["ffn"], rmsnorm(y, p["ffn_norm"], cfg.rmsnorm_eps),
                      cfg.ffn_activation, dtype)
    return (y, final) if return_cache else y


def slstm_block_decode(p, x, cfg: ModelConfig, *, cache: SLSTMState,
                       dtype=torch.bfloat16):
    """The block at S = 1 from ``cache``; the new state is copied into the
    ``cache`` tensors, which are returned."""
    y, final = slstm_block_apply(p, x, cfg, dtype=dtype, cache=cache,
                                 return_cache=True)
    for dst, src in zip(cache, final):
        dst.copy_(src)
    return y, cache


def mlstm_cache_shapes(cfg: ModelConfig, batch: int, lead: tuple = ()):
    """An mLSTM state's ``(shape, float32)`` leaves C, n, m, each
    ``(batch,) + lead + ...`` (``lead``: an inner block stack)."""
    H = cfg.num_heads
    dh = mlstm_inner(cfg) // H
    b = (batch,) + lead
    return tuple((s, torch.float32) for s in (b + (H, dh, dh), b + (H, dh),
                                               b + (H,)))


def slstm_cache_shapes(cfg: ModelConfig, batch: int):
    """An sLSTM state's ``(shape, float32)`` leaves c, n, h, m."""
    return (((batch, cfg.d_model), torch.float32),) * 4
