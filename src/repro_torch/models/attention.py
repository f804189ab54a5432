"""GQA and Multi-head Latent Attention with prefill and decode variants,
and the encoder-decoder's cross-attention (the counterpart of
``repro/models/attention.py``; qk-norm included: with ``cfg.qk_norm`` q and k are RMS-normalised over the
head width before RoPE). Layouts follow the JAX package: ``(B, S, H, hd)``
activations, ``(B, Smax, KH, hd)`` GQA caches, and MLA's compressed
caches ``(B, Smax, kv_lora_rank)`` and ``(B, Smax, qk_rope_head_dim)``.

The chunked einsum path is the reference numerics (the JAX package's flash
kernel is off by default): scores for one query chunk at a time,
normalised as ``e / z`` after subtracting the row max. Chunk-append
(:func:`gqa_append`, the paged serving runtime's prefill) takes the same
arithmetic with the causal mask on absolute positions. With ``flash=True``
(a bundle built with ``flash_attention=True``) every eligible call, a full
causal self-attention such as a prefill, goes through
``kernels.ops.flash_attention`` instead, as ``REPRO_FLASH_ATTENTION=1``
routes the JAX package.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import MLAConfig, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope, dense, dense_init, \
    rmsnorm, rmsnorm_init, rope_angles

NEG_INF = -1e30
NO_POS = 2 ** 30     # the position of a key slot this rank does not hold


class HeldWindow(NamedTuple):
    """One layer's K or V window as one rank holds it when the window is
    split over ranks (``serve/shard.py``): ``local`` (R, W, KH, hd), the
    rank's keys of R rows; ``rows`` (R,) the row of the batch each local
    row belongs to; ``pos`` (R, W) the position of each local key in its
    row's window (``NO_POS`` where this rank holds no key); ``comm`` the
    ranks among which the keys are split (None: this rank holds them
    all). ``fresh`` is what the last write wrote, every row's (B, C, KH,
    hd) in ``local``'s dtype: each rank computes every row, so the pool's
    write plan takes it from there (``serve/paged.py``)."""
    local: torch.Tensor
    rows: torch.Tensor
    pos: torch.Tensor
    comm: Any
    fresh: Optional[torch.Tensor] = None


def held_write(win: HeldWindow, positions, valid, new) -> HeldWindow:
    """Write ``new`` (B, C, ...) at ``positions`` (B, C) where ``valid``
    (B, C) into the keys of ``win`` this rank holds, IN PLACE (positions
    held elsewhere write nothing here). Each local key takes the one
    chunk column aimed at it, if any, through a gather: no index is
    written twice, so the write is exact and free of collisions."""
    p, ok = positions[win.rows], valid[win.rows]
    hit = (win.pos[:, :, None] == p[:, None, :]) & ok[:, None, :]
    C = p.shape[1]
    src = (hit * torch.arange(C, device=p.device)).sum(-1)      # (R, W)
    vals = new[win.rows].to(win.local.dtype)
    tail = (1,) * (vals.ndim - 2)
    got = vals.gather(1, src.view(src.shape + tail).expand(
        src.shape + tuple(vals.shape[2:])))
    win.local.copy_(torch.where(hit.any(-1).view(src.shape + tail), got,
                                win.local))
    return win._replace(fresh=new.to(win.local.dtype))


def held_attention(q, k: HeldWindow, v: HeldWindow, allowed
                   ) -> torch.Tensor:
    """Attention of q (B, C, H, dh) over the keys split among ranks:
    ``allowed`` (R, C, W) masks each local row's keys for each query.
    Scores over the keys this rank holds, then the log-sum-exp combine
    over ``k.comm``: one all-reduce of the row max M, then one of [l, o]
    together, whose exponentials this rank takes against M (the partial
    softmax ``l·e^(m−M)``, ``o·e^(m−M)`` without its rescale). A masked
    key adds an exact 0, so a rank that holds no valid key of a row adds
    exactly zero to it."""
    B, C, H, dh = q.shape
    R, _, KH, _ = k.local.shape
    dv = v.local.shape[-1]
    G = H // KH
    rows = k.rows
    qg = (q.to(torch.float32)[rows] / math.sqrt(dh)).reshape(R, C, KH, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.local.to(torch.float32))
    s = torch.where(allowed[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    m = torch.full((B, KH, G, C), NEG_INF, device=q.device)
    m[rows] = s.amax(dim=-1)
    if k.comm is not None:
        k.comm.all_reduce_op(m, "max")
    e = torch.exp(s - m[rows][..., None])
    lo = torch.zeros((B, KH, G, C, 1 + dv), device=q.device)
    lo[rows] = torch.cat([e.sum(dim=-1, keepdim=True),
                          torch.einsum("bhgqk,bkhd->bhgqd", e,
                                       v.local.to(torch.float32))], dim=-1)
    if k.comm is not None:
        k.comm.all_reduce_sum(lo)
    o = lo[..., 1:] / lo[..., :1]                        # (B, KH, G, C, dv)
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, dv).to(q.dtype)


def _attend_dense(q, k, v, *, causal: bool, q_offset: int):
    """q (B,Sq,H,dh), k/v (B,Skv,KH,dh) — one dense block of scores; kv
    heads are shared by H // KH query heads."""
    B, Sq, H, dh = q.shape
    KH = k.shape[2]
    dv = v.shape[-1]
    G = H // KH
    qf = q.to(torch.float32) / math.sqrt(dh)
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    qg = qf.reshape(B, Sq, KH, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    if causal:
        Skv = k.shape[1]
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Skv, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", e / z, vf)
    return o.reshape(B, Sq, H, dv)


def _flash_eligible(q, k, causal: bool, q_offset: int) -> bool:
    """The flash kernel covers the self-attention core only
    (``repro/models/attention.py:61``): causal, queries aligned with keys
    (full sequence, no offset), more than one query. Decode keeps the
    chunked path. The port has no soft-cap."""
    return (causal and q_offset == 0 and q.shape[1] == k.shape[1]
            and q.shape[1] > 1 and q.shape[2] % k.shape[2] == 0)


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      q_offset: int = 0, flash: bool = False
                      ) -> torch.Tensor:
    """Attention over query chunks of ``q_chunk`` rows (scores stay
    (chunk, Skv)); one dense block when ``Sq <= q_chunk``. With ``flash``
    an eligible call goes through the flash kernel (GQA native)."""
    if flash and _flash_eligible(q, k, causal, q_offset):
        return kops.flash_attention(q, k, v, causal=True).to(q.dtype)
    Sq = q.shape[1]
    if Sq <= q_chunk:
        return _attend_dense(q, k, v, causal=causal,
                             q_offset=q_offset).to(q.dtype)
    outs = [_attend_dense(q[:, i: i + q_chunk], k, v, causal=causal,
                          q_offset=q_offset + i)
            for i in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).to(q.dtype)


def append_attention(q, k_cache, v_cache, q_positions) -> torch.Tensor:
    """Chunk-append attention: C queries at absolute positions
    ``q_positions`` (B, C) against a (B, Smax, KH, dh) cache that already
    holds every position ``<= q_positions`` (this chunk's K/V included).

    :func:`_attend_dense` op for op (the same einsums, max, exp, sum and
    ``e / z``) with the causal mask taken against absolute positions:
    masked keys add an exact 0 to the sums. Never the flash kernel: the
    queries are offset (``_flash_eligible``). A :class:`HeldWindow` cache
    (a window split over ranks) goes through :func:`held_attention`."""
    if isinstance(k_cache, HeldWindow):
        allowed = k_cache.pos[:, None, :] <= \
            q_positions[k_cache.rows][:, :, None]
        return held_attention(q, k_cache, v_cache, allowed)
    B, C, H, dh = q.shape
    KH = k_cache.shape[2]
    dv = v_cache.shape[-1]
    G = H // KH
    qf = q.to(torch.float32) / math.sqrt(dh)
    kf = k_cache.to(torch.float32)
    vf = v_cache.to(torch.float32)
    qg = qf.reshape(B, C, KH, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf)
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    mask = kpos[None, None] <= q_positions[:, :, None]        # (B, C, Skv)
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    z = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", e / z, vf)
    return o.reshape(B, C, H, dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, length) -> torch.Tensor:
    """Single-token decode: q (B,1,H,dh) against a (B,S,KH,dh) cache with
    ``length`` (B,) valid positions per row; a :class:`HeldWindow` cache
    through :func:`held_attention`."""
    if isinstance(k_cache, HeldWindow):
        allowed = k_cache.pos < length[k_cache.rows][:, None]
        return held_attention(q, k_cache, v_cache, allowed[:, None])
    B, _, H, dh = q.shape
    KH = k_cache.shape[2]
    G = H // KH
    qf = q.to(torch.float32) / math.sqrt(dh)
    qg = qf.reshape(B, KH, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.to(torch.float32))
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None] < length[:, None]              # (B, S)
    s = torch.where(mask[:, None, None], s,
                    torch.full((), NEG_INF, device=q.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", w, v_cache.to(torch.float32))
    return o.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def _write_row(cache, rows, length, new) -> None:
    """Write ``new`` (B, ...) at position ``length`` of each row of
    ``cache`` (B, Smax, ...) IN PLACE; rows with ``length >= Smax`` write
    nothing (the JAX package's one-hot blend)."""
    S = cache.shape[1]
    pos = length.clamp(max=S - 1).long()
    keep = (length < S).reshape((-1,) + (1,) * (new.ndim - 1))
    cache[rows, pos] = torch.where(keep, new.to(cache.dtype),
                                   cache[rows, pos])


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg: ModelConfig, *,
             num: Optional[int] = None, device="cpu") -> dict:
    d, H, KH = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, H * hd, num=num, device=device),
        "wk": dense_init(gen, d, KH * hd, num=num, device=device),
        "wv": dense_init(gen, d, KH * hd, num=num, device=device),
        "wo": dense_init(gen, H * hd, d, scale=1.0 / math.sqrt(H * hd),
                         num=num, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, num=num, device=device)
        p["k_norm"] = rmsnorm_init(hd, num=num, device=device)
    return p


def _qk_norm(p, q, k, cfg: ModelConfig):
    if not cfg.qk_norm:
        return q, k
    return (rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps),
            rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps))


def _qkv(p, x, cfg: ModelConfig, positions, dtype):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    # -1: a tensor-parallel rank holds H/t query and KH/t KV heads
    q = dense(x, p["wq"], dtype).reshape(B, S, -1, hd)
    k = dense(x, p["wk"], dtype).reshape(B, S, -1, hd)
    v = dense(x, p["wv"], dtype).reshape(B, S, -1, hd)
    q, k = _qk_norm(p, q, k, cfg)
    sin, cos = rope_angles(positions, hd, cfg.rope_theta)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def gqa_apply(p: dict, x, cfg: ModelConfig, *, positions,
              causal: bool = True, q_chunk: int = 1024,
              dtype=torch.bfloat16, flash: bool = False) -> torch.Tensor:
    """Full-sequence attention."""
    q, k, v = _qkv(p, x, cfg, positions, dtype)
    o = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                          flash=flash)
    B, S = x.shape[:2]
    return dense(o.reshape(B, S, -1), p["wo"], dtype)


def gqa_prefill(p, x, cfg: ModelConfig, *, positions, q_chunk=1024,
                dtype=torch.bfloat16, flash: bool = False):
    """Like :func:`gqa_apply`, and also returns the (k, v) of the prompt."""
    q, k, v = _qkv(p, x, cfg, positions, dtype)
    o = chunked_attention(q, k, v, causal=True, q_chunk=q_chunk,
                          flash=flash)
    B, S = x.shape[:2]
    return dense(o.reshape(B, S, -1), p["wo"], dtype), (k, v)


def gqa_decode(p, x, cfg: ModelConfig, *, cache: Tuple, length,
               dtype=torch.bfloat16):
    """x (B,1,D); cache (k, v) each (B,Smax,KH,hd); length (B,).

    Writes the new token's K/V at position ``length`` of each row IN PLACE
    in the cache tensors (rows with ``length >= Smax`` write nothing, as
    the JAX package's one-hot blend), then attends over ``length + 1``
    positions. A :class:`HeldWindow` cache (split over ranks) takes the
    write where this rank holds the position (:func:`held_write`)."""
    k_cache, v_cache = cache
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    # -1: a tensor-parallel rank holds H/t query and KH/t KV heads
    q = dense(x, p["wq"], dtype).reshape(B, 1, -1, hd)
    k = dense(x, p["wk"], dtype).reshape(B, 1, -1, hd)
    v = dense(x, p["wv"], dtype).reshape(B, 1, -1, hd)
    q, k = _qk_norm(p, q, k, cfg)
    sin, cos = rope_angles(length[:, None].to(torch.float32), hd,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    if isinstance(k_cache, HeldWindow):
        at = length[:, None]
        ok = torch.ones(at.shape, dtype=torch.bool, device=x.device)
        k_cache = held_write(k_cache, at, ok, k)
        v_cache = held_write(v_cache, at, ok, v)
    else:
        rows = torch.arange(B, device=x.device)
        _write_row(k_cache, rows, length, k[:, 0])
        _write_row(v_cache, rows, length, v[:, 0])
    o = decode_attention(q, k_cache, v_cache, length + 1)
    return dense(o.reshape(B, 1, -1), p["wo"], dtype), (k_cache, v_cache)


def gqa_append(p, x, cfg: ModelConfig, *, cache: Tuple, positions, mask,
               dtype=torch.bfloat16):
    """Chunk-append: x (B,C,D) holds the next C prompt tokens at absolute
    ``positions`` (B,C); ``mask`` (B,C) marks the valid (not padded-tail)
    tokens. Valid tokens write their K/V at their position of the cache
    IN PLACE; padded tail positions write nothing. Queries attend the
    whole cache under the absolute causal mask (:func:`append_attention`).

    The write is one ``index_put`` per cache at ``positions % Smax``: C
    consecutive positions stay distinct modulo Smax, so no two entries of
    a row collide, and a masked entry writes back what its slot holds. A
    :class:`HeldWindow` cache takes :func:`held_write`."""
    k_cache, v_cache = cache
    B, C, _ = x.shape
    if isinstance(k_cache, HeldWindow):
        q, k, v = _qkv(p, x, cfg, positions, dtype)
        k_cache = held_write(k_cache, positions, mask, k)
        v_cache = held_write(v_cache, positions, mask, v)
        o = append_attention(q, k_cache, v_cache, positions)
        return dense(o.reshape(B, C, -1), p["wo"], dtype), (k_cache, v_cache)
    S = k_cache.shape[1]
    if C > S:
        raise ValueError(f"append chunk {C} wider than the cache ({S})")
    q, k, v = _qkv(p, x, cfg, positions, dtype)
    rows = torch.arange(B, device=x.device)[:, None]
    pos = positions.long() % S
    keep = mask[..., None, None]
    k_cache[rows, pos] = torch.where(keep, k.to(k_cache.dtype),
                                     k_cache[rows, pos])
    v_cache[rows, pos] = torch.where(keep, v.to(v_cache.dtype),
                                     v_cache[rows, pos])
    o = append_attention(q, k_cache, v_cache, positions)
    return dense(o.reshape(B, C, -1), p["wo"], dtype), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_apply(p: dict, x, memory, cfg: ModelConfig,
                dtype=torch.bfloat16) -> torch.Tensor:
    """Decoder cross-attention over the encoder's ``memory`` (B, Sm, D):
    q from ``x`` (B, S, D), k and v from ``memory``, no mask and no RoPE.
    K and V are computed anew at every call (a decode step too), as the
    JAX package does; a non-causal call never takes the flash kernel."""
    B, S, _ = x.shape
    Sm = memory.shape[1]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense(x, p["wq"], dtype).reshape(B, S, H, hd)
    k = dense(memory, p["wk"], dtype).reshape(B, Sm, KH, hd)
    v = dense(memory, p["wv"], dtype).reshape(B, Sm, KH, hd)
    o = chunked_attention(q, k, v, causal=False)
    return dense(o.reshape(B, S, -1), p["wo"], dtype)


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V3)
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg: ModelConfig, *,
             num: Optional[int] = None, device="cpu") -> dict:
    """The low-rank query path (``wq_a``, ``q_a_norm``, ``wq_b``), the
    compressed KV latent with its shared RoPE key (``wkv_a``,
    ``kv_a_norm``), its up-projection ``wkv_b`` and ``wo``; ``num``
    stacks a layer axis in front."""
    m: MLAConfig = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq_a": dense_init(gen, d, m.q_lora_rank, num=num, device=device),
        "q_a_norm": rmsnorm_init(m.q_lora_rank, num=num, device=device),
        "wq_b": dense_init(gen, m.q_lora_rank, H * qk, num=num,
                           device=device),
        "wkv_a": dense_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                            num=num, device=device),
        "kv_a_norm": rmsnorm_init(m.kv_lora_rank, num=num, device=device),
        "wkv_b": dense_init(gen, m.kv_lora_rank,
                            H * (m.qk_nope_head_dim + m.v_head_dim),
                            num=num, device=device),
        "wo": dense_init(gen, H * m.v_head_dim, d,
                         scale=1.0 / math.sqrt(H * m.v_head_dim), num=num,
                         device=device),
    }


def _mla_qkv(p, x, cfg: ModelConfig, positions, dtype):
    """(q_nope, q_rope (B,S,H,·), c_kv (B,S,kv_lora), k_rope (B,S,1,rope)):
    queries through the normed low-rank bottleneck, the normed KV latent,
    RoPE on q_rope and on the one key head all query heads share."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_c = rmsnorm(dense(x, p["wq_a"], dtype), p["q_a_norm"], cfg.rmsnorm_eps)
    q = dense(q_c, p["wq_b"], dtype).reshape(
        B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    kv_a = dense(x, p["wkv_a"], dtype)
    c_kv, k_rope = kv_a.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = rmsnorm(c_kv, p["kv_a_norm"], cfg.rmsnorm_eps)
    sin, cos = rope_angles(positions, m.qk_rope_head_dim, cfg.rope_theta)
    return (q_nope, apply_rope(q_rope, sin, cos), c_kv,
            apply_rope(k_rope[:, :, None, :], sin, cos))


def _mla_expand_kv(p, c_kv, cfg: ModelConfig, dtype):
    """The latent's up-projection, split into (k_nope, v)."""
    m: MLAConfig = cfg.mla
    B, S, _ = c_kv.shape
    kv = dense(c_kv, p["wkv_b"], dtype).reshape(
        B, S, cfg.num_heads, m.qk_nope_head_dim + m.v_head_dim)
    return kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)


def _mla_attend(p, x, cfg: ModelConfig, positions, q_chunk, dtype):
    """Full-sequence MLA: q = [q_nope; q_rope], k = [k_nope; k_rope] with
    the rope key broadcast to every head (qk width nope + rope, v width
    v_head_dim) through :func:`chunked_attention`, then ``wo``. Returns
    the output and the compressed cache (c_kv, k_rope (B,S,rope))."""
    m: MLAConfig = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions, dtype)
    k_nope, v = _mla_expand_kv(p, c_kv, cfg, dtype)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, cfg.num_heads,
                                         m.qk_rope_head_dim)], dim=-1)
    o = chunked_attention(q, k, v, causal=True, q_chunk=q_chunk)
    return dense(o.reshape(B, S, -1), p["wo"], dtype), (c_kv, k_rope[:, :, 0])


def mla_apply(p: dict, x, cfg: ModelConfig, *, positions,
              q_chunk: int = 1024, dtype=torch.bfloat16) -> torch.Tensor:
    """Full-sequence MLA (never the flash kernel: its qk width is refused
    by ``model_zoo.build``)."""
    return _mla_attend(p, x, cfg, positions, q_chunk, dtype)[0]


def mla_prefill(p, x, cfg: ModelConfig, *, positions, q_chunk=1024,
                dtype=torch.bfloat16):
    """Like :func:`mla_apply`, and also returns the compressed cache
    ``(c_kv (B,S,kv_lora), k_rope (B,S,rope))``, the memory-defining
    feature of MLA."""
    return _mla_attend(p, x, cfg, positions, q_chunk, dtype)


def mla_decode(p, x, cfg: ModelConfig, *, cache: Tuple, length,
               dtype=torch.bfloat16):
    """x (B,1,D); cache ``(c_kv (B,Smax,kv_lora), k_rope (B,Smax,rope))``;
    length (B,). The absorbed form: ``W_uk`` is folded into the query and
    ``W_uv`` into the read-out, so attention runs over the latents and
    the (B,S,H,·) keys and values never exist.

    Writes the new latent and rope key at position ``length`` IN PLACE
    (rows with ``length >= Smax`` write nothing, as the JAX package's
    one-hot blend). ``wkv_b`` is materialized in the activation dtype
    (the one dequantization of the decode path, as in the reference);
    ``q_abs`` is rounded to that dtype before the float32 scores, scaled
    by 1/sqrt(nope + rope)."""
    m: MLAConfig = cfg.mla
    c_cache, r_cache = cache
    B = x.shape[0]
    H = cfg.num_heads
    q_nope, q_rope, c_new, r_new = _mla_qkv(
        p, x, cfg, length[:, None].to(torch.float32), dtype)
    rows = torch.arange(B, device=x.device)
    _write_row(c_cache, rows, length, c_new[:, 0])
    _write_row(r_cache, rows, length, r_new[:, 0, 0])
    w_ukv = layers.materialize(p["wkv_b"], dtype).reshape(
        m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = w_ukv[..., : m.qk_nope_head_dim]          # (rank, H, nope)
    w_uv = w_ukv[..., m.qk_nope_head_dim:]           # (rank, H, v)
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, w_uk)[:, 0]  # (B,H,rank)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    cf = c_cache.to(torch.float32)
    s = (torch.einsum("bhr,bkr->bhk", q_abs.to(torch.float32), cf)
         + torch.einsum("bshr,bkr->bhk", q_rope.to(torch.float32),
                        r_cache.to(torch.float32))) * scale
    kpos = torch.arange(c_cache.shape[1], device=x.device)
    s = torch.where(kpos[None, None] < (length + 1)[:, None, None], s,
                    torch.full((), NEG_INF, device=x.device))
    w = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhk,bkr->bhr", w, cf)                    # (B,H,rank)
    o = torch.einsum("bhr,rhv->bhv", ctx, w_uv.to(torch.float32))
    o = o.reshape(B, 1, H * m.v_head_dim).to(dtype)
    return dense(o, p["wo"], dtype), (c_cache, r_cache)


def mla_cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    m: MLAConfig = cfg.mla
    return ((batch, max_len, m.kv_lora_rank),
            (batch, max_len, m.qk_rope_head_dim))
