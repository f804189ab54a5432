"""GQA attention with prefill and decode variants (the counterpart of the
GQA half of ``repro/models/attention.py``, qk-norm included: with
``cfg.qk_norm`` q and k are RMS-normalised over the head width before
RoPE). Layouts follow the JAX package: ``(B, S, H, hd)`` activations,
``(B, Smax, KH, hd)`` caches.

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
from typing import Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, dense, dense_init, \
    rmsnorm, rmsnorm_init, rope_angles

NEG_INF = -1e30


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
    queries are offset (``_flash_eligible``)."""
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
    ``length`` (B,) valid positions per row."""
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
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense(x, p["wq"], dtype).reshape(B, S, H, hd)
    k = dense(x, p["wk"], dtype).reshape(B, S, KH, hd)
    v = dense(x, p["wv"], dtype).reshape(B, S, KH, hd)
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
    positions."""
    k_cache, v_cache = cache
    B = x.shape[0]
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = dense(x, p["wq"], dtype).reshape(B, 1, H, hd)
    k = dense(x, p["wk"], dtype).reshape(B, 1, KH, hd)
    v = dense(x, p["wv"], dtype).reshape(B, 1, KH, hd)
    q, k = _qk_norm(p, q, k, cfg)
    sin, cos = rope_angles(length[:, None].to(torch.float32), hd,
                           cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    S = k_cache.shape[1]
    rows = torch.arange(B, device=x.device)
    pos = length.clamp(max=S - 1).long()
    keep = (length < S)[:, None, None]
    k_cache[rows, pos] = torch.where(keep, k[:, 0].to(k_cache.dtype),
                                     k_cache[rows, pos])
    v_cache[rows, pos] = torch.where(keep, v[:, 0].to(v_cache.dtype),
                                     v_cache[rows, pos])
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
    a row collide, and a masked entry writes back what its slot holds."""
    k_cache, v_cache = cache
    B, C, _ = x.shape
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
