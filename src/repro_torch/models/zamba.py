"""Zamba2-style hybrid (the counterpart of ``repro/models/zamba.py``): a
Mamba2 backbone and a *shared* attention+FFN block applied every
``attn_every`` layers with per-site LoRA adapters.

``num_layers`` blocks form ``num_layers // attn_every`` superblocks, one
segment ``zamba``: each superblock is ``attn_every - 1`` Mamba2 blocks
stacked on an inner axis, each pre-normed with a residual, then one
invocation (a site) of the shared block on ``concat(h, x0)``, where
``x0`` is the embedding, carried unchanged through the stack (the Zamba
global residual). The shared block's weights live once, in
``params["shared_attn"]``, and ``embed`` threads them to every site as
``ctx["shared"]``; each site has its own LoRA pairs on q and o and its
``site_out``, stacked per superblock. So GaLore gives each shared matrix
one subspace, and the per-layer backward sums its gradient over the
sites (``train/stack.py``).

A superblock's cache is four leaves, each leading with the batch axis:
the inner Mamba2 stack's conv windows ``(B, n_m, K-1, conv_ch)`` (the
pool's dtype) and states ``(B, n_m, H, P, N)`` (float32), then the
site's K and V windows ``(B, max_len, KH, hd)``. Only K and V grow along
time at prefill; decode writes all four in place. A right-padded prompt
would run the states on through the pads, so the bundle prefills
unpadded prompts only (``ragged_prefill_ok`` False) and offers no
chunk-append.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers, ssm
from repro_torch.models.base import ModelBundle, SegmentDef, layer_params
from repro_torch.models.layers import dense, dense_init, embed_init, \
    ffn_apply, ffn_init, rmsnorm, rmsnorm_init
from repro_torch.models.transformer import Q_CHUNK, _draw_by_layer, \
    _map_leaves


def _lora_init(gen: torch.Generator, in_dim: int, out_dim: int, rank: int,
               lead: tuple, device) -> dict:
    """A LoRA pair: ``A`` normal / sqrt(in), ``B`` zeros."""
    a = layers.draw(torch.randn, lead + (in_dim, rank), gen, device)
    return {"A": a.div_(math.sqrt(in_dim)),
            "B": torch.zeros(lead + (rank, out_dim), dtype=torch.float32,
                             device=device)}


def _lora_apply(p, x, dtype):
    # dense streams quantized adapters (a last axis of 32 or more) through
    # the INT8 op
    return dense(dense(x, p["A"], dtype), p["B"], dtype)


def shared_block_init(gen: torch.Generator, cfg: ModelConfig,
                      device="cpu") -> dict:
    """The single shared attention+FFN block (2·d → d)."""
    d = cfg.d_model
    return {
        "fuse": dense_init(gen, 2 * d, d, device=device),
        "norm": rmsnorm_init(2 * d, device=device),
        "attn": attention.gqa_init(gen, cfg, device=device),
        "ffn_norm": rmsnorm_init(d, device=device),
        "ffn": ffn_init(gen, d, cfg.d_ff, device=device),
    }


def superblock_init(gen: torch.Generator, cfg: ModelConfig, n_m: int,
                    lead: tuple = (), device="cpu") -> dict:
    """A superblock's leaves stacked on ``lead`` (the superblock axis); the
    Mamba2 leaves carry the inner axis ``n_m`` after it."""
    hc = cfg.hybrid
    d, inner = cfg.d_model, cfg.num_heads * cfg.resolved_head_dim
    site_out = dense_init(gen, d, d, scale=0.02,
                          num=math.prod(lead) if lead else None,
                          device=device)
    return {
        "mamba_norms": torch.zeros(lead + (n_m, d), dtype=torch.float32,
                                   device=device),
        "mamba": ssm.mamba2_init(gen, cfg, lead + (n_m,), device),
        "lora_q": _lora_init(gen, d, inner, hc.shared_lora_rank, lead,
                             device),
        "lora_o": _lora_init(gen, inner, d, hc.shared_lora_rank, lead,
                             device),
        "site_out": site_out.reshape(lead + (d, d)),
    }


def _site_in(shared, h, x0, cfg: ModelConfig, dtype):
    u = rmsnorm(torch.cat([h, x0], dim=-1), shared["norm"], cfg.rmsnorm_eps)
    return dense(u, shared["fuse"], dtype)


def _site_out(shared, lp, u, o, cfg: ModelConfig, dtype):
    """``wo`` and this site's LoRA on the attention output, the FFN, and
    ``site_out``."""
    a = dense(o, shared["attn"]["wo"], dtype) \
        + _lora_apply(lp["lora_o"], o, dtype)
    u = u + a
    f = ffn_apply(shared["ffn"], rmsnorm(u, shared["ffn_norm"],
                                         cfg.rmsnorm_eps),
                  cfg.ffn_activation, dtype)
    return dense(u + f, lp["site_out"], dtype)


def _site_qkv(shared, lp, u, cfg: ModelConfig, positions, dtype):
    """q (with this site's LoRA), k, v (B, S, heads, hd) after RoPE."""
    B, S, _ = u.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    ap = shared["attn"]
    q = (dense(u, ap["wq"], dtype)
         + _lora_apply(lp["lora_q"], u, dtype)).reshape(B, S, H, hd)
    k = dense(u, ap["wk"], dtype).reshape(B, S, KH, hd)
    v = dense(u, ap["wv"], dtype).reshape(B, S, KH, hd)
    sin, cos = layers.rope_angles(positions, hd, cfg.rope_theta)
    return layers.apply_rope(q, sin, cos), layers.apply_rope(k, sin, cos), v


def _shared_site_apply(shared, lp, h, x0, positions, cfg: ModelConfig,
                       dtype, flash: bool):
    """One invocation of the shared block with this site's LoRA; returns
    its output and the site's (k, v). ``flash`` routes the causal
    attention through the flash kernel."""
    u = _site_in(shared, h, x0, cfg, dtype)
    q, k, v = _site_qkv(shared, lp, u, cfg, positions, dtype)
    B, S = u.shape[:2]
    o = attention.chunked_attention(q, k, v, causal=True, q_chunk=Q_CHUNK,
                                    flash=flash).reshape(B, S, -1)
    return _site_out(shared, lp, u, o, cfg, dtype), (k, v)


def _n_inner(cfg: ModelConfig) -> int:
    """Mamba2 blocks a superblock: all but its site."""
    return cfg.hybrid.attn_every - 1


def _mamba_layer(lp, j: int):
    return layer_params(lp["mamba"], j), layer_params(lp["mamba_norms"], j)


def superblock_apply(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                     flash: bool = False):
    h = carry["h"]
    for j in range(_n_inner(cfg)):
        mp, norm = _mamba_layer(lp, j)
        h = h + ssm.mamba2_apply(mp, rmsnorm(h, norm, cfg.rmsnorm_eps), cfg,
                                 dtype=dtype)
    site, _ = _shared_site_apply(ctx["shared"], lp, h, carry["x0"],
                                 ctx["positions"], cfg, dtype, flash)
    return {**carry, "h": h + site}


def superblock_prefill(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                       flash: bool = False):
    """The superblock over the prompt; its cache is the inner Mamba2
    windows and states stacked on axis 1 (batch-major) and the site's K
    and V, which alone grow to ``ctx["max_len"]`` along time."""
    h = carry["h"]
    caches = []
    for j in range(_n_inner(cfg)):
        mp, norm = _mamba_layer(lp, j)
        out, cache = ssm.mamba2_apply(mp, rmsnorm(h, norm, cfg.rmsnorm_eps),
                                      cfg, dtype=dtype, return_cache=True)
        h = h + out
        caches.append(cache)
    site, (k, v) = _shared_site_apply(ctx["shared"], lp, h, carry["x0"],
                                      ctx["positions"], cfg, dtype, flash)
    if "max_len" in ctx:
        pad = ctx["max_len"] - k.shape[1]
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    conv, state = (torch.stack(leaf, dim=1) for leaf in zip(*caches))
    return {**carry, "h": h + site}, (conv, state, k, v)


def superblock_decode(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype):
    """One token a row; every leaf is written in place into ``cache``
    (inner block j's window and state through the views ``[:, j]``, the
    site's K/V row at ``ctx["length"]``)."""
    h = carry["h"]
    conv, state, k_cache, v_cache = cache
    for j in range(_n_inner(cfg)):
        mp, norm = _mamba_layer(lp, j)
        out, _ = ssm.mamba2_decode(
            mp, rmsnorm(h, norm, cfg.rmsnorm_eps), cfg,
            cache=ssm.Mamba2Cache(conv[:, j], state[:, j]), dtype=dtype)
        h = h + out
    shared, length = ctx["shared"], ctx["length"]
    u = _site_in(shared, h, carry["x0"], cfg, dtype)
    q, k, v = _site_qkv(shared, lp, u, cfg, length[:, None], dtype)
    rows = torch.arange(u.shape[0], device=u.device)
    attention._write_row(k_cache, rows, length, k[:, 0])
    attention._write_row(v_cache, rows, length, v[:, 0])
    o = attention.decode_attention(q, k_cache, v_cache, length + 1)
    site = _site_out(shared, lp, u, o.reshape(u.shape[0], 1, -1), cfg, dtype)
    return {**carry, "h": h + site}, cache


def build(cfg: ModelConfig, *, device: torch.device, dtype=torch.bfloat16,
          flash_attention: bool = False) -> ModelBundle:
    """The hybrid bundle (one segment ``zamba`` of superblocks; an untied
    head). ``flash_attention`` routes each site's causal self-attention at
    prefill (and in the full-sequence forward) through the flash kernel;
    decode never takes it."""
    n_m = _n_inner(cfg)
    n_sb = cfg.num_layers // cfg.hybrid.attn_every

    def init_params(gen: torch.Generator, device_=None, leaf_fn=None,
                    by_layer: bool = False):
        """Float32 parameters drawn from ``gen`` (the JAX package's
        distributions; other numbers): the embedding, the shared block,
        the superblocks, the final norm and head. ``leaf_fn(keys, leaf)``
        maps each leaf as soon as its part is drawn; ``by_layer`` draws
        the superblocks one at a time (``transformer._draw_by_layer``),
        other numbers than the default draw."""
        dev = device if device_ is None else device_

        def fin(tree, *keys):
            return tree if leaf_fn is None else \
                _map_leaves(tree, leaf_fn, keys)

        key = "seg0_zamba"
        out = {
            "embedding": fin(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        device=dev), "embedding"),
            "shared_attn": fin(shared_block_init(gen, cfg, dev),
                               "shared_attn"),
        }
        if by_layer:
            out[key] = _draw_by_layer(
                lambda: superblock_init(gen, cfg, n_m, (), dev), n_sb,
                lambda leaf, ks: fin(leaf, key, *ks))
        else:
            out[key] = fin(superblock_init(gen, cfg, n_m, (n_sb,), dev), key)
        out["final_norm"] = fin(rmsnorm_init(cfg.d_model, device=dev),
                                "final_norm")
        out["head"] = fin(dense_init(gen, cfg.d_model, cfg.vocab_size,
                                     scale=1.0 / math.sqrt(cfg.d_model),
                                     device=dev), "head")
        return out

    def embed(params, batch):
        h = layers.embed_lookup(params["embedding"], batch["tokens"], dtype)
        B, S = h.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        carry = {"h": h, "x0": h,
                 "aux": torch.zeros((), dtype=torch.float32,
                                    device=h.device)}
        return carry, {"positions": positions,
                       "shared": params["shared_attn"]}

    def cache_shapes(batch: int, max_len: int):
        kv = ((batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim),
              None)
        return ssm.mamba2_cache_shapes(cfg, batch, (n_m,)) + (kv, kv)

    def head_logits(params, carry):
        h = rmsnorm(carry["h"][:, -1:], params["final_norm"],
                    cfg.rmsnorm_eps)
        return dense(h, params["head"], dtype)

    def head_loss(params, carry, batch):
        h = rmsnorm(carry["h"], params["final_norm"], cfg.rmsnorm_eps)
        logits = dense(h, params["head"], dtype)
        loss, metrics = layers.cross_entropy(logits[:, :-1],
                                             batch["labels"][:, 1:])
        return loss + carry["aux"], {**metrics, "ce_loss": loss}

    segment = SegmentDef(
        name="zamba", n_layers=n_sb,
        apply=functools.partial(superblock_apply, cfg=cfg, dtype=dtype,
                                flash=flash_attention),
        prefill=functools.partial(superblock_prefill, cfg=cfg, dtype=dtype,
                                  flash=flash_attention),
        decode=functools.partial(superblock_decode, cfg=cfg, dtype=dtype),
        cache_shapes=cache_shapes)
    return ModelBundle(cfg=cfg, device=torch.device(device), dtype=dtype,
                       init_params=init_params, embed=embed,
                       segments=(segment,), head_logits=head_logits,
                       head_loss=head_loss, flash_attention=flash_attention,
                       ragged_prefill_ok=False)
