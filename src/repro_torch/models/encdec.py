"""Encoder-decoder (the seamless-m4t-medium backbone; the counterpart of
``repro/models/encdec.py``).

The audio frontend is a stub, as in the JAX package: the batch carries
precomputed frame embeddings ``frames`` (B, S_enc, d), which ``embed``
casts to the activation dtype and normalises with ``frame_norm``. The
decoder's tokens are ``max(S_enc // DEC_RATIO, 16)`` long in training
(the bundle's ``input_specs``).

Two segments. ``encoder``: non-causal self-attention and the FFN, run by
``apply`` alone (serving keeps no cache for it). ``decoder``: causal
self-attention, cross-attention on ``carry["memory"]`` and the FFN, with
prefill (its K/V grown to the window) and decode. The decoder's ``pre``
is the bridge: ``memory = rmsnorm(h, enc_final_norm)`` and ``h = dec_h``,
the decoder's token embeddings, which the carry holds unchanged through
the encoder. Prefill keeps ``memory`` in ``DecodeState.extras``
(``decode_extras``), and a decode step embeds its tokens through
``embed_decode`` beside it: cross-attention computes K and V from the
memory anew at every step, in every layer, as the JAX package does. The
bundle takes no padded prompts, no chunk-append and no slot or paged pool
(``generate`` serves it).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.base import ModelBundle, SegmentDef
from repro_torch.models.layers import dense, dense_init, embed_init, \
    ffn_apply, ffn_init, rmsnorm, rmsnorm_init
from repro_torch.models.transformer import Q_CHUNK, _draw_by_layer, \
    _map_leaves

DEC_RATIO = 4      # decoder length = frames // DEC_RATIO in training


def enc_block_init(gen: torch.Generator, cfg: ModelConfig, num=None,
                   device="cpu") -> dict:
    d = cfg.d_model
    return {
        "attn_norm": rmsnorm_init(d, num=num, device=device),
        "attn": attention.gqa_init(gen, cfg, num=num, device=device),
        "ffn_norm": rmsnorm_init(d, num=num, device=device),
        "ffn": ffn_init(gen, d, cfg.d_ff, num=num, device=device),
    }


def dec_block_init(gen: torch.Generator, cfg: ModelConfig, num=None,
                   device="cpu") -> dict:
    d = cfg.d_model
    return {
        "self_norm": rmsnorm_init(d, num=num, device=device),
        "self_attn": attention.gqa_init(gen, cfg, num=num, device=device),
        "cross_norm": rmsnorm_init(d, num=num, device=device),
        "cross_attn": attention.gqa_init(gen, cfg, num=num, device=device),
        "ffn_norm": rmsnorm_init(d, num=num, device=device),
        "ffn": ffn_init(gen, d, cfg.d_ff, num=num, device=device),
    }


def _cross_ffn(lp, h, memory, cfg: ModelConfig, dtype):
    """The decoder block after its self-attention: cross-attention on the
    memory, then the FFN, each pre-normed with a residual."""
    h = h + attention.cross_apply(
        lp["cross_attn"], rmsnorm(h, lp["cross_norm"], cfg.rmsnorm_eps),
        memory, cfg, dtype=dtype)
    return h + ffn_apply(lp["ffn"], rmsnorm(h, lp["ffn_norm"],
                                            cfg.rmsnorm_eps),
                         cfg.ffn_activation, dtype)


def enc_block_apply(lp, carry, ctx, cfg: ModelConfig, *, dtype):
    h = carry["h"]
    h = h + attention.gqa_apply(
        lp["attn"], rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps), cfg,
        positions=ctx["enc_positions"], causal=False, q_chunk=Q_CHUNK,
        dtype=dtype)
    f = ffn_apply(lp["ffn"], rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps),
                  cfg.ffn_activation, dtype)
    return {**carry, "h": h + f}


def dec_block_apply(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                    flash: bool = False):
    h = carry["h"]
    h = h + attention.gqa_apply(
        lp["self_attn"], rmsnorm(h, lp["self_norm"], cfg.rmsnorm_eps), cfg,
        positions=ctx["dec_positions"], causal=True, q_chunk=Q_CHUNK,
        dtype=dtype, flash=flash)
    return {**carry, "h": _cross_ffn(lp, h, carry["memory"], cfg, dtype)}


def dec_block_prefill(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                      flash: bool = False):
    """The decoder block over the prompt; its cache is the self-attention's
    K and V grown to ``ctx["max_len"]`` along time."""
    h = carry["h"]
    a, (k, v) = attention.gqa_prefill(
        lp["self_attn"], rmsnorm(h, lp["self_norm"], cfg.rmsnorm_eps), cfg,
        positions=ctx["dec_positions"], q_chunk=Q_CHUNK, dtype=dtype,
        flash=flash)
    if "max_len" in ctx:
        pad = ctx["max_len"] - k.shape[1]
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    h = _cross_ffn(lp, h + a, carry["memory"], cfg, dtype)
    return {**carry, "h": h}, (k, v)


def dec_block_decode(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype):
    """One token a row; K and V written in place at ``ctx["length"]``."""
    h = carry["h"]
    a, cache = attention.gqa_decode(
        lp["self_attn"], rmsnorm(h, lp["self_norm"], cfg.rmsnorm_eps), cfg,
        cache=cache, length=ctx["length"], dtype=dtype)
    h = _cross_ffn(lp, h + a, carry["memory"], cfg, dtype)
    return {**carry, "h": h}, cache


def build(cfg: ModelConfig, *, device: torch.device, dtype=torch.bfloat16,
          flash_attention: bool = False) -> ModelBundle:
    """The encoder-decoder bundle (segments ``encoder`` and ``decoder``; an
    untied head). ``flash_attention`` routes the decoder's causal
    self-attention at prefill (and in the full-sequence forward) through
    the flash kernel; the encoder's attention is not causal and
    cross-attention's queries are not aligned with its keys, so neither
    takes it, nor does decode."""
    n_enc = cfg.num_encoder_layers or cfg.num_layers
    n_dec = cfg.num_layers

    def init_params(gen: torch.Generator, device_=None, leaf_fn=None,
                    by_layer: bool = False):
        """Float32 parameters drawn from ``gen`` (the JAX package's
        distributions and tree; other numbers): the embedding,
        ``frame_norm``, the encoder's blocks, ``enc_final_norm``, the
        decoder's blocks, ``final_norm`` and the head. ``leaf_fn(keys,
        leaf)`` maps each leaf as soon as its part is drawn; ``by_layer``
        draws each stack one layer at a time
        (``transformer._draw_by_layer``), other numbers than the default
        draw."""
        dev = device if device_ is None else device_

        def fin(tree, *keys):
            return tree if leaf_fn is None else \
                _map_leaves(tree, leaf_fn, keys)

        def stack(init, n, key):
            if not by_layer:
                return fin(init(gen, cfg, n, dev), key)
            return _draw_by_layer(lambda: init(gen, cfg, None, dev), n,
                                  lambda leaf, ks: fin(leaf, key, *ks))

        d = cfg.d_model
        out = {"embedding": fin(embed_init(gen, cfg.vocab_size, d,
                                           device=dev), "embedding"),
               "frame_norm": fin(rmsnorm_init(d, device=dev), "frame_norm")}
        out["seg0_encoder"] = stack(enc_block_init, n_enc, "seg0_encoder")
        out["enc_final_norm"] = fin(rmsnorm_init(d, device=dev),
                                    "enc_final_norm")
        out["seg1_decoder"] = stack(dec_block_init, n_dec, "seg1_decoder")
        out["final_norm"] = fin(rmsnorm_init(d, device=dev), "final_norm")
        out["head"] = fin(dense_init(gen, d, cfg.vocab_size,
                                     scale=1.0 / math.sqrt(d), device=dev),
                          "head")
        return out

    def _zero_aux(like: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=like.device)

    def embed(params, batch):
        """The stubbed audio frontend (``frames`` cast and normalised) in
        ``h``, the decoder's token embeddings in ``dec_h``, a zero
        ``memory`` (B, 1, d) until the bridge."""
        frames = batch["frames"].to(dtype)
        h = rmsnorm(frames, params["frame_norm"], cfg.rmsnorm_eps)
        dec_h = layers.embed_lookup(params["embedding"], batch["tokens"],
                                    dtype)
        B, Se = h.shape[:2]
        Sd = dec_h.shape[1]
        carry = {"h": h, "dec_h": dec_h,
                 "memory": torch.zeros((B, 1, cfg.d_model), dtype=dtype,
                                       device=h.device),
                 "aux": _zero_aux(h)}
        ctx = {"enc_positions": torch.arange(
                   Se, dtype=torch.int32, device=h.device)[None].expand(B, Se),
               "dec_positions": torch.arange(
                   Sd, dtype=torch.int32, device=h.device)[None].expand(B, Sd)}
        return carry, ctx

    def bridge(params, carry, ctx):
        """After the encoder: its normalised output becomes ``memory``, and
        the decoder starts from ``dec_h``."""
        mem = rmsnorm(carry["h"], params["enc_final_norm"], cfg.rmsnorm_eps)
        return {**carry, "memory": mem, "h": carry["dec_h"]}

    def embed_decode(params, tokens, extras):
        h = layers.embed_lookup(params["embedding"], tokens, dtype)
        return {"h": h, "memory": extras["memory"], "aux": _zero_aux(h)}, {}

    def cache_shapes(batch: int, max_len: int):
        kv = ((batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim),
              None)
        return (kv, kv)

    def head_logits(params, carry):
        h = rmsnorm(carry["h"][:, -1:], params["final_norm"],
                    cfg.rmsnorm_eps)
        return dense(h, params["head"], dtype)

    def head_loss(params, carry, batch):
        h = rmsnorm(carry["h"], params["final_norm"], cfg.rmsnorm_eps)
        logits = dense(h, params["head"], dtype)
        loss, metrics = layers.cross_entropy(logits[:, :-1],
                                             batch["labels"][:, 1:])
        return loss, {**metrics, "ce_loss": loss}

    def input_specs(cell):
        """``frames`` (B, S, d) in the activation dtype (a decode cell's
        memory comes from ``max(S // DEC_RATIO, 16)`` frames), and tokens
        and labels of ``max(S // DEC_RATIO, 16)``, as the JAX package's."""
        B, S = cell.global_batch, cell.seq_len
        Sd = max(S // DEC_RATIO, 16)
        Se = Sd if cell.kind == "decode" else S
        return {"frames": ((B, Se, cfg.d_model), dtype),
                "tokens": ((B, Sd), torch.int32),
                "labels": ((B, Sd), torch.int32)}

    segments = (
        SegmentDef(name="encoder", n_layers=n_enc,
                   apply=functools.partial(enc_block_apply, cfg=cfg,
                                           dtype=dtype)),
        SegmentDef(name="decoder", n_layers=n_dec,
                   apply=functools.partial(dec_block_apply, cfg=cfg,
                                           dtype=dtype,
                                           flash=flash_attention),
                   prefill=functools.partial(dec_block_prefill, cfg=cfg,
                                             dtype=dtype,
                                             flash=flash_attention),
                   decode=functools.partial(dec_block_decode, cfg=cfg,
                                            dtype=dtype),
                   cache_shapes=cache_shapes, pre=bridge))
    return ModelBundle(cfg=cfg, device=torch.device(device), dtype=dtype,
                       init_params=init_params, embed=embed,
                       segments=segments, head_logits=head_logits,
                       head_loss=head_loss, flash_attention=flash_attention,
                       ragged_prefill_ok=False, embed_decode=embed_decode,
                       decode_extras=("memory",), input_specs=input_specs)
