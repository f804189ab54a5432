"""Dense decoder-only transformer (the LLaMA family): the counterpart of
the dense GQA path of ``repro/models/transformer.py``."""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import attention, layers
from repro_torch.models.base import ModelBundle, SegmentDef
from repro_torch.models.layers import dense, dense_init, embed_init, \
    ffn_apply, ffn_init, rmsnorm, rmsnorm_init, softcap


Q_CHUNK = 1024      # query rows per attention score block (the JAX default)


def _map_leaves(tree, fn, keys: tuple):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, keys + (k,)) for k, v in tree.items()}
    return fn(keys, tree)


def block_apply(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                flash: bool = False):
    h = carry["h"]
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    h = h + attention.gqa_apply(lp["attn"], x, cfg,
                                positions=ctx["positions"],
                                q_chunk=Q_CHUNK, dtype=dtype, flash=flash)
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    return {**carry, "h": h + ffn_apply(lp["ffn"], x, dtype)}


def block_prefill(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                  flash: bool = False):
    h = carry["h"]
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    a, cache = attention.gqa_prefill(lp["attn"], x, cfg,
                                     positions=ctx["positions"],
                                     q_chunk=Q_CHUNK, dtype=dtype,
                                     flash=flash)
    if "max_len" in ctx:
        # grow the cache to the serving window (time axis = 1)
        pad = ctx["max_len"] - cache[0].shape[1]
        cache = tuple(F.pad(c, (0, 0, 0, 0, 0, pad)) for c in cache)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f = ffn_apply(lp["ffn"], x, dtype)
    return {**carry, "h": h + f}, cache


def block_decode(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype):
    """One token per row; the cache slices are written in place."""
    h = carry["h"]                              # (B, 1, D)
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    a, cache = attention.gqa_decode(lp["attn"], x, cfg, cache=cache,
                                    length=ctx["length"], dtype=dtype)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f = ffn_apply(lp["ffn"], x, dtype)
    return {**carry, "h": h + f}, cache


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (shape, shape)


def _head_logits(params, h, cfg: ModelConfig, dtype):
    h = rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    return softcap(dense(h, params["head"], dtype), cfg.logit_softcap)


def build(cfg: ModelConfig, *, device: torch.device,
          dtype=torch.bfloat16, flash_attention: bool = False,
          split_layers: int = 0) -> ModelBundle:
    """Dense LM bundle with an untied head. ``device`` is where
    ``init_params`` puts the weights by default and where the engine places
    its inputs. ``flash_attention`` routes every full causal self-attention
    (prefill, the full-sequence forward) through the flash kernel; decode
    never takes it.

    ``split_layers``: 0 gives one segment of ``cfg.num_layers`` blocks,
    ``seg0_dense``; ``0 < N < num_layers`` splits the stack after the first
    N layers into ``seg0_dense`` (layers 0..N-1) and ``seg1_dense`` (the
    rest). The split model computes what the unsplit one does; it lets
    param-group rules address a range of layers by path (the fine-tune
    rules freeze ``seg0_``)."""
    if cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: tied embeddings need the transposed INT8 matmul, "
            "which is not ported yet")
    if split_layers and not 0 < split_layers < cfg.num_layers:
        # a split ignored in silence would leave one segment named
        # seg0_dense, and a rule freezing "seg0_" would freeze every block
        raise ValueError(
            f"split_layers={split_layers} out of range for "
            f"num_layers={cfg.num_layers} (need 0 < split < num_layers)")
    sizes = ((split_layers, cfg.num_layers - split_layers) if split_layers
             else (cfg.num_layers,))

    def init_params(gen: torch.Generator, device_=None, leaf_fn=None):
        """Float32 parameters drawn from ``gen`` (the JAX package's
        distributions; its numbers cannot be reproduced): each segment's
        blocks in order, then the embedding, final norm and head.

        ``leaf_fn(keys, leaf)`` (``keys``: the leaf's path in the tree)
        maps each leaf as soon as its group is drawn, so the whole float
        tree never exists at once on the device."""
        dev = device if device_ is None else device_

        def fin(tree, *keys):
            return tree if leaf_fn is None else \
                _map_leaves(tree, leaf_fn, keys)

        params = {}
        for i, n in enumerate(sizes):
            key = f"seg{i}_dense"
            params[key] = {
                "attn_norm": fin(rmsnorm_init(cfg.d_model, num=n,
                                              device=dev), key, "attn_norm"),
                "attn": fin(attention.gqa_init(gen, cfg, num=n, device=dev),
                            key, "attn"),
                "ffn_norm": fin(rmsnorm_init(cfg.d_model, num=n, device=dev),
                                key, "ffn_norm"),
                "ffn": fin(ffn_init(gen, cfg.d_model, cfg.d_ff, num=n,
                                    device=dev), key, "ffn"),
            }
        return {
            "embedding": fin(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        device=dev), "embedding"),
            "final_norm": fin(rmsnorm_init(cfg.d_model, device=dev),
                              "final_norm"),
            "head": fin(dense_init(gen, cfg.d_model, cfg.vocab_size,
                                   scale=1.0 / math.sqrt(cfg.d_model),
                                   device=dev), "head"),
            **params,
        }

    def embed(params, batch):
        tokens = batch["tokens"]
        h = layers.embed_lookup(params["embedding"], tokens, dtype)
        B, S = h.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        return {"h": h}, {"positions": positions}

    def head_logits(params, carry):
        return _head_logits(params, carry["h"][:, -1:], cfg, dtype)

    def head_loss(params, carry, batch):
        """Next-token loss: logits[t] predicts labels[t + 1]."""
        logits = _head_logits(params, carry["h"], cfg, dtype)
        loss, metrics = layers.cross_entropy(logits[:, :-1],
                                             batch["labels"][:, 1:])
        return loss, {**metrics, "ce_loss": loss}

    segments = tuple(SegmentDef(
        name="dense", n_layers=n,
        apply=functools.partial(block_apply, cfg=cfg, dtype=dtype,
                                flash=flash_attention),
        prefill=functools.partial(block_prefill, cfg=cfg, dtype=dtype,
                                  flash=flash_attention),
        decode=functools.partial(block_decode, cfg=cfg, dtype=dtype),
        cache_shapes=functools.partial(_cache_shapes, cfg)) for n in sizes)
    return ModelBundle(cfg=cfg, device=torch.device(device), dtype=dtype,
                       init_params=init_params, embed=embed,
                       segments=segments, head_logits=head_logits,
                       head_loss=head_loss,
                       flash_attention=flash_attention)
