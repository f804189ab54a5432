"""Dense decoder-only transformer: the counterpart of the dense GQA path
of ``repro/models/transformer.py`` (the LLaMA family, mistral-nemo-12b,
yi-9b, qwen3-32b with qk-norm, gemma-7b with GeGLU and the tied INT8
head, and the VLM backbone of internvl2-2b with its prefix embeddings)."""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.quant import QTensor
from repro_torch.models import attention, layers
from repro_torch.models.base import ModelBundle, SegmentDef
from repro_torch.models.layers import dense, dense_init, dense_t, \
    embed_init, ffn_apply, ffn_init, rmsnorm, rmsnorm_init, softcap


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
    f = ffn_apply(lp["ffn"], x, cfg.ffn_activation, dtype)
    return {**carry, "h": h + f}


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
    f = ffn_apply(lp["ffn"], x, cfg.ffn_activation, dtype)
    return {**carry, "h": h + f}, cache


def block_decode(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype):
    """One token per row; the cache slices are written in place."""
    h = carry["h"]                              # (B, 1, D)
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    a, cache = attention.gqa_decode(lp["attn"], x, cfg, cache=cache,
                                    length=ctx["length"], dtype=dtype)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f = ffn_apply(lp["ffn"], x, cfg.ffn_activation, dtype)
    return {**carry, "h": h + f}, cache


def block_append(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype):
    """Chunk-append (paged prefill): carry["h"] is a (B, C, D) chunk of
    prompt tokens at absolute ``ctx["positions"]``; the cache slices
    already hold every earlier position and are written in place."""
    h = carry["h"]
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    a, cache = attention.gqa_append(lp["attn"], x, cfg, cache=cache,
                                    positions=ctx["positions"],
                                    mask=ctx["chunk_mask"], dtype=dtype)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f = ffn_apply(lp["ffn"], x, cfg.ffn_activation, dtype)
    return {**carry, "h": h + f}, cache


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return (shape, shape)


def _head_logits(params, h, cfg: ModelConfig, dtype):
    h = rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        # h @ E^T: the embedding's INT8 blocks streamed transposed
        logits = dense_t(h, params["embedding"], dtype)
    else:
        logits = dense(h, params["head"], dtype)
    return softcap(logits, cfg.logit_softcap)


def _empty_stack(leaf, n: int):
    if isinstance(leaf, QTensor):
        return leaf.map(lambda t: t.new_empty((n,) + tuple(t.shape)))
    return leaf.new_empty((n,) + tuple(leaf.shape))


def _write_layer(stack, i: int, leaf) -> None:
    if isinstance(leaf, QTensor):
        for dst, src in ((stack.q, leaf.q), (stack.scale, leaf.scale),
                         (stack.zero, leaf.zero)):
            if dst is not None:
                dst[i].copy_(src)
    else:
        stack[i].copy_(leaf)


def _draw_by_layer(draw, n: int, fin):
    """A stacked group drawn one layer at a time: ``draw()`` gives one
    layer's leaves; each matrix is mapped by ``fin(keys, leaf)`` at once
    and written into its stack (allocated at layer 0), so one layer's
    float group is all the float the device holds. 1-D leaves (norm
    scales) are stacked first and mapped whole, as the whole-group draw
    maps them."""
    stacks, vectors, order = {}, {}, None
    for i in range(n):
        group = draw()
        order = list(group)
        for k, leaf in group.items():
            if leaf.ndim < 2:
                vectors.setdefault(k, []).append(leaf)
                continue
            mapped = fin(leaf, k)
            if k not in stacks:
                stacks[k] = _empty_stack(mapped, n)
            _write_layer(stacks[k], i, mapped)
        del group
    for k, vs in vectors.items():
        stacks[k] = fin(torch.stack(vs), k)
    return {k: stacks[k] for k in order}


def build(cfg: ModelConfig, *, device: torch.device,
          dtype=torch.bfloat16, flash_attention: bool = False,
          split_layers: int = 0) -> ModelBundle:
    """Dense LM bundle (families ``dense`` and ``vlm``). ``device`` is where
    ``init_params`` puts the weights by default and where the engine places
    its inputs. ``flash_attention`` routes every full causal self-attention
    (prefill, the full-sequence forward) through the flash kernel; decode
    never takes it.

    ``split_layers``: 0 gives one segment of ``cfg.num_layers`` blocks,
    ``seg0_dense``; ``0 < N < num_layers`` splits the stack after the first
    N layers into ``seg0_dense`` (layers 0..N-1) and ``seg1_dense`` (the
    rest). The split model computes what the unsplit one does; it lets
    param-group rules address a range of layers by path (the fine-tune
    rules freeze ``seg0_``).

    ``cfg.tie_embeddings`` drops the ``head`` leaf: the logits are
    ``h @ E^T`` through ``layers.dense_t``. ``cfg.embed_scale`` (gemma) scales
    the embeddings by sqrt(d_model). A ``vlm``
    bundle puts ``batch["patch_embeds"]`` (B, P, d_model) in front of the
    token embeddings, and its loss drops those P positions."""
    is_vlm = cfg.family == "vlm"
    if split_layers and not 0 < split_layers < cfg.num_layers:
        # a split ignored in silence would leave one segment named
        # seg0_dense, and a rule freezing "seg0_" would freeze every block
        raise ValueError(
            f"split_layers={split_layers} out of range for "
            f"num_layers={cfg.num_layers} (need 0 < split < num_layers)")
    sizes = ((split_layers, cfg.num_layers - split_layers) if split_layers
             else (cfg.num_layers,))

    def init_params(gen: torch.Generator, device_=None, leaf_fn=None,
                    by_layer: bool = False):
        """Float32 parameters drawn from ``gen`` (the JAX package's
        distributions; its numbers cannot be reproduced): each segment's
        blocks in order, then the embedding, final norm and (untied) head.

        ``leaf_fn(keys, leaf)`` (``keys``: the leaf's path in the tree)
        maps each leaf as soon as its group is drawn, so the whole float
        tree never exists at once on the device.

        ``by_layer`` draws each stacked group one layer at a time and maps
        each layer's matrices as they are drawn (``_draw_by_layer``): the
        device then holds one layer's float group beside the mapped tree
        (qwen3-32b's FFN group is 100.7 GB of float32 whole). It gives other
        numbers than the default, whole-group draw, and needs a ``leaf_fn``
        that maps a stack as it maps each layer, as
        ``serve.params.quantize_leaf`` does."""
        dev = device if device_ is None else device_

        def fin(tree, *keys):
            return tree if leaf_fn is None else \
                _map_leaves(tree, leaf_fn, keys)

        def group(init, n, *keys):
            if not by_layer:
                return fin(init(n), *keys)
            return _draw_by_layer(lambda: init(None), n,
                                  lambda leaf, k: fin(leaf, *keys, k))

        params = {}
        for i, n in enumerate(sizes):
            key = f"seg{i}_dense"
            params[key] = {
                "attn_norm": fin(rmsnorm_init(cfg.d_model, num=n,
                                              device=dev), key, "attn_norm"),
                "attn": group(lambda m: attention.gqa_init(
                    gen, cfg, num=m, device=dev), n, key, "attn"),
                "ffn_norm": fin(rmsnorm_init(cfg.d_model, num=n, device=dev),
                                key, "ffn_norm"),
                "ffn": group(lambda m: ffn_init(
                    gen, cfg.d_model, cfg.d_ff, num=m, device=dev), n, key,
                    "ffn"),
            }
        top = {
            "embedding": fin(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        device=dev), "embedding"),
            "final_norm": fin(rmsnorm_init(cfg.d_model, device=dev),
                              "final_norm"),
        }
        if not cfg.tie_embeddings:
            top["head"] = fin(dense_init(gen, cfg.d_model, cfg.vocab_size,
                                         scale=1.0 / math.sqrt(cfg.d_model),
                                         device=dev), "head")
        return {**top, **params}

    def embed(params, batch):
        tokens = batch["tokens"]
        h = layers.embed_lookup(params["embedding"], tokens, dtype)
        if cfg.embed_scale:
            # the factor rounded to the activation dtype, as the JAX
            # package's weakly typed scalar is
            h = h * torch.full((), math.sqrt(cfg.d_model), dtype=h.dtype,
                               device=h.device)
        if is_vlm and "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
        B, S = h.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        return {"h": h}, {"positions": positions}

    def head_logits(params, carry):
        return _head_logits(params, carry["h"][:, -1:], cfg, dtype)

    def head_loss(params, carry, batch):
        """Next-token loss: logits[t] predicts labels[t + 1]; a VLM's
        prefix positions carry no labels and are dropped first."""
        h = carry["h"]
        if is_vlm:
            h = h[:, h.shape[1] - batch["labels"].shape[1]:]
        logits = _head_logits(params, h, cfg, dtype)
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
        cache_shapes=functools.partial(_cache_shapes, cfg),
        append=functools.partial(block_append, cfg=cfg, dtype=dtype))
        for n in sizes)
    return ModelBundle(cfg=cfg, device=torch.device(device), dtype=dtype,
                       init_params=init_params, embed=embed,
                       segments=segments, head_logits=head_logits,
                       head_loss=head_loss,
                       flash_attention=flash_attention)
