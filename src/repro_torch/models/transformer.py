"""Decoder-only transformer: the counterpart of
``repro/models/transformer.py`` (the LLaMA family, mistral-nemo-12b,
yi-9b, qwen3-32b with qk-norm, gemma-7b with GeGLU and the tied INT8
head, the VLM backbone of internvl2-2b with its prefix embeddings, the
mixture of experts qwen3-moe-30b-a3b, and deepseek-v3-671b: MLA, shared
experts, leading dense layers and multi-token prediction)."""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.core.quant import QTensor
from repro_torch.distributed import tp as tp_lib
from repro_torch.models import attention, layers, moe as moe_lib
from repro_torch.models.base import ModelBundle, SegmentDef, \
    lm_input_specs
from repro_torch.models.layers import dense, dense_init, dense_t, \
    embed_init, ffn_apply, ffn_init, rmsnorm, rmsnorm_init, softcap


Q_CHUNK = 1024      # query rows per attention score block (the JAX default)


def _map_leaves(tree, fn, keys: tuple):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, keys + (k,)) for k, v in tree.items()}
    return fn(keys, tree)


def _split(w, whole: int, tp) -> bool:
    """Whether a row-parallel weight is this tensor-parallel rank's slice
    (its rows fewer than the whole leaf's): its unit then runs between
    ``tp_lib.copy`` and ``tp_lib.reduce`` (``distributed/tp.py``)."""
    return tp is not None and w.shape[-2] != whole


def _ffn(lp, carry, x, cfg: ModelConfig, dtype, capacity=None, tp=None,
         ep=None):
    """The block's FFN on x: the dense FFN (column- and row-parallel
    under ``tp`` where its leaves are this rank's slices), or the MoE
    layer (expert-parallel over ``ep``), whose aux loss the carry
    accumulates (``capacity``: decode's drop-free buffer, whose aux is
    not kept)."""
    if "moe" not in lp:
        if _split(lp["ffn"]["wd"], cfg.d_ff, tp):
            f = ffn_apply(lp["ffn"], tp_lib.copy(x, tp), cfg.ffn_activation,
                          dtype)
            return tp_lib.reduce(f, tp), carry
        return ffn_apply(lp["ffn"], x, cfg.ffn_activation, dtype), carry
    if ep is not None:
        f, aux = moe_lib.moe_apply_ep(lp["moe"], x, cfg, ep, dtype=dtype)
    else:
        f, aux = moe_lib.moe_apply(lp["moe"], x, cfg, dtype=dtype,
                                   capacity=capacity)
    if capacity is None:
        carry = {**carry, "aux": carry["aux"] + aux}
    return f, carry


def block_apply(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                flash: bool = False, tp=None, ep=None):
    """One block of the full-sequence forward; under ``tp`` (the model
    group) a unit whose leaves are this rank's slices runs on its heads
    or FFN columns and sums its output over the group."""
    h = carry["h"]
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    if cfg.attention == "mla":
        a = attention.mla_apply(lp["attn"], x, cfg,
                                positions=ctx["positions"], q_chunk=Q_CHUNK,
                                dtype=dtype)
    elif _split(lp["attn"]["wo"], cfg.num_heads * cfg.resolved_head_dim,
                tp):
        a = tp_lib.reduce(attention.gqa_apply(
            lp["attn"], tp_lib.copy(x, tp), cfg, positions=ctx["positions"],
            q_chunk=Q_CHUNK, dtype=dtype, flash=flash), tp)
    else:
        a = attention.gqa_apply(lp["attn"], x, cfg,
                                positions=ctx["positions"], q_chunk=Q_CHUNK,
                                dtype=dtype, flash=flash)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f, carry = _ffn(lp, carry, x, cfg, dtype, tp=tp, ep=ep)
    return {**carry, "h": h + f}


def _attn_cached(fn, lp, x, cfg: ModelConfig, tp, **kw):
    """``fn`` (an attention entry that returns its cache) on x; under
    ``tp`` a unit whose leaves are this rank's slices runs on its heads
    between ``tp_lib.copy`` and ``tp_lib.reduce``, and its cache holds
    the rank's kv heads."""
    if _split(lp["attn"]["wo"], cfg.num_heads * cfg.resolved_head_dim, tp):
        a, cache = fn(lp["attn"], tp_lib.copy(x, tp), cfg, **kw)
        return tp_lib.reduce(a, tp), cache
    return fn(lp["attn"], x, cfg, **kw)


def block_prefill(lp, carry, ctx, cfg: ModelConfig, *, dtype,
                  flash: bool = False, tp=None):
    h = carry["h"]
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    if cfg.attention == "mla":
        a, cache = attention.mla_prefill(lp["attn"], x, cfg,
                                         positions=ctx["positions"],
                                         q_chunk=Q_CHUNK, dtype=dtype)
    else:
        a, cache = _attn_cached(attention.gqa_prefill, lp, x, cfg, tp,
                                positions=ctx["positions"], q_chunk=Q_CHUNK,
                                dtype=dtype, flash=flash)
    if "max_len" in ctx:
        # grow the cache to the serving window along time (axis 1), whatever
        # its rank: GQA's (B, S, KH, hd), MLA's (B, S, rank)
        pad = ctx["max_len"] - cache[0].shape[1]
        cache = tuple(F.pad(c, (0, 0) * (c.ndim - 2) + (0, pad))
                      for c in cache)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f, carry = _ffn(lp, carry, x, cfg, dtype, tp=tp)
    return {**carry, "h": h + f}, cache


def block_decode(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype,
                 tp=None):
    """One token per row; the cache slices are written in place. An MoE
    layer runs at the drop-free capacity B·S."""
    h = carry["h"]                              # (B, 1, D)
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    if cfg.attention == "mla":
        a, cache = attention.mla_decode(lp["attn"], x, cfg, cache=cache,
                                        length=ctx["length"], dtype=dtype)
    else:
        a, cache = _attn_cached(attention.gqa_decode, lp, x, cfg, tp,
                                cache=cache, length=ctx["length"],
                                dtype=dtype)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f, carry = _ffn(lp, carry, x, cfg, dtype,
                    capacity=x.shape[0] * x.shape[1], tp=tp)
    return {**carry, "h": h + f}, cache


def block_append(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype,
                 tp=None):
    """Chunk-append (paged prefill): carry["h"] is a (B, C, D) chunk of
    prompt tokens at absolute ``ctx["positions"]``; the cache slices
    already hold every earlier position and are written in place."""
    h = carry["h"]
    x = rmsnorm(h, lp["attn_norm"], cfg.rmsnorm_eps)
    a, cache = _attn_cached(attention.gqa_append, lp, x, cfg, tp,
                            cache=cache, positions=ctx["positions"],
                            mask=ctx["chunk_mask"], dtype=dtype)
    h = h + a
    x = rmsnorm(h, lp["ffn_norm"], cfg.rmsnorm_eps)
    f, carry = _ffn(lp, carry, x, cfg, dtype, tp=tp)
    return {**carry, "h": h + f}, cache


def _cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                  kv_heads: int = 0):
    """The K/V (or MLA's latent and rope key) windows, in the pool's
    dtype; ``kv_heads``: a tensor-parallel rank's share of the kv heads
    (default: all of them)."""
    if cfg.attention == "mla":
        shapes = attention.mla_cache_shapes(cfg, batch, max_len)
    else:
        shape = (batch, max_len, kv_heads or cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        shapes = (shape, shape)
    return tuple((s, None) for s in shapes)


def _head_split(params, cfg: ModelConfig, tp) -> bool:
    """Whether the head is this tensor-parallel rank's vocabulary slice."""
    return tp is not None and "head" in params and \
        params["head"].shape[-1] != cfg.vocab_size


def _head_logits(params, h, cfg: ModelConfig, dtype, tp=None):
    """The logits; a vocabulary-split head (``tp``) gives this rank's
    columns, its input read through ``tp_lib.copy``."""
    h = rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        # h @ E^T: the embedding's INT8 blocks streamed transposed
        logits = dense_t(h, params["embedding"], dtype)
    else:
        if _head_split(params, cfg, tp):
            h = tp_lib.copy(h, tp)
        logits = dense(h, params["head"], dtype)
    return softcap(logits, cfg.logit_softcap)


def _not_served(*_a, **_k):
    raise NotImplementedError(
        "a bundle built with ep_group trains only: expert-parallel serving "
        "is a ROADMAP queue 1, 5c follow-up (a tp_group bundle serves)")


def _empty_stack(leaf, n: int, rows=None):
    """An uninitialised stack of ``n`` leaves like ``leaf``; ``rows``
    gives the whole first axis of which ``leaf`` is a slice (experts)."""
    def empty(t):
        shape = tuple(t.shape) if rows is None else \
            (rows,) + tuple(t.shape[1:])
        return t.new_empty((n,) + shape)
    return leaf.map(empty) if isinstance(leaf, QTensor) else empty(leaf)


def _write_layer(stack, i, leaf) -> None:
    if isinstance(leaf, QTensor):
        for dst, src in ((stack.q, leaf.q), (stack.scale, leaf.scale),
                         (stack.zero, leaf.zero)):
            if dst is not None:
                dst[i].copy_(src)
    else:
        stack[i].copy_(leaf)


def _paths(tree, keys: tuple = ()):
    """``(keys, leaf)`` of a nested dict, in its order."""
    if isinstance(tree, dict):
        return [kl for k, v in tree.items() for kl in _paths(v, keys + (k,))]
    return [(keys, tree)]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for keys, leaf in flat.items():
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return out


def _draw_by_layer(draw, n: int, fin):
    """A stacked group drawn one layer at a time: ``draw()`` gives one
    layer's leaves (a nested dict); each matrix is mapped by ``fin(leaf,
    keys)`` at once and written into its stack (allocated at layer 0), so
    one layer's float group is all the float the device holds. An expert
    stack (``moe.ExpertSlices``) is drawn, mapped and written a slice of
    experts at a time. 1-D leaves (norm scales) are stacked first and
    mapped whole, as the whole-group draw maps them."""
    stacks, vectors, order = {}, {}, None
    for i in range(n):
        group = _paths(draw())
        order = [k for k, _ in group]
        for k, leaf in group:
            if isinstance(leaf, moe_lib.ExpertSlices):
                for e0, part in leaf:
                    mapped = fin(part, k)
                    if k not in stacks:
                        stacks[k] = _empty_stack(mapped, n, leaf.num)
                    _write_layer(stacks[k], (i, slice(e0, e0 + len(part))),
                                 mapped)
                    del part, mapped
                continue
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
    return _nest({k: stacks[k] for k in order})


def build(cfg: ModelConfig, *, device: torch.device,
          dtype=torch.bfloat16, flash_attention: bool = False,
          split_layers: int = 0, tp_group=None, ep_group=None
          ) -> ModelBundle:
    """LM bundle (families ``dense``, ``vlm`` and ``moe``; GQA or MLA
    attention). ``device`` is
    where ``init_params`` puts the weights by default and where the engine
    places its inputs. ``flash_attention`` routes every full causal self-attention
    (prefill, the full-sequence forward) through the flash kernel; decode
    never takes it.

    ``split_layers``: 0 gives one segment of ``cfg.num_layers`` blocks,
    ``seg0_dense``; ``0 < N < num_layers`` splits the stack after the first
    N layers into ``seg0_dense`` (layers 0..N-1) and ``seg1_dense`` (the
    rest). The split model computes what the unsplit one does; it lets
    param-group rules address a range of layers by path (the fine-tune
    rules freeze ``seg0_``).

    ``cfg.moe`` makes the blocks MoE blocks (an ``moe`` leaf in place of
    ``ffn``), in segment ``seg0_moe``, after ``seg0_dense`` when
    ``moe.first_dense_layers`` keeps the first blocks dense (their FFN
    width ``moe.dense_ff or d_ff``); ``split_layers`` is refused for them,
    as by the reference. The carry then holds ``aux``, the routers'
    load-balance loss, which ``head_loss`` adds to the loss. MoE segments
    have no chunk-append, and ``ragged_prefill_ok`` is False: capacity-
    limited routing couples the rows of a padded prefill.

    ``cfg.attention == "mla"`` gives every block Multi-head Latent
    Attention (``attention.mla_*``), whose cache is the compressed latent
    and rope key; MLA segments have no chunk-append either (the absorbed
    decode contracts in another order than the prefill, so a chunked
    prompt cannot promise one-shot prefill's numbers). ``cfg.mtp_depth``
    1 adds multi-token prediction to the loss (``mtp_block``, a dense
    block of FFN width ``moe.dense_ff or d_ff``, ``mtp_norm``,
    ``mtp_proj``; training only).

    ``tp_group`` (a ``Comm`` over the model group): the bundle computes
    on this rank's slices of the weights (``distributed/tp.py``; each
    attention or FFN unit whose leaves are slices runs between
    ``tp_lib.copy`` and ``tp_lib.reduce``, a d-split embedding is
    all-gathered, a vocabulary-split head takes the vocab-parallel loss).
    ``ep_group``: every MoE layer runs expert-parallel over its ranks
    (``moe.moe_apply_ep``, the reference's ``ep_axis``), each holding
    E/n experts' stacks; it makes a training bundle, whose serving entries
    raise (expert-parallel serving is a ROADMAP queue 1, 5c follow-up). A
    ``tp_group`` bundle serves: prefill, decode and append run each split
    unit on the rank's heads or FFN columns as the forward does, the
    cache holds the rank's kv heads of a split attention unit
    (``tp_lib.attn_split``), and a vocabulary-split head's logits are
    gathered (``tp_lib.gather_last``) before sampling.

    ``cfg.tie_embeddings`` drops the ``head`` leaf: the logits are
    ``h @ E^T`` through ``layers.dense_t``. ``cfg.embed_scale`` (gemma) scales
    the embeddings by sqrt(d_model). A ``vlm``
    bundle puts ``batch["patch_embeds"]`` (B, P, d_model) in front of the
    token embeddings, and its loss drops those P positions."""
    is_vlm = cfg.family == "vlm"
    mc = cfg.moe
    if split_layers and not 0 < split_layers < cfg.num_layers:
        # a split ignored in silence would leave one segment named
        # seg0_dense, and a rule freezing "seg0_" would freeze every block
        raise ValueError(
            f"split_layers={split_layers} out of range for "
            f"num_layers={cfg.num_layers} (need 0 < split < num_layers)")
    # segments as (name, layers, MoE blocks, dense FFN width)
    if mc is not None and mc.first_dense_layers:
        if split_layers:
            raise ValueError("split_layers unsupported for MoE models with "
                             "first_dense_layers (already two segments)")
        segs = (("dense", mc.first_dense_layers, False,
                 mc.dense_ff or cfg.d_ff),
                ("moe", cfg.num_layers - mc.first_dense_layers, True, 0))
    elif mc is not None:
        if split_layers:
            raise ValueError("split_layers unsupported for MoE models")
        segs = (("moe", cfg.num_layers, True, 0),)
    elif split_layers:
        segs = (("dense", split_layers, False, cfg.d_ff),
                ("dense", cfg.num_layers - split_layers, False, cfg.d_ff))
    else:
        segs = (("dense", cfg.num_layers, False, cfg.d_ff),)
    mtp_ff = (mc.dense_ff or cfg.d_ff) if mc is not None else cfg.d_ff

    def init_params(gen: torch.Generator, device_=None, leaf_fn=None,
                    by_layer: bool = False):
        """Float32 parameters drawn from ``gen`` (the JAX package's
        distributions; its numbers cannot be reproduced): each segment's
        blocks in order, then the embedding, final norm, (untied) head and
        the MTP block, norm and projection.

        ``leaf_fn(keys, leaf)`` (``keys``: the leaf's path in the tree)
        maps each leaf as soon as its group is drawn, so the whole float
        tree never exists at once on the device.

        ``by_layer`` draws each stacked group one layer at a time and maps
        each layer's matrices as they are drawn (``_draw_by_layer``): the
        device then holds one layer's float group beside the mapped tree
        (qwen3-32b's FFN group is 100.7 GB of float32 whole). It gives other
        numbers than the default, whole-group draw, and needs a ``leaf_fn``
        that maps a stack as it maps each layer, as
        ``serve.params.quantize_leaf`` does. It draws an expert stack
        ``moe.EXPERT_SLICE`` experts at a time (deepseek-v3's three stacks
        are 45.1 GB of float32 a layer)."""
        dev = device if device_ is None else device_

        def fin(tree, *keys):
            return tree if leaf_fn is None else \
                _map_leaves(tree, leaf_fn, keys)

        def group(init, n, *keys):
            if not by_layer:
                return fin(init(n), *keys)
            return _draw_by_layer(lambda: init(None), n,
                                  lambda leaf, ks: fin(leaf, *keys, *ks))

        def attn_init(m):
            init = attention.mla_init if cfg.attention == "mla" \
                else attention.gqa_init
            return init(gen, cfg, num=m, device=dev)

        params = {}
        for i, (name, n, is_moe, d_ff) in enumerate(segs):
            key = f"seg{i}_{name}"
            params[key] = {
                "attn_norm": fin(rmsnorm_init(cfg.d_model, num=n,
                                              device=dev), key, "attn_norm"),
                "attn": group(attn_init, n, key, "attn"),
                "ffn_norm": fin(rmsnorm_init(cfg.d_model, num=n, device=dev),
                                key, "ffn_norm"),
            }
            if is_moe:
                # m is None only in a by-layer draw: slice the experts there
                params[key]["moe"] = group(lambda m: moe_lib.moe_init(
                    gen, cfg, num=m, device=dev,
                    expert_slice=moe_lib.EXPERT_SLICE if m is None else None),
                    n, key, "moe")
            else:
                params[key]["ffn"] = group(lambda m, f=d_ff: ffn_init(
                    gen, cfg.d_model, f, num=m, device=dev), n, key, "ffn")
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
        if cfg.mtp_depth:
            mk = "mtp_block"
            top[mk] = {
                "attn_norm": fin(rmsnorm_init(cfg.d_model, device=dev), mk,
                                 "attn_norm"),
                "attn": fin(attn_init(None), mk, "attn"),
                "ffn_norm": fin(rmsnorm_init(cfg.d_model, device=dev), mk,
                                "ffn_norm"),
                "ffn": fin(ffn_init(gen, cfg.d_model, mtp_ff, device=dev),
                           mk, "ffn"),
            }
            top["mtp_norm"] = fin(rmsnorm_init(cfg.d_model, device=dev),
                                  "mtp_norm")
            top["mtp_proj"] = fin(dense_init(gen, 2 * cfg.d_model,
                                             cfg.d_model, device=dev),
                                  "mtp_proj")
        return {**top, **params}

    def embed_tokens(params, tokens):
        h = layers.embed_lookup(params["embedding"], tokens, dtype)
        if tp_group is not None and \
                params["embedding"].shape[-1] != cfg.d_model:
            h = tp_lib.gather_last(h, tp_group)     # this rank's columns
        if cfg.embed_scale:
            # the factor rounded to the activation dtype, as the JAX
            # package's weakly typed scalar is
            h = h * torch.full((), math.sqrt(cfg.d_model), dtype=h.dtype,
                               device=h.device)
        return h

    def embed(params, batch):
        h = embed_tokens(params, batch["tokens"])
        if is_vlm and "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
        B, S = h.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=h.device)[None].expand(B, S)
        carry = {"h": h}
        if mc is not None:
            carry["aux"] = torch.zeros((), dtype=torch.float32,
                                       device=h.device)
        return carry, {"positions": positions}

    def head_logits(params, carry):
        logits = _head_logits(params, carry["h"][:, -1:], cfg, dtype,
                              tp_group)
        if _head_split(params, cfg, tp_group):
            logits = tp_lib.gather_last(logits, tp_group)
        return logits

    def head_loss(params, carry, batch):
        """Next-token loss: logits[t] predicts labels[t + 1]; a VLM's
        prefix positions carry no labels and are dropped first. An MoE
        model adds the carry's ``aux`` (its ``aux_loss`` metric).

        With ``mtp_depth`` the DeepSeek multi-token prediction term (the
        reference's ``head_loss``): ``mtp_proj([h_t ; emb(label_{t+1})])``
        on the final norm's input, one dense block at positions 0..S-2,
        ``mtp_norm``, the same head, and cross-entropy against
        ``labels[t + 2]``; the loss gains 0.3 of it (``mtp_loss``)."""
        h = carry["h"]
        labels = batch["labels"]
        if is_vlm:
            h = h[:, h.shape[1] - labels.shape[1]:]
        logits = _head_logits(params, h, cfg, dtype, tp_group)
        if _head_split(params, cfg, tp_group):
            loss, metrics = tp_lib.vocab_parallel_cross_entropy(
                logits[:, :-1], labels[:, 1:], tp_group)
        else:
            loss, metrics = layers.cross_entropy(logits[:, :-1],
                                                 labels[:, 1:])
        if cfg.mtp_depth:
            emb_next = embed_tokens(params, labels)
            hm = torch.cat([h[:, :-1], emb_next[:, 1:]], dim=-1)
            hm = dense(hm, params["mtp_proj"], dtype)
            B, S = hm.shape[:2]
            pos = torch.arange(S, dtype=torch.int32,
                               device=hm.device)[None].expand(B, S)
            hm = block_apply(params["mtp_block"], {"h": hm},
                             {"positions": pos}, cfg, dtype=dtype)["h"]
            hm = rmsnorm(hm, params["mtp_norm"], cfg.rmsnorm_eps)
            mtp_logits = _head_logits(params, hm, cfg, dtype)
            mtp_loss, _ = layers.cross_entropy(mtp_logits[:, :-1],
                                               labels[:, 2:])
            loss = loss + 0.3 * mtp_loss
            metrics = {**metrics, "mtp_loss": mtp_loss}
        if "aux" not in carry:
            return loss, {**metrics, "ce_loss": loss}
        return loss + carry["aux"], {**metrics, "ce_loss": loss,
                                     "aux_loss": carry["aux"]}

    ep_only = ep_group is not None
    t = tp_group.world if tp_group is not None else 1
    kv_heads = cfg.num_kv_heads // t \
        if cfg.attention == "gqa" and tp_lib.attn_split(cfg, t) else 0
    segments = tuple(SegmentDef(
        name=name, n_layers=n,
        apply=functools.partial(block_apply, cfg=cfg, dtype=dtype,
                                flash=flash_attention, tp=tp_group,
                                ep=ep_group if is_moe else None),
        prefill=_not_served if ep_only else functools.partial(
            block_prefill, cfg=cfg, dtype=dtype, flash=flash_attention,
            tp=tp_group),
        decode=_not_served if ep_only else functools.partial(
            block_decode, cfg=cfg, dtype=dtype, tp=tp_group),
        cache_shapes=functools.partial(_cache_shapes, cfg,
                                       kv_heads=kv_heads),
        # routing capacity depends on the tokens routed together, so a
        # chunked prompt would not drop what the whole prompt drops; MLA's
        # absorbed decode sums in another order than its prefill
        append=(None if is_moe or cfg.attention == "mla" or ep_only else
                functools.partial(block_append, cfg=cfg, dtype=dtype,
                                  tp=tp_group)))
        for name, n, is_moe, _ in segs)

    def input_specs(cell):
        spec = lm_input_specs(cell)
        if is_vlm and cfg.num_prefix_embeddings:
            spec["patch_embeds"] = ((cell.global_batch,
                                     cfg.num_prefix_embeddings,
                                     cfg.d_model), dtype)
        return spec

    return ModelBundle(cfg=cfg, device=torch.device(device), dtype=dtype,
                       init_params=init_params, embed=embed,
                       segments=segments,
                       head_logits=_not_served if ep_only else head_logits,
                       head_loss=head_loss,
                       flash_attention=flash_attention,
                       ragged_prefill_ok=mc is None,
                       input_specs=input_specs, tp=tp_group, ep=ep_group)
