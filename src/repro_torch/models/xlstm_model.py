"""xLSTM language model (the counterpart of ``repro/models/xlstm_model.py``):
one segment ``xlstm`` of ``num_layers // slstm_every`` groups, each group
``slstm_every - 1`` mLSTM blocks stacked on an inner axis, then one sLSTM
block (the paper's xLSTM[a:b] notation).

A group's cache is seven float32 leaves, each leading with the batch axis:
the inner mLSTM stack's ``C (B, n_m, H, dh, dh)``, ``n (B, n_m, H, dh)``
and ``m (B, n_m, H)``, then the sLSTM's ``c, n, h, m (B, d)``. They are
states, not windows along time: prefill never grows them to ``max_len``,
and decode writes them in place. Rows never interact, but a right-padded
prompt would run its state on through the pads, so the bundle prefills
unpadded prompts only (``ragged_prefill_ok`` False) and offers no
chunk-append.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers, xlstm
from repro_torch.models.base import ModelBundle, SegmentDef, layer_params
from repro_torch.models.layers import dense, dense_init, embed_init, \
    rmsnorm, rmsnorm_init
from repro_torch.models.transformer import _draw_by_layer, _map_leaves


def group_init(gen: torch.Generator, cfg: ModelConfig, n_m: int,
               lead: tuple = (), device="cpu") -> dict:
    """A group's leaves stacked on ``lead`` (the group axis); the mLSTM
    leaves carry the inner axis ``n_m`` after it."""
    return {"mlstm": xlstm.mlstm_block_init(gen, cfg, lead + (n_m,),
                                            device),
            "slstm": xlstm.slstm_block_init(gen, cfg, lead, device)}


def _n_inner(cfg: ModelConfig) -> int:
    """mLSTM blocks a group: all but the group's last block."""
    return (cfg.xlstm.slstm_every or cfg.num_layers) - 1


def group_apply(lp, carry, ctx, cfg: ModelConfig, *, dtype):
    h = carry["h"]
    for j in range(_n_inner(cfg)):
        h = xlstm.mlstm_block_apply(layer_params(lp["mlstm"], j), h, cfg,
                                    dtype=dtype)
    h = xlstm.slstm_block_apply(lp["slstm"], h, cfg, dtype=dtype)
    return {**carry, "h": h}


def group_prefill(lp, carry, ctx, cfg: ModelConfig, *, dtype):
    """The group over the prompt; its cache is the final states, the inner
    mLSTM states stacked on axis 1 (batch-major)."""
    h = carry["h"]
    mstates = []
    for j in range(_n_inner(cfg)):
        h, st = xlstm.mlstm_block_apply(layer_params(lp["mlstm"], j), h,
                                        cfg, dtype=dtype, return_cache=True)
        mstates.append(st)
    h, sstate = xlstm.slstm_block_apply(lp["slstm"], h, cfg, dtype=dtype,
                                        return_cache=True)
    cache = tuple(torch.stack(leaf, dim=1) for leaf in zip(*mstates)) \
        + tuple(sstate)
    return {**carry, "h": h}, cache


def group_decode(lp, carry, cache, ctx, cfg: ModelConfig, *, dtype):
    """One token a row; every state is written in place into ``cache``
    (inner block j's mLSTM state through the views ``[:, j]``)."""
    h = carry["h"]
    C, n, m = cache[:3]
    for j in range(_n_inner(cfg)):
        h, _ = xlstm.mlstm_block_decode(
            layer_params(lp["mlstm"], j), h, cfg,
            cache=xlstm.MLSTMState(C[:, j], n[:, j], m[:, j]), dtype=dtype)
    h, _ = xlstm.slstm_block_decode(lp["slstm"], h, cfg,
                                    cache=xlstm.SLSTMState(*cache[3:]),
                                    dtype=dtype)
    return {**carry, "h": h}, cache


def build(cfg: ModelConfig, *, device: torch.device,
          dtype=torch.bfloat16) -> ModelBundle:
    """The xLSTM bundle (one segment ``xlstm``; an untied head)."""
    n_m = _n_inner(cfg)
    n_groups = max(cfg.num_layers // (n_m + 1), 1)

    def init_params(gen: torch.Generator, device_=None, leaf_fn=None,
                    by_layer: bool = False):
        """Float32 parameters drawn from ``gen`` (the JAX package's
        distributions; other numbers): the groups, then the embedding,
        final norm and head. ``leaf_fn(keys, leaf)`` maps each leaf as
        soon as its part is drawn; ``by_layer`` draws the groups one at a
        time (``transformer._draw_by_layer``), other numbers than the
        default draw."""
        dev = device if device_ is None else device_

        def fin(tree, *keys):
            return tree if leaf_fn is None else \
                _map_leaves(tree, leaf_fn, keys)

        key = "seg0_xlstm"
        if by_layer:
            groups = _draw_by_layer(
                lambda: group_init(gen, cfg, n_m, (), dev), n_groups,
                lambda leaf, ks: fin(leaf, key, *ks))
        else:
            groups = fin(group_init(gen, cfg, n_m, (n_groups,), dev), key)
        return {
            key: groups,
            "embedding": fin(embed_init(gen, cfg.vocab_size, cfg.d_model,
                                        device=dev), "embedding"),
            "final_norm": fin(rmsnorm_init(cfg.d_model, device=dev),
                              "final_norm"),
            "head": fin(dense_init(gen, cfg.d_model, cfg.vocab_size,
                                   scale=1.0 / math.sqrt(cfg.d_model),
                                   device=dev), "head"),
        }

    def embed(params, batch):
        return {"h": layers.embed_lookup(params["embedding"],
                                         batch["tokens"], dtype)}, {}

    def cache_shapes(batch: int, max_len: int):
        return xlstm.mlstm_cache_shapes(cfg, batch, (n_m,)) \
            + xlstm.slstm_cache_shapes(cfg, batch)

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

    segment = SegmentDef(
        name="xlstm", n_layers=n_groups,
        apply=functools.partial(group_apply, cfg=cfg, dtype=dtype),
        prefill=functools.partial(group_prefill, cfg=cfg, dtype=dtype),
        decode=functools.partial(group_decode, cfg=cfg, dtype=dtype),
        cache_shapes=cache_shapes)
    return ModelBundle(cfg=cfg, device=torch.device(device), dtype=dtype,
                       init_params=init_params, embed=embed,
                       segments=(segment,), head_logits=head_logits,
                       head_loss=head_loss, ragged_prefill_ok=False)
