"""The model contract consumed by serving and training (the counterpart
of ``repro/models/base.py``)::

    embed → [segment_0 | segment_1 | ...] → head

Each segment is a stack of identical blocks whose parameter leaves carry a
leading layer axis ``(L, ...)``; the engine walks the layers with a Python
loop and hands each block its slice (:func:`layer_params`). ``carry`` is a
dict holding ``h`` (hidden states) and, for an MoE model, ``aux`` (the
routers' load-balance loss, a 0-d float32 that the blocks accumulate and
``head_loss`` adds) and an architecture's own entries (zamba's ``x0``,
the encoder-decoder's ``dec_h`` and ``memory``); ``ctx`` is shared
read-only state (positions, lengths) built by ``embed``. A layer's cache
is a tuple of leaves of any length: GQA's and MLA's pairs, an xLSTM
group's seven states.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant import QTensor, QVirtual


@dataclass(frozen=True)
class SegmentDef:
    name: str
    n_layers: int
    # (layer_params, carry, ctx) -> carry
    apply: Callable
    # (layer_params, carry, ctx) -> (carry, cache_slice); None for a
    # segment that serving runs through ``apply`` alone and that keeps no
    # cache (the encoder of an encoder-decoder)
    prefill: Optional[Callable] = None
    # (layer_params, carry, cache_slice, ctx) -> (carry, cache_slice);
    # None where ``prefill`` is None: decode skips the segment
    decode: Optional[Callable] = None
    # (batch, max_len) -> per-layer cache leaves as ``(shape, dtype)``
    # pairs: every shape leads with the batch axis (a recurrent state
    # too; an inner block stack sits after it), and a dtype of None means
    # the pool's dtype (attention K/V), while a recurrent state names its
    # own (float32), which the pool keeps whatever its dtype
    cache_shapes: Optional[Callable] = None
    # chunk-append (the paged runtime's prefill): (layer_params, carry,
    # cache_slice, ctx) -> (carry, cache_slice), where carry["h"] holds a
    # chunk of C tokens at absolute ctx["positions"] (B, C), the cache
    # already holds every earlier position, and ctx["chunk_mask"] (B, C)
    # marks the valid tokens (padded tail positions write nothing).
    # Appending a prompt chunk by chunk computes what one-shot prefill does.
    append: Optional[Callable] = None
    # (params, carry, ctx) -> carry, run before the segment's first layer
    # in the forward, at prefill and in the per-layer backward (the
    # encoder-decoder's bridge from the encoder to the decoder)
    pre: Optional[Callable] = None


def lm_input_specs(cell) -> dict:
    """A language model's batch for ``cell``: tokens and labels ``(B, S)``
    int32, as ``{name: (shape, dtype)}``."""
    shape = (cell.global_batch, cell.seq_len)
    return {"tokens": (shape, torch.int32), "labels": (shape, torch.int32)}


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype                     # activation / cache dtype
    init_params: Callable                  # (generator, device_=None, leaf_fn=None,
                                           #  by_layer=False) -> params
    embed: Callable                        # (params, batch) -> (carry, ctx)
    segments: tuple
    head_logits: Callable                  # (params, carry) -> logits (last pos)
    head_loss: Callable                    # (params, carry, batch) -> (loss, metrics)
    flash_attention: bool = False          # prefill attention via the flash kernel
    # right-padded (ragged) prefill is exact only when rows cannot interact;
    # capacity-limited MoE routing couples them through the shared expert
    # buffers, so such bundles prefill one unpadded prompt at a time
    ragged_prefill_ok: bool = False
    # decode-time embedding: (params, tokens (B, 1), extras) -> (carry,
    # ctx); None embeds the tokens through ``embed``
    embed_decode: Optional[Callable] = None
    # carry entries that prefill keeps for decode (``DecodeState.extras``:
    # the encoder-decoder's ``memory``)
    decode_extras: tuple = ()
    # (cell) -> {name: (shape, dtype)}: the leaves of a batch of ``cell``'s
    # shape (``data.synthetic.batch_for_bundle`` draws them); a modality
    # stub adds its embeddings (a VLM's ``patch_embeds``, an
    # encoder-decoder's ``frames``) and sets the tokens' length
    input_specs: Callable = lm_input_specs
    # the model group a tensor-parallel bundle's layers sum over, and the
    # group whose ranks each hold a share of an MoE's experts
    # (``distributed.comm.Comm``; ``model_zoo.build(tp_group=,
    # ep_group=)``); None on one rank
    tp: Optional[object] = None
    ep: Optional[object] = None

    def seg_key(self, i: int) -> str:
        return f"seg{i}_{self.segments[i].name}"


def layer_params(tree, layer: int):
    """Layer ``layer`` of a stacked parameter tree (views, no copies);
    None leaves stay None, and a QVirtual's shadow is sliced with its
    codes, so the layer's gradient lands in the stack's shadow."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: layer_params(v, layer) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.map(lambda t: t[layer])
    if isinstance(tree, QVirtual):
        return QVirtual(layer_params(tree.qt, layer), tree.shadow[layer])
    return tree[layer]


def run_segments(bundle: ModelBundle, params, carry, ctx):
    """The full-sequence forward over all segments."""
    for i, seg in enumerate(bundle.segments):
        if seg.pre is not None:
            carry = seg.pre(params, carry, ctx)
        stack = params[bundle.seg_key(i)]
        for layer in range(seg.n_layers):
            carry = seg.apply(layer_params(stack, layer), carry, ctx)
    return carry


def loss_fn(bundle: ModelBundle, params, batch):
    """The training loss of the plain (whole-graph) path: the oracle of the
    fused per-layer backward (``train/stack.py``)."""
    carry, ctx = bundle.embed(params, batch)
    carry = run_segments(bundle, params, carry, ctx)
    return bundle.head_loss(params, carry, batch)
