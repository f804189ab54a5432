"""The model contract consumed by serving and training (the counterpart
of ``repro/models/base.py``)::

    embed → [segment_0 | segment_1 | ...] → head

Each segment is a stack of identical blocks whose parameter leaves carry a
leading layer axis ``(L, ...)``; the engine walks the layers with a Python
loop and hands each block its slice (:func:`layer_params`). ``carry`` is a
dict holding at least ``h`` (hidden states); ``ctx`` is shared read-only
state (positions, lengths) built by ``embed``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.config import ModelConfig
from repro_torch.core.quant import QTensor, QVirtual


@dataclass(frozen=True)
class SegmentDef:
    name: str
    n_layers: int
    # (layer_params, carry, ctx) -> carry
    apply: Callable
    # (layer_params, carry, ctx) -> (carry, cache_slice)
    prefill: Callable
    # (layer_params, carry, cache_slice, ctx) -> (carry, cache_slice)
    decode: Callable
    # (batch, max_len) -> per-layer cache shapes, each leading with batch
    cache_shapes: Callable


@dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    device: torch.device
    dtype: torch.dtype                     # activation / cache dtype
    init_params: Callable                  # (generator, device=None) -> params
    embed: Callable                        # (params, batch) -> (carry, ctx)
    segments: tuple
    head_logits: Callable                  # (params, carry) -> logits (last pos)
    head_loss: Callable                    # (params, carry, batch) -> (loss, metrics)
    flash_attention: bool = False          # prefill attention via the flash kernel

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
