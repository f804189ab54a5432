"""The model contract consumed by serving (the counterpart of
``repro/models/base.py``)::

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
from repro_torch.core.quant import QTensor


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

    def seg_key(self, i: int) -> str:
        return f"seg{i}_{self.segments[i].name}"


def layer_params(tree, layer: int):
    """Layer ``layer`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_params(v, layer) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.map(lambda t: t[layer])
    return tree[layer]


def run_segments(bundle: ModelBundle, params, carry, ctx):
    """The full-sequence forward over all segments."""
    for i, seg in enumerate(bundle.segments):
        stack = params[bundle.seg_key(i)]
        for layer in range(seg.n_layers):
            carry = seg.apply(layer_params(stack, layer), carry, ctx)
    return carry
