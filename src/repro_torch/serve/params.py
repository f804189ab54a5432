"""Serving parameters: INT8 quantization of a float tree, and import of
the JAX package's parameters.

``prepare_params`` is the counterpart of ``repro/train/step.py::
prepare_params`` for the default Q-GaLore recipe (INT8 symmetric weights,
256-blocks); ``from_jax_params`` turns the JAX package's params, handed
over as numpy, into the port's, so both packages compute on the same codes;
``from_jax_state`` does the same for a whole training state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.adam8bit import Adam8bitState
from repro_torch.core.qgalore import QGaLoreState, flatten
from repro_torch.device import resolve_device


def quantize_leaf(leaf: torch.Tensor, block: int = quant.DEFAULT_BLOCK):
    """A symmetric INT8 QTensor for a leaf with ``ndim >= 2`` and a last
    axis of at least 32, on the leaf's device; other leaves as they are.
    Blocks run along the last axis, so quantizing each layer of a stacked
    leaf gives the stack's codes and scales (``init_params(by_layer=
    True)`` relies on it)."""
    if leaf.ndim >= 2 and leaf.shape[-1] >= 32:
        return quant.quantize_blockwise(leaf, bits=8, block=block,
                                        symmetric=True)
    return leaf


def prepare_params(params, device=None, block: int = quant.DEFAULT_BLOCK):
    """Quantize every leaf with ``ndim >= 2`` and a last axis of at least
    32 to a symmetric INT8 QTensor; other leaves (1-D norms) stay float32.

    Leaves move to ``device`` (default ``cuda``, which must be present) one
    at a time and are quantized there, so the device never holds more than
    one float leaf: a float tree kept on the CPU serves a model whose
    float32 weights would not fit the card beside its INT8 copy.
    """
    dev = resolve_device(device)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return quantize_leaf(tree.to(dev), block)

    return walk(params)


def from_jax_params(tree, device=None):
    """The JAX package's params as the port's, on ``device``.

    ``tree`` is a nested dict whose leaves are numpy arrays (float leaves)
    or ``(q, scale, zero, bits, block, orig_last, dtype)`` tuples (QTensor
    leaves, as ``repro_torch.core.quant.to_numpy`` writes them)."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, tuple):
            return quant.from_numpy(t, dev)
        return torch.from_numpy(np.array(t)).to(dev)

    return walk(tree)


def from_jax_state(state, device=None):
    """The JAX package's ``TrainState`` as the port's
    (``train.step.TrainState``), on ``device``.

    ``state`` is a dict of numpy trees: ``params`` (as for
    :func:`from_jax_params`), ``inner`` (a tree like ``params`` whose leaves
    are ``(m, v)`` pairs, each a QTensor tuple or a float array, or None for
a frozen leaf), ``proj``
    (QTensor tuples, float arrays or None per leaf) and ``count``."""
    # train.step imports this module (quantize_leaf)
    from repro_torch.train.step import TrainState
    dev = resolve_device(device)

    def one(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            return quant.from_numpy(t, dev)
        return torch.from_numpy(np.array(t)).to(dev)

    inner = [None if mv is None else Adam8bitState(one(mv[0]), one(mv[1]))
             for _, mv in flatten(state["inner"])]
    proj = [one(p) for _, p in flatten(state["proj"])]
    return TrainState(from_jax_params(state["params"], dev),
                      QGaLoreState(inner, proj, int(state["count"])))
