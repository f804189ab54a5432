"""LoRA / QLoRA / plain low-rank factorization baselines (the paper's
Tables 1, 3 and 4; the counterpart of ``repro/models/lora.py``).

These transform the model, where GaLore projects the optimizer:

* ``lora``: W = W0 (frozen) + (alpha / r) A B; A and B are trained;
* ``qlora``: the same over an INT8 W0 (a frozen quantized base);
* ``factorized``: W = U V from scratch (the paper's "Low-Rank" row).

Training merges the adapters into a virtual weight tree and reuses the
bundle's loss. These are plain tensor functions: the reference computes
them outside any kernel. Adapters are keyed by the leaf's path
(``['seg0_dense']['attn']['wq']``), as the reference's ``keystr``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.core import qgalore, quant


def _eligible(path: str, leaf) -> bool:
    # 2-D matrices and layer-stacked (L, m, n) ones take adapters (one
    # (L, m, r) / (L, r, n) pair per stacked leaf)
    if len(leaf.shape) not in (2, 3):
        return False
    p = path.lower()
    return not any(k in p for k in ("embed", "head", "norm"))


def init_adapters(params, rank: int, gen: torch.Generator,
                  mode: str = "lora") -> Dict[str, Dict[str, torch.Tensor]]:
    """``{path: {"A", "B"}}`` (``mode="factorized"``: ``{"U", "V"}``) for
    every eligible 2-D or layer-stacked 3-D leaf, float32 on the leaf's
    device, drawn from ``gen`` in flat order: A ~ N(0, 1) / sqrt(m) with B
    zero; U ~ N(0, 1) / sqrt(m), V ~ N(0, 1) / sqrt(r)."""
    out = {}
    for keys, leaf in qgalore.flatten(params):
        path = qgalore.keystr(keys)
        if not _eligible(path, leaf):
            continue
        dev = qgalore.leaf_device(leaf)
        lead = tuple(leaf.shape[:-2])
        m, n = leaf.shape[-2], leaf.shape[-1]
        r = min(rank, m, n)
        normal = lambda *shape: torch.randn(shape, generator=gen,
                                            dtype=torch.float32, device=dev)
        if mode == "factorized":
            out[path] = {"U": normal(*lead, m, r) / math.sqrt(m),
                         "V": normal(*lead, r, n) / math.sqrt(r)}
        else:
            out[path] = {"A": normal(*lead, m, r) / math.sqrt(m),
                         "B": torch.zeros(lead + (r, n), device=dev)}
    return out


def merge(params, adapters: Dict, alpha: float = 32.0, rank: int = 16,
          mode: str = "lora"):
    """The virtual weight tree: every QTensor dequantized, and each adapted
    leaf the float32 base plus ``(alpha / r) A @ B`` (broadcast over the
    stack dimension; ``r`` is A's last axis), or ``U @ V`` when
    factorized. ``rank`` is the reference's argument and is not read."""
    flat = qgalore.flatten(params)
    leaves = []
    for keys, leaf in flat:
        ad = adapters.get(qgalore.keystr(keys))
        is_q = isinstance(leaf, quant.QTensor)
        if ad is None:
            leaves.append(quant.dequantize(leaf) if is_q else leaf)
        elif mode == "factorized":
            leaves.append((ad["U"] @ ad["V"]).to(torch.float32))
        else:
            base = quant.dequantize(leaf, torch.float32) if is_q \
                else leaf.to(torch.float32)
            r = ad["A"].shape[-1]
            leaves.append(base + (alpha / r) * (ad["A"] @ ad["B"]))
    return qgalore.unflatten([k for k, _ in flat], leaves)


def adapter_nbytes(adapters) -> int:
    return sum(t.numel() * t.element_size()
               for pair in adapters.values() for t in pair.values())
