"""Deterministic synthetic LM batches (the counterpart of
``repro/data/synthetic.py``).

The batch at step ``s`` is a pure function of ``(seed, s)``: a Markov
stream through a fixed successor table (numpy, the JAX package's own
table for the same seed) with 10% uniform noise tokens, and for a VLM
bundle the prefix's ``patch_embeds`` (``normal * 0.5``, the stub of the
vision frontend) or for an encoder-decoder its ``frames`` (the audio
frontend's stub, drawn alike), as the bundle's ``input_specs`` names
them. The draws come from a ``torch.Generator``, so they
differ from the JAX package's; tests that compare the two hand the
reference's batches to both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


class SyntheticLM:
    """Deterministic, skip-anywhere LM batches, made on ``device``."""

    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        succ = rng.integers(0, v, size=(min(v, 4096), 4), dtype=np.int32)
        self._succ = torch.from_numpy(succ).long().to(self.device)

    def batch_at(self, step: int, embeds: Optional[Dict] = None
                 ) -> Dict[str, torch.Tensor]:
        """The batch at ``step``. ``embeds``, ``{name: (shape, dtype)}``,
        adds each ``name`` in ``dtype``, ``normal * 0.5`` drawn after the
        tokens from the same generator, in the order given."""
        cfg = self.cfg
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed * 1_000_003 + step)
        dev = self.device
        start = torch.randint(0, min(V, 4096), (B,), generator=gen,
                              device=dev)
        noise = torch.randint(0, 4, (B, S), generator=gen, device=dev)
        n_succ = self._succ.shape[0]
        toks = torch.empty((B, S), dtype=torch.long, device=dev)
        cur = start
        for t in range(S):
            cur = self._succ[cur % n_succ, noise[:, t]]
            toks[:, t] = cur
        flip = torch.rand((B, S), generator=gen, device=dev) < 0.1
        rand_tok = torch.randint(0, V, (B, S), generator=gen, device=dev)
        tokens = torch.where(flip, rand_tok, toks).to(torch.int32)
        out = {"tokens": tokens, "labels": tokens}
        for name, (shape, dtype) in (embeds or {}).items():
            out[name] = (torch.randn(
                shape, generator=gen, device=dev) * 0.5).to(dtype)
        return out


def batch_for_bundle(bundle, cell, step: int, seed: int = 0):
    """The batch of ``cell``'s shape at ``step``, on the bundle's device:
    the leaves that ``bundle.input_specs(cell)`` names (the JAX package's
    ``input_specs``). Tokens and labels come from the Markov stream at the
    tokens' shape; every other leaf (a modality stub's embeddings) is
    drawn after them."""
    specs = dict(bundle.input_specs(cell))
    (B, S), _ = specs.pop("tokens")
    specs.pop("labels")
    lm = SyntheticLM(DataConfig(vocab_size=bundle.cfg.vocab_size,
                                seq_len=S, global_batch=B, seed=seed),
                     device=bundle.device)
    return lm.batch_at(step, specs)
