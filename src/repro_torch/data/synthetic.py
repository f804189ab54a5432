"""Deterministic synthetic LM batches (the counterpart of
``repro/data/synthetic.py``).

The batch at step ``s`` is a pure function of ``(seed, s)``: a Markov
stream through a fixed successor table (numpy, the JAX package's own
table for the same seed) with 10% uniform noise tokens. The draws come from
a ``torch.Generator``, so the tokens differ from the JAX package's; tests
that compare the two hand the reference's batches to both.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

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

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
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
        return {"tokens": tokens, "labels": tokens}


def batch_for_bundle(bundle, cell, step: int, seed: int = 0):
    """The LM batch of ``cell``'s shape at ``step``, on the bundle's
    device."""
    lm = SyntheticLM(DataConfig(vocab_size=bundle.cfg.vocab_size,
                                seq_len=cell.seq_len,
                                global_batch=cell.global_batch, seed=seed),
                     device=bundle.device)
    return lm.batch_at(step)
