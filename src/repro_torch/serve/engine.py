"""Serving engine: batched prefill + single-token decode over the segment
contract, with stacked per-layer caches (the counterpart of
``repro/serve/engine.py``).

INT8 QTensor parameters are consumed directly: every matmul streams codes
through ``kernels.ops.quantized_dense``. Caches are ``(L, B, Smax, KH,
hd)`` per segment. Per-row ``lengths`` drive every positional effect
(RoPE, cache write slot, attention mask), so one decode step serves rows
at different positions.

Unlike the JAX engine, decode updates ``state.caches`` IN PLACE: the
returned state shares its cache tensors with the one passed in.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import ModelBundle, layer_params


class DecodeState(NamedTuple):
    caches: Dict[str, Any]          # {seg_key: (k, v) stacked per layer}
    lengths: torch.Tensor           # (B,) int32 valid positions


def prompt_lengths(tokens: torch.Tensor, pad_id: Optional[int]
                   ) -> torch.Tensor:
    """Per-row valid length of a right-padded (B, S) batch: S minus the
    trailing run of ``pad_id`` (pads inside the prompt are content)."""
    B, S = tokens.shape
    if pad_id is None:
        return torch.full((B,), S, dtype=torch.int32, device=tokens.device)
    is_pad = (tokens.flip(1) == pad_id).to(torch.int32)
    trailing = torch.cumprod(is_pad, dim=1).sum(dim=1)
    return (S - trailing).to(torch.int32)


def check_prompt_lengths(batch, pad_id: Optional[int]) -> None:
    """Raise on any row with zero valid tokens."""
    if "lengths" in batch:
        lens = torch.as_tensor(batch["lengths"]).cpu()
    else:
        lens = prompt_lengths(torch.as_tensor(batch["tokens"]), pad_id).cpu()
    if (lens <= 0).any():
        bad = torch.nonzero(lens <= 0).flatten().tolist()
        raise ValueError(
            f"empty prompt row(s) {bad}: every row needs >= 1 valid "
            "token (an all-pad row would decode from garbage logits)")


def build_prefill(bundle: ModelBundle, max_len: int,
                  pad_id: Optional[int] = None):
    """Returns ``prefill(params, batch) -> (last_logits, DecodeState)``.

    Ragged (right-padded) prompts: per-row lengths come from
    ``batch["lengths"]`` when present, else from the trailing-``pad_id``
    run. Logits are taken at each row's last valid position (clamped to
    position 0 for an empty row); causal attention keeps the pads (to the
    right) out of valid positions, and decode masks their K/V beyond
    ``lengths`` until it is overwritten.
    """
    @torch.no_grad()
    def prefill(params, batch):
        carry, ctx = bundle.embed(params, batch)
        ctx = {**ctx, "max_len": max_len}
        caches: Dict[str, Any] = {}
        for i, seg in enumerate(bundle.segments):
            key = bundle.seg_key(i)
            stack = params[key]
            per_layer = []
            for layer in range(seg.n_layers):
                carry, cache = seg.prefill(layer_params(stack, layer),
                                           carry, ctx)
                per_layer.append(cache)
            caches[key] = tuple(torch.stack(c) for c in zip(*per_layer))
            del per_layer
        tokens = batch["tokens"]
        if "lengths" in batch:
            lengths = batch["lengths"].to(torch.int32)
        else:
            lengths = prompt_lengths(tokens, pad_id)
        h = carry["h"]
        offset = h.shape[1] - tokens.shape[1]
        idx = (lengths.clamp(min=1) - 1 + offset).long()
        rows = torch.arange(h.shape[0], device=h.device)
        h_last = h[rows, idx][:, None]
        logits = bundle.head_logits(params, {**carry, "h": h_last})
        return logits, DecodeState(caches, lengths)

    return prefill


def build_decode(bundle: ModelBundle):
    """Returns ``decode(params, state, tokens (B, 1)) -> (logits,
    new_state)``; ``state.caches`` are written in place."""
    @torch.no_grad()
    def decode(params, state: DecodeState, tokens):
        carry, ctx = bundle.embed(params, {"tokens": tokens})
        ctx = {**ctx, "length": state.lengths}
        for i, seg in enumerate(bundle.segments):
            key = bundle.seg_key(i)
            stack, (kc, vc) = params[key], state.caches[key]
            for layer in range(seg.n_layers):
                carry, _ = seg.decode(layer_params(stack, layer), carry,
                                      (kc[layer], vc[layer]), ctx)
        logits = bundle.head_logits(params, carry)
        return logits, DecodeState(state.caches, state.lengths + 1)

    return decode


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling on (B, 1, V) logits → (B,)
    int32. Sampling draws from ``generator``."""
    lf = logits[:, -1, :].to(torch.float32)
    if temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    probs = torch.softmax(lf / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def generate(bundle: ModelBundle, params, batch, *, steps: int,
             max_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None, pad_id: Optional[int] = None,
             device=None):
    """Prefill + ``steps`` decode steps (host loop) on ``device`` (default
    ``cuda``, which must be present).

    ``eos_id``: rows that emit it are retired — later emissions are
    ``pad_id`` (default 0) and their cache length freezes. Ragged prompts:
    pass ``batch["lengths"]`` or ``pad_id``. Returns ``(tokens (B,
    steps+1), final DecodeState)``.
    """
    dev = resolve_device(device)
    check_prompt_lengths(batch, pad_id)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    prefill = build_prefill(bundle, max_len, pad_id=pad_id)
    decode = build_decode(bundle)
    logits, state = prefill(params, batch)
    pad = 0 if pad_id is None else pad_id
    toks = []
    tok = sample(logits, temperature, generator)
    done = torch.zeros(tok.shape, dtype=torch.bool, device=dev)
    for _ in range(steps):
        toks.append(tok)
        prev_lengths = state.lengths
        logits, state = decode(params, state, tok[:, None])
        next_tok = sample(logits, temperature, generator)
        if eos_id is not None:
            done = done | (tok == eos_id)
            next_tok = torch.where(done, torch.full_like(next_tok, pad),
                                   next_tok)
            state = state._replace(
                lengths=torch.where(done, prev_lengths, state.lengths))
        tok = next_tok
    toks.append(tok)
    return torch.stack(toks, dim=1), state
