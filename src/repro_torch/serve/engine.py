"""Serving engine: batched prefill + single-token decode over the segment
contract, with stacked per-layer caches (the counterpart of
``repro/serve/engine.py``).

INT8 QTensor parameters are consumed directly: every matmul streams codes
through ``kernels.ops.quantized_dense``. Caches are ``(L, B, Smax, KH,
hd)`` per segment (MLA's compressed pair ``(L, B, Smax, kv_lora_rank)``
and ``(L, B, Smax, qk_rope_head_dim)``; an xLSTM group's seven float32
states, which have no time axis). Per-row ``lengths`` drive every positional effect
(RoPE, cache write slot, attention mask), so one decode step serves rows
at different positions.

Unlike the JAX engine, decode and append update ``state.caches`` IN
PLACE: the returned state shares its cache tensors with the one passed in.
With a ``capture`` hook (the paged runtime's) the returned state carries
the captured slices instead.
"""
from __future__ import annotations

from types import MappingProxyType
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant import true_div
from repro_torch.device import resolve_device
from repro_torch.models.base import ModelBundle, layer_params


class DecodeState(NamedTuple):
    caches: Dict[str, Any]          # {seg_key: (k, v) stacked per layer}
    lengths: torch.Tensor           # (B,) int32 valid positions
    # carry entries kept from prefill for decode (``decode_extras``: the
    # encoder-decoder's memory); empty, and read-only, for every other
    # bundle
    extras: Mapping[str, Any] = MappingProxyType({})


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
    ``lengths`` until it is overwritten. A bundle without
    ``ragged_prefill_ok`` (MoE: capacity-limited routing couples the rows;
    xLSTM: a recurrent state would run on through the pads) refuses
    ``pad_id``; send it unpadded prompts (full-length ``batch["lengths"]``
    stay legal).

    A segment's ``pre`` runs before its first layer; a segment without
    ``prefill`` (an encoder) runs its layers through ``apply`` and keeps
    no cache. The state's ``extras`` hold the final carry's
    ``bundle.decode_extras`` entries.
    """
    if pad_id is not None and not bundle.ragged_prefill_ok:
        raise ValueError(
            f"{bundle.cfg.name}: ragged (right-padded) prefill is not "
            "exact for this architecture (ragged_prefill_ok=False); "
            "prefill unpadded prompts instead of passing pad_id")

    @torch.no_grad()
    def prefill(params, batch):
        carry, ctx = bundle.embed(params, batch)
        ctx = {**ctx, "max_len": max_len}
        caches: Dict[str, Any] = {}
        for i, seg in enumerate(bundle.segments):
            key = bundle.seg_key(i)
            stack = params[key]
            if seg.pre is not None:
                carry = seg.pre(params, carry, ctx)
            if seg.prefill is None:
                for layer in range(seg.n_layers):
                    carry = seg.apply(layer_params(stack, layer), carry, ctx)
                continue
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
        # a VLM's patch prefix shifts the last position; ``lengths`` stay
        # text-only, as the JAX package records them
        offset = h.shape[1] - tokens.shape[1]
        idx = (lengths.clamp(min=1) - 1 + offset).long()
        rows = torch.arange(h.shape[0], device=h.device)
        h_last = h[rows, idx][:, None]
        logits = bundle.head_logits(params, {**carry, "h": h_last})
        extras = {k: carry[k] for k in bundle.decode_extras}
        return logits, DecodeState(caches, lengths, extras)

    return prefill


def _run_cached(seg, method, stack, caches, carry, ctx, capture):
    """Walk one segment's layers through ``method`` (``seg.decode`` or
    ``seg.append``) on its cache slices (however many leaves a layer
    has); returns the carry and, with ``capture``, each layer's captured
    pytree stacked along a new layer axis (else None: the slices were
    written in place)."""
    captured = []
    for layer in range(seg.n_layers):
        carry, cache = method(layer_params(stack, layer), carry,
                              tuple(c[layer] for c in caches), ctx)
        if capture is not None:
            captured.append(capture(cache, ctx))
    if capture is None:
        return carry, None
    return carry, tuple(torch.stack(c) for c in zip(*captured))


def append_ok(bundle: ModelBundle) -> bool:
    """True when the bundle supports chunk-append prefill, the substrate of
    the paged serving runtime (``serve/paged.py``): ragged prompts are
    exact (``ragged_prefill_ok``: a chunk's tail is right-padded), every
    segment offers ``SegmentDef.append``, and no state persists beside the
    caches (``decode_extras``). An MoE bundle has neither of the first
    two, and an MLA segment has no append (deepseek-v3 lacks both); the
    encoder-decoder has none of the three."""
    return (bundle.ragged_prefill_ok and not bundle.decode_extras
            and all(seg.append is not None for seg in bundle.segments))


def build_append(bundle: ModelBundle, max_len: int, capture=None):
    """Returns ``append(params, state, tokens (B, C), chunk_len (B,)) ->
    (last_logits, new_state)``: chunk-continuation prefill.

    ``state`` already holds the first ``state.lengths`` positions of each
    row; ``tokens`` carries the next chunk (right-padded to C, per-row
    valid count ``chunk_len``). Valid tokens write their K/V at absolute
    positions ``lengths + i`` in place (padded tail positions write
    nothing), queries attend the whole cache under the absolute causal
    mask, and the logits sit at each row's last valid chunk position.
    Running a prompt through ``append`` chunk by chunk computes what
    :func:`build_prefill` does.

    ``capture``: optional ``(new_cache_slice, ctx) -> pytree`` hook applied
    to each layer's updated cache; the returned state then carries the
    captured pytrees, stacked by layer (the paged runtime keeps only the
    chunk's freshly written K/V). ``max_len`` is the window, as for
    :func:`build_prefill`.
    """
    if not append_ok(bundle):
        raise ValueError(
            f"{bundle.cfg.name}: chunk-append prefill requires "
            "row-independent attention segments (SegmentDef.append) — "
            "this bundle must use one-shot prefill")

    @torch.no_grad()
    def append(params, state: DecodeState, tokens, chunk_len):
        B, C = tokens.shape
        if C == 1:
            # as the JAX engine: a width-1 chunk runs at width 2 (the pad
            # position is masked and writes nothing), so the capture
            # width the paged write plan reads is 2
            tokens = F.pad(tokens, (0, 1))
            C = 2
        carry, _ = bundle.embed(params, {"tokens": tokens})
        base = state.lengths.to(torch.int32)
        chunk_len = chunk_len.to(torch.int32)
        cols = torch.arange(C, dtype=torch.int32, device=tokens.device)
        ctx = {"length": base, "positions": base[:, None] + cols[None],
               "chunk_mask": cols[None] < chunk_len[:, None],
               "max_len": max_len}
        new_caches: Dict[str, Any] = {}
        for i, seg in enumerate(bundle.segments):
            key = bundle.seg_key(i)
            carry, got = _run_cached(seg, seg.append, params[key],
                                     state.caches[key], carry, ctx, capture)
            new_caches[key] = state.caches[key] if got is None else got
        h = carry["h"]
        rows = torch.arange(B, device=h.device)
        h_last = h[rows, (chunk_len.clamp(min=1) - 1).long()][:, None]
        logits = bundle.head_logits(params, {**carry, "h": h_last})
        return logits, DecodeState(new_caches, base + chunk_len,
                                   state.extras)

    return append


def build_decode(bundle: ModelBundle, capture=None):
    """Returns ``decode(params, state, tokens (B, 1)) -> (logits,
    new_state)``; ``state.caches`` are written in place.

    The tokens are embedded through ``bundle.embed_decode`` beside
    ``state.extras`` where the bundle has one (the encoder-decoder: its
    ``embed`` needs the frames), else through ``embed``. Segments without
    ``decode`` or without a cache in the state (an encoder) are skipped,
    and their ``pre`` with them: the extras carry what it made.

    ``capture``: optional ``(new_cache_slice, ctx) -> pytree`` hook, as in
    :func:`build_append`: the returned state's caches are then the
    captured pytrees (e.g. just this step's K/V), stacked by layer."""
    @torch.no_grad()
    def decode(params, state: DecodeState, tokens):
        if bundle.embed_decode is not None:
            carry, ctx = bundle.embed_decode(params, tokens, state.extras)
        else:
            carry, ctx = bundle.embed(params, {"tokens": tokens})
        ctx = {**ctx, "length": state.lengths}
        new_caches: Dict[str, Any] = {}
        for i, seg in enumerate(bundle.segments):
            key = bundle.seg_key(i)
            if seg.decode is None or key not in state.caches:
                continue
            carry, got = _run_cached(seg, seg.decode, params[key],
                                     state.caches[key], carry, ctx, capture)
            new_caches[key] = state.caches[key] if got is None else got
        logits = bundle.head_logits(params, carry)
        return logits, DecodeState(new_caches, state.lengths + 1,
                                   state.extras)

    return decode


def abstract_decode_state(bundle: ModelBundle, batch: int, max_len: int,
                          dtype=torch.bfloat16) -> DecodeState:
    """The decode state's layout with nothing allocated: every leaf a
    tensor on the ``meta`` device, of its shape and dtype (each segment
    with a decode and a cache; the encoder-decoder's ``memory`` extra of
    ``max(max_len // DEC_RATIO, 16)`` frames, as the JAX package's)."""
    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    caches = {
        bundle.seg_key(i): tuple(meta((seg.n_layers,) + tuple(shape),
                                      dt or dtype)
                                 for shape, dt in seg.cache_shapes(batch,
                                                                   max_len))
        for i, seg in enumerate(bundle.segments)
        if seg.cache_shapes is not None and seg.decode is not None}
    extras = {}
    if "memory" in bundle.decode_extras:
        from repro_torch.models.encdec import DEC_RATIO
        extras["memory"] = meta(
            (batch, max(max_len // DEC_RATIO, 16), bundle.cfg.d_model), dtype)
    return DecodeState(caches, meta((batch,), torch.int32), extras)


def sample(logits: torch.Tensor, temperature: float = 0.0,
           generator: Optional[torch.Generator] = None,
           noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Greedy (T=0) or temperature sampling on (B, 1, V) logits → (B,)
    int32. Sampling draws from ``generator``; with ``noise``, standard
    Gumbel draws (B, V) handed over, it takes ``argmax(logits / T +
    noise)`` instead: the Gumbel-max form of the JAX package's
    ``jax.random.categorical``, so the reference's draws give its
    tokens."""
    lf = logits[:, -1, :].to(torch.float32)
    if temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    if noise is not None:
        return torch.argmax(true_div(lf, temperature)
                            + noise.to(lf.device, torch.float32),
                            dim=-1).to(torch.int32)
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
