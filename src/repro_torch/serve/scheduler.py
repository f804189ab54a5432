"""Continuous-batching serving runtime: slot scheduler + KV-cache pool
(the counterpart of ``repro/serve/scheduler.py``). The paged backend
(block pool, radix prefix cache, chunked prefill) is ``serve/paged.py``;
:func:`make_scheduler` picks between them.

* a **KV-cache pool**: one ``DecodeState`` whose batch axis is a fixed set
  of ``num_slots`` slots (cache tensors ``(L, num_slots, max_len, KH,
  hd)``; a recurrent model's states ``(L, num_slots, ...)`` in float32);
* :func:`insert_requests` writes the rows of a group prefill into their
  slots, in place;
* :class:`Scheduler` admits pending requests into free slots (one ragged
  group prefill per admission round; a bundle without
  ``ragged_prefill_ok``, MoE, one unpadded request per prefill), runs one
  batched decode step over the in-flight rows, and retires rows on EOS or
  ``max_new_tokens``.

Rows never interact in a prefill (attention and FFN reduce within a row,
and an MoE prompt is prefilled alone) nor in decode (MoE decode runs at
the drop-free capacity), so under greedy sampling the scheduler emits the
same tokens as the lockstep ``engine.generate``.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import ModelBundle
from repro_torch.serve import engine, shard
from repro_torch.serve.engine import DecodeState


@dataclass
class Request:
    """One generation request: ``tokens`` is the unpadded prompt.

    ``cont`` carries the in-progress :class:`Completion` of a PREEMPTED
    request (paged backend only): the paged scheduler may evict a running
    sequence when the block pool drains and requeue it as a continuation
    whose prompt is the original prompt plus everything emitted so far; on
    re-admission the completion keeps accumulating (greedy decode replays
    the prefix)."""
    rid: int
    tokens: Sequence[int]
    max_new_tokens: int
    eos_id: Optional[int] = None
    cont: Optional["Completion"] = None


@dataclass
class Completion:
    rid: int
    prompt_len: int
    tokens: List[int]                 # generated tokens (eos included)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0              # first token emitted (TTFT anchor)
    t_finish: float = 0.0

    @property
    def latency(self) -> float:
        return self.t_finish - self.t_submit

    @property
    def ttft(self) -> float:
        """Submit → first emitted token. For the slot backend admission and
        first token coincide; the paged backend's chunked prefill separates
        them (``t_admit < t_first``)."""
        return self.t_first - self.t_submit


@dataclass
class _Slot:
    remaining: int = 0
    eos_id: Optional[int] = None
    completion: Optional[Completion] = None
    free: bool = True


# ---------------------------------------------------------------------------
# KV-cache pool
# ---------------------------------------------------------------------------

def init_pool(bundle: ModelBundle, num_slots: int, max_len: int,
              dtype=torch.bfloat16, device=None) -> DecodeState:
    """A zero-filled slot pool: each leaf in its own dtype where the
    segment names one (a recurrent state's float32), else ``dtype``."""
    dev = resolve_device(device)
    caches = {
        bundle.seg_key(i): tuple(
            torch.zeros((seg.n_layers,) + shape, dtype=dt or dtype,
                        device=dev)
            for shape, dt in seg.cache_shapes(num_slots, max_len))
        for i, seg in enumerate(bundle.segments)}
    return DecodeState(caches, torch.zeros((num_slots,), dtype=torch.int32,
                                           device=dev))


def insert_requests(pool: DecodeState, slots, rows: DecodeState
                    ) -> DecodeState:
    """Write the B rows of a prefill state into pool slots ``slots`` (B,),
    IN PLACE (cache tensors at dim 1, ``lengths`` at dim 0; a pool split
    over ranks keeps the part each rank holds, ``shard.SlotLeaf``).
    Returns the pool."""
    idx = torch.as_tensor(slots, dtype=torch.long,
                          device=pool.lengths.device)
    for key, pool_leaves in pool.caches.items():
        for p, r in zip(pool_leaves, rows.caches[key]):
            if isinstance(p, shard.SlotLeaf):
                p.insert(list(slots), r)
            else:
                p[:, idx] = r.to(p.dtype)
    pool.lengths[idx] = rows.lengths.to(pool.lengths.dtype)
    return pool


def build_decode_step(bundle: ModelBundle, temperature: float = 0.0,
                      pad_id: int = 0):
    """One batched decode step over the slot pool.

    ``active`` (B,) masks free slots: their ``lengths`` do not advance (the
    cache write lands on the dead slot's scratch position and is overwritten
    at the next admission) and their token is ``pad_id``."""
    decode = engine.build_decode(bundle)

    def step(params, pool: DecodeState, tokens, active, generator=None):
        logits, new = decode(params, pool, tokens[:, None])
        lengths = torch.where(active, new.lengths, pool.lengths)
        toks = engine.sample(logits, temperature, generator)
        toks = torch.where(active, toks, torch.full_like(toks, pad_id))
        return toks, DecodeState(new.caches, lengths)

    return step


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------

def _bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


class Scheduler:
    """Slot-based continuous-batching scheduler over a model bundle.

    Host-side control (admit / retire / token bookkeeping) around the group
    prefill (pending requests batched, right-padded to a ``prompt_bucket``
    multiple), :func:`insert_requests`, and the batched masked decode
    step. Runs on ``device`` (default ``cuda``, which must be present);
    sampling at ``temperature > 0`` draws from ``generator``.

    ``shardings`` (``shard.pool_sharding``'s partitions) with ``group``
    (the mesh's ``distributed.comm.MeshComms``): this rank holds its
    slices of the pool (``serve/shard.py``) and computes every row; every
    rank runs the same scheduler on the same requests, and at
    ``temperature > 0`` needs a generator seeded alike. A bundle built
    with ``tp_group`` serves on the rank's heads with or without them.
    """

    def __init__(self, bundle: ModelBundle, params, *, num_slots: int,
                 max_len: int, pad_id: int = 0, temperature: float = 0.0,
                 prompt_bucket: int = 16, dtype=None,
                 generator: Optional[torch.Generator] = None, device=None,
                 shardings=None, group=None):
        if shardings is not None:
            shard.check_bundle(bundle)
        if bundle.decode_extras:
            # a pool holds per-slot caches only; ``generate`` serves a
            # bundle whose decode needs state beside them
            raise NotImplementedError(
                "continuous batching requires slot-shaped decode state; "
                f"bundle carries decode_extras={bundle.decode_extras!r}")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.pad_id = pad_id
        self.temperature = temperature
        self.prompt_bucket = prompt_bucket
        self.generator = generator
        self.shardings, self.group = shardings, group
        self.dtype = dtype if dtype is not None else torch.bfloat16
        self._prefill = engine.build_prefill(bundle, max_len, pad_id=None)
        self._step = build_decode_step(bundle, temperature, pad_id)
        self.reset()

    def reset(self) -> None:
        """Clear all serving state (a fresh pool, no requests)."""
        if self.shardings is None:
            self.pool = init_pool(self.bundle, self.num_slots, self.max_len,
                                  self.dtype, self.device)
        else:
            self.pool = shard.placed_slot_pool(
                self.bundle, self.num_slots, self.max_len, self.dtype,
                self.device, self.shardings, self.group)
        self.slots = [_Slot() for _ in range(self.num_slots)]
        self.cur_tokens = np.zeros((self.num_slots,), np.int32)
        self.active = np.zeros((self.num_slots,), bool)
        self.pending: Deque[Request] = deque()
        self._submit_t: Dict[int, float] = {}
        self.completed: List[Completion] = []
        self.stats = {"admitted": 0, "retired": 0, "decode_steps": 0,
                      "prefills": 0, "evictions": 0}

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request; rejects it up front when it cannot fit."""
        L = len(req.tokens)
        if L == 0:
            raise ValueError(
                f"request {req.rid}: empty prompt — every request needs "
                ">= 1 token")
        if L + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {L} + max_new "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}")
        self._submit_t[req.rid] = time.monotonic()
        self.pending.append(req)

    # -- admission ---------------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def _admit_group(self, slot_ids: List[int],
                     group: List[Request]) -> None:
        """Prefill a group as ONE right-padded batch and write every row
        into its slot; per-row ``lengths`` keep padded rows exact. A bundle
        without ragged prefill takes one request at its exact length."""
        B = len(group)
        lens = [len(req.tokens) for req in group]
        if self.bundle.ragged_prefill_ok:
            Lp = min(_bucket(max(lens), self.prompt_bucket), self.max_len)
        else:
            # routing couples padded rows: exact length, one at a time
            if B != 1:
                raise ValueError("padded group admission needs "
                                 "ragged_prefill_ok")
            Lp = lens[0]
        padded = np.full((B, Lp), self.pad_id, np.int32)
        for i, req in enumerate(group):
            padded[i, : lens[i]] = np.asarray(req.tokens, np.int32)
        batch = {"tokens": torch.from_numpy(padded).to(self.device),
                 "lengths": torch.tensor(lens, dtype=torch.int32,
                                         device=self.device)}
        logits, rows = self._prefill(self.params, batch)
        self.stats["prefills"] += 1
        insert_requests(self.pool, slot_ids, rows)
        toks = engine.sample(logits, self.temperature,
                             self.generator).cpu().numpy()
        now = time.monotonic()
        for i, (slot_id, req) in enumerate(zip(slot_ids, group)):
            tok = int(toks[i])
            comp = Completion(rid=req.rid, prompt_len=lens[i],
                              tokens=[tok],
                              t_submit=self._submit_t.pop(req.rid, now),
                              t_admit=now, t_first=now)
            self.stats["admitted"] += 1
            if self._finished(tok, 1, req):
                # done at the first token: the slot never activates
                comp.t_finish = time.monotonic()
                self.completed.append(comp)
                self.stats["retired"] += 1
                continue
            slot = self.slots[slot_id]
            slot.free = False
            slot.remaining = req.max_new_tokens - 1
            slot.eos_id = req.eos_id
            slot.completion = comp
            self.cur_tokens[slot_id] = tok
            self.active[slot_id] = True

    @staticmethod
    def _finished(tok: int, n_emitted: int, req: Request) -> bool:
        return n_emitted >= req.max_new_tokens or \
            (req.eos_id is not None and tok == req.eos_id)

    def _retire(self, slot_id: int) -> None:
        slot = self.slots[slot_id]
        slot.completion.t_finish = time.monotonic()
        self.completed.append(slot.completion)
        slot.free, slot.completion = True, None
        self.active[slot_id] = False
        self.cur_tokens[slot_id] = self.pad_id
        self.stats["retired"] += 1
        self.stats["evictions"] += 1

    # -- the serving loop --------------------------------------------------

    def step(self) -> bool:
        """Admit pending requests into free slots, then run one batched
        decode step. Returns False when idle (nothing active or pending)."""
        free = self._free_slots()
        while free and self.pending:
            n = min(len(free), len(self.pending)) \
                if self.bundle.ragged_prefill_ok else 1
            self._admit_group(free[:n],
                              [self.pending.popleft() for _ in range(n)])
            free = free[n:]

        if not self.active.any():
            return bool(self.pending)

        toks, self.pool = self._step(
            self.params, self.pool,
            torch.from_numpy(self.cur_tokens).to(self.device),
            torch.from_numpy(self.active).to(self.device), self.generator)
        self.stats["decode_steps"] += 1

        toks = toks.cpu().numpy()
        for i, slot in enumerate(self.slots):
            if slot.free:
                continue
            tok = int(toks[i])
            slot.completion.tokens.append(tok)
            slot.remaining -= 1
            if slot.remaining <= 0 or \
                    (slot.eos_id is not None and tok == slot.eos_id):
                self._retire(i)
            else:
                self.cur_tokens[i] = tok
        return True

    def run(self, requests: Sequence[Request] = (),
            arrivals: Optional[Sequence[float]] = None
            ) -> List[Completion]:
        """Drive to completion. ``arrivals``: optional per-request offsets
        (seconds from start); a request joins the queue at its arrival."""
        if arrivals is None:
            for r in requests:
                self.submit(r)
            waiting: List[tuple] = []
        else:
            order = np.argsort(np.asarray(arrivals, float), kind="stable")
            waiting = [(float(arrivals[i]), requests[i]) for i in order]
        t0 = time.monotonic()
        while True:
            now = time.monotonic() - t0
            while waiting and waiting[0][0] <= now:
                _, r = waiting.pop(0)
                self.submit(r)
            busy = self.step()
            if not busy and not waiting:
                break
            if not busy and waiting:
                time.sleep(min(0.001, max(0.0, waiting[0][0] - now)))
        return self.completed


def make_scheduler(bundle: ModelBundle, params, *, backend: str = "auto",
                   num_slots: int, max_len: int, **kw) -> Scheduler:
    """Serving backend selection.

    ``backend``: ``"slot"``, the contiguous per-slot pool above;
    ``"paged"``, the block-pool runtime with radix prefix sharing and
    chunked prefill (``serve/paged.py``, requires ``engine.append_ok``);
    ``"auto"``, paged when the bundle supports it (``engine.append_ok``:
    the dense bundles), slot otherwise (MoE). The slot backend ignores
    the paged-only keywords. At f32 both give the same tokens under greedy decode. At
    bf16 a row's matmuls no longer depend on the rows that share its
    dispatch (``kernels.int8_matmul.plan``), but chunked and one-shot
    prefill still take attention's sums in other orders, and a prompt of
    at most 16 tokens prefilled alone takes the small-M matmul path: so
    near-tied logits may pick other tokens."""
    if backend == "auto":
        backend = "paged" if engine.append_ok(bundle) else "slot"
    if backend == "paged":
        from repro_torch.serve.paged import PagedScheduler
        return PagedScheduler(bundle, params, num_slots=num_slots,
                              max_len=max_len, **kw)
    if backend == "slot":
        kw = {k: v for k, v in kw.items()
              if k not in ("block_size", "num_blocks", "prefill_chunk",
                           "use_radix", "reserve_decode")}
        return Scheduler(bundle, params, num_slots=num_slots,
                         max_len=max_len, **kw)
    raise ValueError(f"unknown serving backend {backend!r} "
                     "(expected 'slot', 'paged', or 'auto')")
