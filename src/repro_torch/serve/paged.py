"""Paged serving runtime: block KV pool + radix prefix sharing + chunked
prefill (the counterpart of ``repro/serve/paged.py``).

The slot scheduler (``serve/scheduler.py``) reserves ``max_len`` contiguous
KV positions per slot: memory scales with the worst case, a shared system
prompt is prefilled again for every request, and a long prompt's one-shot
prefill stalls every in-flight decode. This module keeps the scheduler's
continuous-batching control flow and swaps the pool for pages:

* **Block pool**: cache tensors are ``(L, num_blocks, block_size, KH,
  hd)`` (``SegmentDef.cache_shapes`` with the block axis where the batch
  axis sits). A host-side ``(num_slots, MB)`` **block table** maps each
  slot's logical KV positions to physical blocks; :class:`BlockAllocator`
  hands blocks out of a free list with refcounts (shared blocks live until
  the last user derefs). Physical block 0 is reserved **scratch**:
  unallocated table entries and dead-slot writes land there, so the step
  programs never branch on allocation state.
* **Gather + two-phase write**: a step gathers each slot's blocks into a
  contiguous ``(S, MB·block_size, KH, hd)`` view, ONE LAYER AT A TIME
  inside the engine's layer loop (the reference gathers the whole
  ``(L, S, ...)`` stack at once; the numbers are the same and the peak is
  one layer's view), and runs the unmodified ``engine.build_decode`` /
  ``engine.build_append`` over it. The views are copies, so the step is
  read-only on the pool: the ``capture=`` hook keeps just the freshly
  written K/V of each layer, and :func:`pool_write_kv` writes them at a
  flat ``(physical block, offset)`` write plan afterwards. Shared prefix
  blocks are never written: a slot's write position is always at or past
  its private suffix.
* **Radix prefix cache** (``serve/radix.py``): admission maps matched
  blocks straight into the new slot's table (+1 ref each) and prefill
  starts after them. Matching is capped one token short of the prompt so
  that at least one suffix token runs through prefill (the first-token
  logits must be produced). When the free list drains, LRU trie leaves
  with no other users are evicted; if the pool is still dry mid-decode,
  the youngest running slot is **preempted**: its blocks are freed and
  the request requeued as a continuation (prompt + emitted tokens, see
  ``Request.cont``).
* **Chunked prefill**: prompts run through ``engine.build_append`` in
  fixed-width chunks, one chunk per prefilling slot per scheduler step in
  ONE batched dispatch, fused with the batched decode step when both have
  work. Prefilling rows are compacted to a power-of-two bucket before
  dispatch, so append compute scales with live prefill rows, not pool
  size. Chunked append computes what one-shot prefill does, so the paged
  scheduler gives the slot scheduler's tokens under greedy decode.

Admission backpressure: ``submit`` raises only for requests that can
NEVER fit (window or whole-pool bound); a momentarily full pool queues
(``stats["admission_blocked"]`` counts deferrals).

Sampling at ``temperature > 0`` draws from the scheduler's
``torch.Generator`` (the reference folds a key per admission).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import HeldWindow
from repro_torch.models.base import ModelBundle
from repro_torch.serve import engine, shard
from repro_torch.serve.engine import DecodeState
from repro_torch.serve.radix import RadixCache
from repro_torch.serve.scheduler import Completion, Request, Scheduler


# ---------------------------------------------------------------------------
# Block allocator
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Refcounted free-list allocator over ``num_blocks`` physical blocks.

    Block 0 is reserved scratch (pinned, never allocated): unallocated
    block-table entries point at it so gathers and writes at dead or
    not-yet-filled positions stay in bounds without branching.

    Invariant (property-tested): every block is either scratch, on the
    free list with refcount 0, or allocated with refcount >= 1; derefs
    below zero and refs of free blocks raise instead of corrupting the
    pool.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (scratch + 1 usable), "
                             f"got {num_blocks}")
        self.num_blocks = num_blocks
        self.refcount = np.zeros((num_blocks,), np.int32)
        self.refcount[0] = 1                      # scratch, pinned forever
        self._free = deque(range(1, num_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1

    def alloc(self) -> Optional[int]:
        """Pop a free block (refcount 1) or None when the pool is dry."""
        if not self._free:
            return None
        p = self._free.popleft()
        self.refcount[p] = 1
        return p

    def ref(self, p: int) -> None:
        """Add a reference to a LIVE block (prefix sharing)."""
        if p == 0:
            raise ValueError("block 0 is scratch — never share it")
        if self.refcount[p] <= 0:
            raise ValueError(f"ref of free block {p}")
        self.refcount[p] += 1

    def deref(self, p: int) -> None:
        """Drop a reference; the block returns to the free list at zero."""
        if p == 0:
            raise ValueError("block 0 is scratch — never free it")
        if self.refcount[p] <= 0:
            raise ValueError(f"double free of block {p}")
        self.refcount[p] -= 1
        if self.refcount[p] == 0:
            self._free.append(p)

    def reset(self) -> None:
        self.refcount[:] = 0
        self.refcount[0] = 1
        self._free = deque(range(1, self.num_blocks))

    def check(self) -> None:
        """Raise unless the pool invariant holds."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate blocks on the free list")
        for p in range(1, self.num_blocks):
            rc = int(self.refcount[p])
            if (p in free) != (rc == 0):
                raise AssertionError(
                    f"block {p}: refcount {rc} vs free-list "
                    f"{'present' if p in free else 'absent'}")


# ---------------------------------------------------------------------------
# Step programs: gather views → engine step → write plan
# ---------------------------------------------------------------------------

class _LayerGather:
    """One pool leaf ``(L, NB, blk, …)`` seen through block tables
    ``(S, MB)``: indexing with a layer gathers that layer's contiguous
    per-slot view ``(S, MB·blk, …)`` (a copy). Row-major gather order puts
    block m's positions at view offset ``m·blk``, the slot's logical KV
    timeline."""

    def __init__(self, leaf: torch.Tensor, tables: torch.Tensor, MB: int,
                 block_size: int):
        self.leaf, self.flat = leaf, tables.reshape(-1).long()
        self.shape = (tables.shape[0], MB * block_size) \
            + tuple(leaf.shape[3:])

    def __getitem__(self, layer: int) -> torch.Tensor:
        return self.leaf[layer].index_select(0, self.flat) \
            .reshape(self.shape)


def _gather_views(caches, tables, MB: int, block_size: int):
    """Per-slot contiguous views of the block pool: every leaf ``(L, NB,
    blk, …)`` with tables ``(S, MB)`` becomes a layer-indexable
    ``(L, S, MB·blk, …)`` whose layers are gathered when the engine's
    layer loop reaches them (a pool split over ranks: each layer's
    ``HeldWindow`` of the rank's part, ``shard.PagedLeaf.view``)."""
    return {k: tuple(leaf.view(tables, MB)
                     if isinstance(leaf, shard.PagedLeaf)
                     else _LayerGather(leaf, tables, MB, block_size)
                     for leaf in c) for k, c in caches.items()}


def _take_pos(leaf, pos):
    """Gather positions ``pos`` (B, P) out of a cache leaf (B, T, …) →
    (B, P, …): the freshly written K/V of this step."""
    idx = pos.clamp(max=leaf.shape[1] - 1).long()
    idx = idx.view(pos.shape + (1,) * (leaf.ndim - 2))
    return leaf.gather(1, idx.expand(pos.shape + leaf.shape[2:]))


def _fresh(leaf, pos):
    """What a step wrote at ``pos`` (B, P) of an updated cache leaf: a
    ``HeldWindow`` (a pool split over ranks) keeps every row's, whose
    positions this rank may not hold."""
    return leaf.fresh if isinstance(leaf, HeldWindow) else \
        _take_pos(leaf, pos)


def _capture_decode(new_cache, ctx):
    """Engine ``capture`` hook: keep only position ``length`` of each
    updated cache leaf, the one K/V this decode step wrote."""
    pos = ctx["length"][:, None]
    return tuple(_fresh(leaf, pos) for leaf in new_cache)


def _capture_append(new_cache, ctx):
    """Engine ``capture`` hook: keep only the chunk's absolute positions
    of each updated cache leaf, the C K/Vs this append chunk wrote (masked
    tail columns carry garbage; the write plan sends them to scratch)."""
    pos = ctx["positions"]
    return tuple(_fresh(leaf, pos) for leaf in new_cache)


def _flatten_kv(captured):
    """Captured leaves (L, B, P, …) → (L, B·P, …), row-major: the layout
    :func:`pool_write_kv` expects alongside flat ``phys``/``off``."""
    return {k: tuple(leaf.reshape((leaf.shape[0], -1) + leaf.shape[3:])
                     for leaf in c) for k, c in captured.items()}


def _append_write_plan(tables_g, base, chunk_len, C: int, block_size: int,
                       MB: int):
    """Pool targets for a chunk append: position ``base + i`` of row r
    lands in block ``tables_g[r, (base+i)//blk]`` at offset ``%blk``;
    columns past ``chunk_len`` (and padded rows) go to scratch block 0.
    Returns flat ``phys``/``off`` (g·C,) in capture order."""
    cols = torch.arange(C, dtype=torch.int32, device=base.device)
    pos = (base[:, None] + cols[None]).clamp(0, MB * block_size - 1)
    valid = cols[None] < chunk_len[:, None]
    phys = tables_g.gather(1, (pos // block_size).long())
    phys = torch.where(valid, phys, torch.zeros_like(phys))
    return phys.reshape(-1), (pos % block_size).reshape(-1)


def pool_write_kv(caches, phys, off, kvs):
    """Phase-2 pool write, in place: set K/V at (block ``phys``, offset
    ``off``); ``kvs`` leaves (L, N, …) against pool leaves (L, NB, blk,
    …). Entries bound for scratch may collide at block 0, whose content is
    dead; every other target is written once. A pool split over ranks
    keeps the targets this rank holds (``shard.PagedLeaf.write``).
    Returns ``caches``."""
    p, o = phys.long(), off.long()
    for key, leaves in caches.items():
        for big, kv in zip(leaves, kvs[key]):
            if isinstance(big, shard.PagedLeaf):
                big.write(p, o, kv)
            else:
                big[:, p, o] = kv.to(big.dtype)
    return caches


def _decode_plan(tables, lengths, active, block_size: int, MB: int):
    """Pool target of each slot's decode write: the block holding position
    ``lengths``; inactive slots go to scratch block 0."""
    pos = lengths.to(torch.int32).clamp(0, MB * block_size - 1)
    phys = tables.gather(1, (pos // block_size).long()[:, None])[:, 0]
    phys = torch.where(active, phys, torch.zeros_like(phys))
    return phys, pos % block_size


def build_paged_decode_step(bundle: ModelBundle, block_size: int, MB: int,
                            temperature: float = 0.0, pad_id: int = 0):
    """One batched decode step over the block pool.

    Gathers each slot's view (per layer), runs ``engine.build_decode`` on
    it (per-slot ``lengths`` mask exactly as in the slot pool: scratch
    garbage beyond ``lengths`` adds exact zeros), and returns the ONE K/V
    each slot wrote plus its pool target for :func:`pool_write_kv`.
    Inactive slots write to scratch block 0. The pool is read-only here.
    """
    decode = engine.build_decode(bundle, capture=_capture_decode)

    def step(params, caches, tables, lengths, tokens, active,
             generator=None):
        views = _gather_views(caches, tables, MB, block_size)
        logits, new = decode(params, DecodeState(views, lengths),
                             tokens[:, None])
        toks = engine.sample(logits, temperature, generator)
        toks = torch.where(active, toks, torch.full_like(toks, pad_id))
        phys, off = _decode_plan(tables, lengths, active, block_size, MB)
        new_lengths = lengths + active.to(lengths.dtype)
        return toks, new_lengths, phys, off, _flatten_kv(new.caches)

    return step


def _run_append(append, params, caches, tables, lengths, psids, tokens,
                chunk_len, block_size: int, MB: int, temperature: float,
                generator):
    """The append half of a paged dispatch over the compacted rows
    ``psids``: logits → first tokens, the new lengths, the write plan and
    the captured K/V."""
    psids = psids.long()
    tables_g = tables.index_select(0, psids)                # (g, MB)
    base = lengths.index_select(0, psids).to(torch.int32)
    views = _gather_views(caches, tables_g, MB, block_size)
    logits, new = append(params, DecodeState(views, base), tokens,
                         chunk_len)
    toks = engine.sample(logits, temperature, generator)
    # capture width: the engine pads width-1 chunks to 2
    C = next(iter(new.caches.values()))[0].shape[2]
    phys, off = _append_write_plan(tables_g, base, chunk_len, C,
                                   block_size, MB)
    # padded rows repeat slot 0 with chunk_len 0: index_add_ sums the
    # duplicates, where an indexed ``+=`` would keep only one of them
    new_lengths = lengths.clone().index_add_(
        0, psids, chunk_len.to(lengths.dtype))
    return toks, new_lengths, phys, off, _flatten_kv(new.caches)


def build_paged_append(bundle: ModelBundle, block_size: int, MB: int,
                       chunk: int, temperature: float = 0.0):
    """One BATCHED chunk of paged prefill over a COMPACTED row set: the
    ``g`` prefilling slots named by ``psids`` advance up to ``chunk``
    tokens in a single dispatch.

    The host buckets ``g`` to the next power of two and pads ``psids``
    with slot 0 / ``chunk_len 0`` rows, which compute garbage that is
    masked and written to scratch. Gathers only the compacted rows' views,
    runs ``engine.build_append`` with per-row ``chunk_len``, and returns
    the chunk's freshly written K/Vs plus their pool targets for
    :func:`pool_write_kv`. Radix-shared prefix blocks are never in the
    written range: a chunk starts at ``pos >= matched_len``, inside the
    slot's private blocks.

    Also samples a first token per row from each chunk's last-real-token
    logits; rows of unfinished prompts are garbage, and the scheduler
    reads only rows whose prompt just completed.
    """
    append = engine.build_append(bundle, MB * block_size,
                                 capture=_capture_append)

    def run(params, caches, tables, lengths, psids, tokens, chunk_len,
            generator=None):
        return _run_append(append, params, caches, tables, lengths, psids,
                           tokens, chunk_len, block_size, MB, temperature,
                           generator)

    return run


def build_paged_fused(bundle: ModelBundle, block_size: int, MB: int,
                      chunk: int, temperature: float = 0.0,
                      pad_id: int = 0):
    """One scheduler step's decode AND prefill chunk in a single dispatch.

    The prefilling and active slot sets are disjoint, and the pool is not
    written until :func:`pool_write_kv` runs after both, so both halves
    read the same pool and their writes land in disjoint physical blocks
    (idle rows of either half go to scratch block 0). Decode runs over all
    ``S`` slots; the append half over the compacted ``psids`` rows only
    (see :func:`build_paged_append`).
    """
    append = engine.build_append(bundle, MB * block_size,
                                 capture=_capture_append)
    decode = engine.build_decode(bundle, capture=_capture_decode)

    def run(params, caches, tables, lengths, cur_tokens, active, psids,
            tokens, chunk_len, generator=None):
        dlogits, dnew = decode(params, DecodeState(
            _gather_views(caches, tables, MB, block_size), lengths),
            cur_tokens[:, None])
        dtoks = engine.sample(dlogits, temperature, generator)
        dtoks = torch.where(active, dtoks, torch.full_like(dtoks, pad_id))
        atoks, alengths, phys_a, off_a, akv = _run_append(
            append, params, caches, tables, lengths, psids, tokens,
            chunk_len, block_size, MB, temperature, generator)
        # one write plan for both halves: every slot's decode position,
        # then every compacted row's chunk positions
        phys_d, off_d = _decode_plan(tables, lengths, active, block_size,
                                     MB)
        dkv = _flatten_kv(dnew.caches)
        kvs = {k: tuple(torch.cat([d, a], dim=1)
                        for d, a in zip(dkv[k], akv[k])) for k in dkv}
        new_lengths = alengths + active.to(lengths.dtype)
        return (dtoks, atoks, new_lengths, torch.cat([phys_d, phys_a]),
                torch.cat([off_d, off_a]), kvs)

    return run


# ---------------------------------------------------------------------------
# Paged scheduler
# ---------------------------------------------------------------------------

@dataclass
class _PSlot:
    rid: int = -1
    free: bool = True
    remaining: int = 0
    eos_id: Optional[int] = None
    completion: Optional[Completion] = None
    prompt: Optional[np.ndarray] = None
    pos: int = 0                  # prompt positions already in the cache
    n_blocks: int = 0             # allocated table entries
    prefilling: bool = False
    reserved: int = 0             # full-window block budget (admission)
    t_admit: float = 0.0          # preemption picks the youngest victim
    emitted_in_prompt: int = 0    # completion tokens already IN ``prompt``
                                  # (continuation resume: avoids doubling
                                  # them on a second preemption)


class PagedScheduler(Scheduler):
    """Continuous batching over the paged block pool.

    Same external contract as :class:`Scheduler` (``submit`` / ``step`` /
    ``run`` / ``completed`` / ``reset``; ``run()`` and the finish rule are
    inherited), but admission maps radix-matched prefix blocks into the
    slot's table, prefill advances one fixed-width chunk of EVERY
    prefilling slot per step in one batched dispatch (fused with the
    batched decode step), and memory is accounted in blocks, not slots.
    Gives :class:`Scheduler`'s tokens under greedy decode.

    ``num_blocks`` defaults to ``num_slots * ceil(max_len/block_size) + 1``
    (the slot pool's KV footprint plus the scratch block), so slot-vs-paged
    comparisons are at fixed memory; capacity gains come from raising
    ``num_slots`` at the same ``num_blocks``. Runs on ``device`` (default
    ``cuda``, which must be present); sampling at ``temperature > 0`` draws
    from ``generator``.

    ``shardings`` (``shard.paged_pool_sharding``'s partitions) with
    ``group`` (the mesh's ``MeshComms``): this rank holds its slices of the
    block pool, the blocks over ``data`` and the offsets within a block
    over ``model`` (``serve/shard.py``), and every rank runs the same
    scheduler, allocator and radix cache on the same requests.
    """

    def __init__(self, bundle: ModelBundle, params, *, num_slots: int,
                 max_len: int, block_size: int = 16,
                 num_blocks: Optional[int] = None, prefill_chunk: int = 32,
                 pad_id: int = 0, temperature: float = 0.0, dtype=None,
                 generator: Optional[torch.Generator] = None, device=None,
                 use_radix: bool = True, reserve_decode: bool = True,
                 shardings=None, group=None):
        if shardings is not None:
            shard.check_bundle(bundle)
        if not engine.append_ok(bundle):
            raise ValueError(
                f"{bundle.cfg.name}: paged serving requires chunk-append "
                "support (engine.append_ok) — use the slot Scheduler")
        self.device = resolve_device(device)
        self.bundle = bundle
        self.params = params
        self.num_slots = num_slots
        self.max_len = max_len
        self.block_size = block_size
        self.MB = -(-max_len // block_size)
        if num_blocks is None:
            num_blocks = num_slots * self.MB + 1
        self.num_blocks = num_blocks
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.reserve_decode = reserve_decode
        self.pad_id = pad_id
        self.temperature = temperature
        self.generator = generator
        dtype = dtype if dtype is not None else torch.bfloat16

        if shardings is None:
            self.caches = {
                bundle.seg_key(i): tuple(
                    torch.zeros((seg.n_layers,) + shape, dtype=dt or dtype,
                                device=self.device)
                    for shape, dt in seg.cache_shapes(num_blocks,
                                                      block_size))
                for i, seg in enumerate(bundle.segments)}
        else:
            self.caches = shard.placed_block_pool(
                bundle, num_blocks, block_size, dtype, self.device,
                shardings, group)
        # two-phase step: the step programs read the pool (gather) and
        # return fresh K/V + a write plan; pool_write_kv then writes them
        self._append = build_paged_append(bundle, block_size, self.MB,
                                          self.prefill_chunk, temperature)
        self._step = build_paged_decode_step(bundle, block_size, self.MB,
                                             temperature, pad_id)
        self._fused = build_paged_fused(bundle, block_size, self.MB,
                                        self.prefill_chunk, temperature,
                                        pad_id)
        self.alloc = BlockAllocator(num_blocks)
        self.radix: Optional[RadixCache] = \
            RadixCache(block_size) if use_radix else None
        self.tables = np.zeros((num_slots, self.MB), np.int32)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.cur_tokens = np.zeros((num_slots,), np.int32)
        self.active = np.zeros((num_slots,), bool)
        self.stats = {"admitted": 0, "retired": 0, "decode_steps": 0,
                      "prefill_chunks": 0, "prefill_stalls": 0,
                      "radix_hit_blocks": 0, "radix_evictions": 0,
                      "admission_blocked": 0, "preemptions": 0,
                      "max_concurrent": 0}
        self.reset()

    def reset(self) -> None:
        """Clear all serving state (a zeroed pool, no requests)."""
        for leaves in self.caches.values():
            for leaf in leaves:
                shard.local_tensor(leaf).zero_()
        self.alloc.reset()
        if self.radix is not None:
            self.radix.reset()
        self.tables[:] = 0
        self.lengths[:] = 0
        self.slots = [_PSlot() for _ in range(self.num_slots)]
        self.cur_tokens[:] = 0
        self.active[:] = False
        self.pending: deque = deque()
        self._submit_t: Dict[int, float] = {}
        self.completed: List[Completion] = []
        # device mirrors of the host control arrays: lengths and
        # cur_tokens come back from the step programs, so a steady decode
        # uploads nothing; a host mutation (admission, prompt finish,
        # block alloc) marks its array dirty and it is uploaded once.
        # Stale device rows of DEAD slots are safe: inactive and
        # zero-chunk rows compute garbage that is masked and written to
        # scratch.
        self._dev: Dict[str, torch.Tensor] = {}
        self._dirty = {"tables", "lengths", "cur", "active"}
        self.stats = {k: 0 for k in self.stats}

    # -- request intake ----------------------------------------------------

    def submit(self, req: Request) -> None:
        """Queue a request. Raises ONLY for requests that can NEVER fit:
        prompt + max_new beyond the per-slot window or beyond the whole
        usable pool; a momentarily full pool just queues."""
        L = len(req.tokens)
        if L == 0:
            raise ValueError(
                f"request {req.rid}: empty prompt — every request needs "
                ">= 1 token (see engine.check_prompt_lengths)")
        total = L + req.max_new_tokens
        if total > self.MB * self.block_size:
            raise ValueError(
                f"request {req.rid}: prompt {L} + max_new "
                f"{req.max_new_tokens} exceeds the per-request window "
                f"{self.MB * self.block_size} (MB={self.MB} blocks)")
        need = -(-total // self.block_size)
        if need > self.alloc.usable_blocks:
            raise ValueError(
                f"request {req.rid}: needs {need} blocks but the pool has "
                f"only {self.alloc.usable_blocks} usable — can never fit")
        if req.cont is None:
            self._submit_t[req.rid] = time.monotonic()
        self.pending.append(req)

    # -- block accounting --------------------------------------------------

    def _alloc_block(self) -> Optional[int]:
        """Allocate, evicting LRU radix leaves (trie-only blocks) while
        the free list is dry."""
        p = self.alloc.alloc()
        while p is None and self.radix is not None:
            victim = self.radix.evict(
                lambda b: int(self.alloc.refcount[b]) == 1)
            if victim is None:
                break
            self.alloc.deref(victim)
            self.stats["radix_evictions"] += 1
            p = self.alloc.alloc()
        return p

    def _available_blocks(self, exclude=()) -> int:
        """Free blocks plus radix blocks evictable on demand (held only by
        the trie), minus any the caller is about to adopt."""
        n = self.alloc.free_blocks
        if self.radix is not None:
            n += sum(1 for b in self.radix.cached_blocks()
                     if int(self.alloc.refcount[b]) == 1
                     and b not in exclude)
        return n

    def _outstanding_reserved(self) -> int:
        """Blocks promised to live slots but not yet allocated: their
        remaining prompt + decode growth up to ``max_new`` (counted only
        under ``reserve_decode`` admission)."""
        return sum(max(0, s.reserved - s.n_blocks)
                   for s in self.slots if not s.free)

    # -- device-resident control state ------------------------------------

    def _mark(self, *names: str) -> None:
        self._dirty.update(names)

    def _device_state(self):
        """(tables, lengths, cur_tokens, active) on the device, uploading
        only the ones a host mutation dirtied. The ``np.array`` copies
        matter: the host arrays are mutated in place, and on the CPU
        ``torch.from_numpy(...).to("cpu")`` would alias them."""
        names = {"tables": self.tables, "lengths": self.lengths,
                 "cur": self.cur_tokens, "active": self.active}
        for name in self._dirty:
            self._dev[name] = torch.from_numpy(np.array(names[name])).to(
                self.device)
        self._dirty.clear()
        return (self._dev["tables"], self._dev["lengths"],
                self._dev["cur"], self._dev["active"])

    def _release_slot(self, sid: int) -> None:
        """Deref every allocated block and zero the table row."""
        s = self.slots[sid]
        for j in range(s.n_blocks):
            self.alloc.deref(int(self.tables[sid, j]))
        self.tables[sid, :] = 0
        s.n_blocks = 0
        s.reserved = 0
        s.free, s.rid, s.completion, s.prompt = True, -1, None, None
        s.prefilling = False
        self.active[sid] = False
        self.cur_tokens[sid] = self.pad_id
        self.lengths[sid] = 0
        # device rows of a dead slot are stale but masked; only `active`
        # gates emissions and writes, so it alone must resync
        self._mark("active")

    # -- admission ---------------------------------------------------------

    def _admit(self, sid: int, req: Request) -> bool:
        """Map radix-matched prefix blocks into the slot's table and start
        chunked prefill after them. False (leave queued) when the pool
        cannot cover the request right now.

        Default (``reserve_decode=True``): admission reserves the FULL
        window, ``ceil((P + max_new)/block_size)`` blocks minus radix hits,
        against free + evictable blocks net of every live slot's
        outstanding reservation, so no admitted request can be starved and
        preemption is a backstop. ``reserve_decode=False`` admits
        optimistically (one block past the prompt)."""
        prompt = np.asarray(req.tokens, np.int32)
        P = len(prompt)
        s = self.slots[sid]
        now = time.monotonic()

        matched: List[int] = []
        if self.radix is not None:
            # cap one token short of the prompt: at least one suffix token
            # must run through append to produce the first-token logits
            cap = (P - 1) // self.block_size
            matched = self.radix.match(prompt)[:cap]
        reserved = -(-(P + req.max_new_tokens) // self.block_size)
        if self.reserve_decode:
            need = reserved - len(matched)
            avail = self._available_blocks(exclude=set(matched)) \
                - self._outstanding_reserved()
        else:
            need = -(-(P + 1) // self.block_size) - len(matched)
            avail = self._available_blocks(exclude=set(matched))
        if need > avail:
            self.stats["admission_blocked"] += 1
            return False
        for p in matched:
            self.alloc.ref(int(p))
        self.stats["radix_hit_blocks"] += len(matched)
        s.reserved = reserved if self.reserve_decode else 0
        self.tables[sid, :len(matched)] = matched
        s.n_blocks = len(matched)
        s.pos = len(matched) * self.block_size
        self.lengths[sid] = s.pos
        self._mark("tables", "lengths")

        s.rid, s.free, s.prefilling = req.rid, False, True
        s.prompt = prompt
        s.remaining = req.max_new_tokens
        s.eos_id = req.eos_id
        s.t_admit = now
        if req.cont is not None:
            s.completion = req.cont       # a preempted request resuming
            s.emitted_in_prompt = len(req.cont.tokens)
        else:
            s.emitted_in_prompt = 0
            s.completion = Completion(
                rid=req.rid, prompt_len=P, tokens=[],
                t_submit=self._submit_t.pop(req.rid, now), t_admit=now)
        self.stats["admitted"] += 1
        return True

    # -- chunked prefill ---------------------------------------------------

    def _collect_prefill(self):
        """One fixed-width chunk of work for EVERY prefilling slot
        (allocating the blocks the chunks land in) for a single batched
        dispatch. A slot whose chunk cannot get its blocks runs short (as
        far as its allocated blocks reach) or stalls this step
        (``chunk_len == 0``: decode retirements free blocks; preemption
        triggers only from the decode side)."""
        C = self.prefill_chunk
        chunk = np.full((self.num_slots, C), self.pad_id, np.int32)
        ns = np.zeros((self.num_slots,), np.int32)
        for sid, s in enumerate(self.slots):
            if s.free or not s.prefilling:
                continue
            n = min(C, len(s.prompt) - s.pos)
            need = -(-(s.pos + n) // self.block_size)
            while s.n_blocks < need:
                p = self._alloc_block()
                if p is None:
                    break
                self.tables[sid, s.n_blocks] = p
                s.n_blocks += 1
                self._mark("tables")
            # pool dry mid-alloc: run as far as allocated blocks reach
            n = min(n, s.n_blocks * self.block_size - s.pos)
            if n <= 0:
                self.stats["prefill_stalls"] += 1
                continue
            chunk[sid, :n] = s.prompt[s.pos:s.pos + n]
            ns[sid] = n
        return chunk, ns

    def _apply_prefill(self, psids, ns_g, atoks) -> None:
        """Advance slot cursors past the chunks just processed (``psids``
        names the compacted dispatch rows); slots whose prompt completed
        take their first token from ``atoks`` (copied to the host only if
        one did)."""
        toks_host = None
        for r, sid in enumerate(psids):
            s = self.slots[sid]
            if s.free or not s.prefilling:
                continue        # preempted between collect and apply
            s.pos += int(ns_g[r])
            self.lengths[sid] = s.pos
            self.stats["prefill_chunks"] += 1
            if s.pos == len(s.prompt):
                if toks_host is None:
                    toks_host = atoks.cpu().numpy()
                self._finish_prefill(sid, int(toks_host[r]))

    def _finish_prefill(self, sid: int, tok: int) -> None:
        """Record the first token, publish the prompt's full blocks to the
        radix cache, and either retire (eos / single-token budget) or
        activate the slot for batched decode."""
        s = self.slots[sid]
        P = len(s.prompt)
        comp = s.completion
        if not comp.tokens:
            comp.t_first = time.monotonic()
        comp.tokens.append(tok)
        s.prefilling = False
        s.remaining -= 1

        if self.radix is not None:
            nfull = P // self.block_size
            if nfull:
                adopted = self.radix.insert(
                    s.prompt[:nfull * self.block_size],
                    [int(b) for b in self.tables[sid, :nfull]])
                for p in adopted:
                    self.alloc.ref(p)

        if s.remaining <= 0 or (s.eos_id is not None and tok == s.eos_id):
            comp.t_finish = time.monotonic()
            self.completed.append(comp)
            self.stats["retired"] += 1
            self._release_slot(sid)
        else:
            self.cur_tokens[sid] = tok
            self.active[sid] = True
            self._mark("cur", "active")

    # -- decode ------------------------------------------------------------

    def _ensure_decode_blocks(self) -> None:
        """Every active slot needs the block holding position ``lengths``
        allocated before the step writes there. When the pool is dry even
        after radix eviction, PREEMPT the youngest other running slot: its
        blocks free up and its request requeues as a continuation."""
        for sid in np.nonzero(self.active)[0]:
            if not self.active[sid]:
                continue            # preempted by an earlier slot's alloc
            s = self.slots[sid]
            bidx = int(self.lengths[sid]) // self.block_size
            while bidx >= s.n_blocks:
                p = self._alloc_block()
                if p is None:
                    victims = [i for i, v in enumerate(self.slots)
                               if not v.free and i != sid]
                    if not victims:
                        raise RuntimeError(
                            "block pool exhausted by a single request — "
                            "submit() should have rejected it")
                    self._preempt(max(
                        victims, key=lambda i: self.slots[i].t_admit))
                    continue
                self.tables[sid, s.n_blocks] = p
                s.n_blocks += 1
                self._mark("tables")

    def _preempt(self, vid: int) -> None:
        """Evict a running slot: free its blocks and requeue the request
        as a continuation (original prompt + emitted tokens). Greedy
        decode replays the prefix, so the resumed stream continues where
        it stopped."""
        v = self.slots[vid]
        comp = v.completion
        fresh = comp.tokens[v.emitted_in_prompt:]   # not yet in the prompt
        prompt = np.concatenate([
            v.prompt, np.asarray(fresh, np.int32)]) if fresh else v.prompt
        req = Request(rid=v.rid, tokens=prompt,
                      max_new_tokens=max(v.remaining, 1),
                      eos_id=v.eos_id, cont=comp)
        self._release_slot(vid)
        self.pending.appendleft(req)
        self.stats["preemptions"] += 1

    # -- the serving loop --------------------------------------------------

    def step(self) -> bool:
        """Admit while blocks allow, then run ONE dispatch covering this
        step's decode and/or prefill chunk (the fused program when both
        have work). Returns False when idle."""
        free = [i for i, s in enumerate(self.slots) if s.free]
        while free and self.pending:
            if not self._admit(free[0], self.pending[0]):
                break
            self.pending.popleft()
            free.pop(0)
        self.stats["max_concurrent"] = max(
            self.stats["max_concurrent"],
            sum(1 for s in self.slots if not s.free))

        # decode's write blocks first (running slots must never stall),
        # then prefill chunks take what is left of the pool
        if self.active.any():
            self._ensure_decode_blocks()
        chunk, ns = self._collect_prefill()
        act = self.active.copy()
        psids = np.nonzero(ns)[0]
        any_p, any_d = len(psids) > 0, bool(act.any())
        if not (any_p or any_d):
            return bool(self.pending) or \
                any(not s.free for s in self.slots)

        tables, lengths, cur, act_dev = self._device_state()
        atoks = dtoks = None
        if any_p:
            # compact the prefilling rows, padded to a power-of-two
            # bucket; pad rows (slot 0, chunk_len 0) are masked and
            # written to scratch
            g = 1 << (len(psids) - 1).bit_length()
            psids_g = np.zeros((g,), np.int32)
            psids_g[:len(psids)] = psids
            chunk_g = np.full((g, chunk.shape[1]), self.pad_id, np.int32)
            chunk_g[:len(psids)] = chunk[psids]
            ns_g = np.zeros((g,), np.int32)
            ns_g[:len(psids)] = ns[psids]
            psids_dev = torch.from_numpy(psids_g).to(self.device)
            chunk_dev = torch.from_numpy(chunk_g).to(self.device)
            ns_dev = torch.from_numpy(ns_g).to(self.device)
        if any_p and any_d:
            dtoks, atoks, new_len, phys, off, kvs = self._fused(
                self.params, self.caches, tables, lengths, cur, act_dev,
                psids_dev, chunk_dev, ns_dev, self.generator)
        elif any_p:
            atoks, new_len, phys, off, kvs = self._append(
                self.params, self.caches, tables, lengths, psids_dev,
                chunk_dev, ns_dev, self.generator)
        else:
            dtoks, new_len, phys, off, kvs = self._step(
                self.params, self.caches, tables, lengths, cur, act_dev,
                self.generator)
        pool_write_kv(self.caches, phys, off, kvs)
        # the programs advance lengths/cur_tokens exactly as the host
        # bookkeeping below does: keep their outputs as the mirrors
        self._dev["lengths"] = new_len
        if dtoks is not None:
            self._dev["cur"] = dtoks

        if any_p:
            self._apply_prefill(psids_g[:len(psids)], ns_g, atoks)
        if any_d:
            self.stats["decode_steps"] += 1
            self.lengths[act] += 1
            toks = dtoks.cpu().numpy()
            for sid in np.nonzero(act)[0]:
                s = self.slots[sid]
                tok = int(toks[sid])
                s.completion.tokens.append(tok)
                s.remaining -= 1
                if s.remaining <= 0 or \
                        (s.eos_id is not None and tok == s.eos_id):
                    s.completion.t_finish = time.monotonic()
                    self.completed.append(s.completion)
                    self.stats["retired"] += 1
                    self._release_slot(sid)
                else:
                    self.cur_tokens[sid] = tok
        return True

    # -- introspection -----------------------------------------------------

    def pool_bytes(self) -> int:
        """Device bytes this rank's block pool holds (capacity
        accounting)."""
        return sum(t.numel() * t.element_size()
                   for leaves in self.caches.values() for t in
                   map(shard.local_tensor, leaves))
