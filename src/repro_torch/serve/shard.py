"""Sharding for serving state (the counterpart of ``repro/serve/shard.py``):
the reference's rules as plain Python on shapes, and the runtime that
holds a KV-cache pool split over ranks.

**The rules.** Per cache leaf, dim 1 is the batch (dim 0 is the stacked
layer axis): it shards over the data-parallel axes where their product
divides it; then the largest remaining dim that the model axis divides
goes on ``model`` (KV time for an attention cache, heads or channels for
a recurrent state). :func:`leaf_spec`, :func:`decode_state_sharding`,
:func:`pool_sharding` and :func:`paged_pool_sharding` give the
reference's partitions leaf for leaf (a partition is a tuple in the
canonical form of ``distributed/sharding.py``). A bundle built with
``tp_group`` is the one deviation: a K/V window of an attention unit the
model group splits holds the rank's kv heads, so its ``model`` axis is
the kv-head axis (dim 3); the reference puts KV time there and GSPMD
reshards it onto the heads that tensor parallelism computes.

**The runtime.** A ``(D, t)`` mesh (``distributed.comm.mesh_comms``)
holds the pool as the partitions name it, with the weights replicated
(or split by tensor parallelism): each rank keeps only its slice of every
pool leaf, the slot or block axis over ``data`` and KV time over
``model`` (a slot pool's dim 2, the offset within a block in the paged
pool). Every rank computes every row; a K/V write lands only on the rank
that holds its (slot or block, position), and attention combines the
ranks' partial sums (``models.attention.held_attention``: one max and one
sum all-reduce a layer over the ranks that split the keys). ``lengths``
stays replicated, and the host scheduler runs identically on every rank.
:class:`SlotLeaf` and :class:`PagedLeaf` are a rank's share of one leaf;
the schedulers build them through :func:`placed_slot_pool` and
:func:`placed_block_pool`, and :func:`place_state` places a whole
``DecodeState`` (an ``engine.build_prefill`` result) for ``build_decode``
and ``build_append``.

Covered: bundles whose cache leaves are all GQA K/V windows (the dense
family, the VLM and the MoE). MLA latents, recurrent states, the
encoder-decoder's extras, expert-parallel bundles and a partition that
puts ``model`` on any dim but KV time (or, under tensor parallelism, the
kv heads) are refused by name (:data:`FOLLOW_UP`).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import Mesh, P, Partition, axes_of, \
    batch_axes
from repro_torch.models.attention import NO_POS, HeldWindow
from repro_torch.serve import engine
from repro_torch.serve.engine import DecodeState

FOLLOW_UP = "ROADMAP queue 1, 5c follow-up"


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------

def _dp_total(mesh: Mesh) -> Tuple[Tuple[str, ...], int]:
    dp = batch_axes(mesh)
    return dp, math.prod(mesh.shape[a] for a in dp) if dp else 1


def leaf_spec(shape: Sequence[int], mesh: Mesh,
              batch_dim: int = 1) -> Partition:
    """The reference's ``_leaf_spec``: ``batch_dim`` over the data axes
    where their product divides it (and it is above 1), then the largest
    other dim the model axis divides on ``model`` (the later dim on a
    tie)."""
    shape = tuple(shape)
    parts = [None] * len(shape)
    dp, dp_total = _dp_total(mesh)
    if len(shape) > batch_dim and dp and shape[batch_dim] % dp_total == 0 \
            and shape[batch_dim] > 1:
        parts[batch_dim] = dp
    if "model" in mesh.axis_names:
        msize = mesh.shape["model"]
        cands = [(shape[i], i) for i in range(len(shape))
                 if parts[i] is None and i != batch_dim
                 and shape[i] % msize == 0 and shape[i] >= msize]
        if cands:
            parts[max(cands)[1]] = "model"
    return P(*parts)


def _tp_heads(bundle, shape) -> bool:
    """Whether a cache leaf of a tensor-parallel bundle holds the rank's
    kv heads (a K/V window of an attention unit the model group splits)."""
    return bundle is not None and bundle.tp is not None and \
        len(shape) == 5 and shape[3] != bundle.cfg.num_kv_heads


def _on_heads(part: Partition) -> Partition:
    """A K/V window's partition with ``model`` moved to the kv heads."""
    parts = [None if p == "model" else p for p in part]
    parts[3] = "model"
    return P(*parts)


def decode_state_sharding(state_abs: DecodeState, mesh: Mesh,
                          bundle=None) -> DecodeState:
    """The partition of every leaf of a decode state (``lengths``
    replicated, the extras with their batch on dim 0). ``bundle``: the
    tensor-parallel deviation for a ``tp_group`` bundle (module
    docstring)."""
    def one(leaf):
        part = leaf_spec(tuple(leaf.shape), mesh)
        return _on_heads(part) if _tp_heads(bundle, leaf.shape) else part

    caches = {k: tuple(one(leaf) for leaf in leaves)
              for k, leaves in state_abs.caches.items()}
    extras = {k: leaf_spec(tuple(v.shape), mesh, batch_dim=0)
              for k, v in state_abs.extras.items()}
    return DecodeState(caches, P(), extras)


def pool_sharding(bundle, num_slots: int, max_len: int, mesh: Mesh,
                  dtype=None) -> DecodeState:
    """Partitions of the slot pool (``serve/scheduler.py``): slots over the
    data axes, the largest remaining dim (KV time for attention caches)
    over model; ``lengths`` replicated. For ``Scheduler(shardings=)``."""
    state = engine.abstract_decode_state(bundle, num_slots, max_len,
                                         dtype or torch.bfloat16)
    return decode_state_sharding(state, mesh, bundle)


def paged_pool_sharding(bundle, num_blocks: int, block_size: int,
                        mesh: Mesh, dtype=None) -> Dict[str, tuple]:
    """Partitions of the paged block pool (``serve/paged.py``), a
    caches-shaped dict: the block axis (dim 1) over the data axes where
    their product divides ``num_blocks`` (the ``num_slots·MB + 1`` default
    may not: pick a divisible count), and KV time within a block (dim 2)
    on model where the model axis divides the block. For
    ``PagedScheduler(shardings=)``."""
    state = engine.abstract_decode_state(bundle, num_blocks, block_size,
                                         dtype or torch.bfloat16)
    dp, dp_total = _dp_total(mesh)

    def one(leaf):
        shape = tuple(leaf.shape)
        parts: list = [None] * len(shape)
        if len(shape) > 1 and dp and shape[1] % dp_total == 0 \
                and shape[1] > 1:
            parts[1] = dp
        if "model" in mesh.axis_names and len(shape) > 2:
            msize = mesh.shape["model"]
            if shape[2] % msize == 0 and shape[2] >= msize:
                parts[2] = "model"
        part = P(*parts)
        return _on_heads(part) if _tp_heads(bundle, shape) else part

    return {k: tuple(one(leaf) for leaf in leaves)
            for k, leaves in state.caches.items()}


# ---------------------------------------------------------------------------
# The runtime: a rank's share of the pool
# ---------------------------------------------------------------------------

def check_bundle(bundle) -> None:
    """Refuse, by name, a bundle whose serving state the runtime cannot
    split: only GQA K/V windows are covered."""
    cfg = bundle.cfg
    why = None
    if bundle.ep is not None:
        why = "an expert-parallel bundle"
    elif cfg.family in ("xlstm", "hybrid"):
        why = f"recurrent states (family {cfg.family})"
    elif bundle.decode_extras:
        why = (f"the encoder-decoder's extras "
               f"{tuple(bundle.decode_extras)}")
    elif cfg.attention == "mla":
        why = "MLA latents"
    if why:
        raise NotImplementedError(
            f"{cfg.name}: a pool split over ranks holds GQA K/V windows "
            f"only, not {why} ({FOLLOW_UP})")


class _Split(NamedTuple):
    """How one pool leaf is split: slots or blocks over the data group,
    KV time over the model group."""
    data: bool
    time: bool


def _leaf_split(part: Partition, shape, groups, bundle, key: str) -> _Split:
    """Validate one leaf's partition against what the runtime holds."""
    D, t = groups.shape
    size = {"data": D, "model": t}
    part = tuple(part) + (None,) * (len(shape) - len(part))
    heads = _tp_heads(bundle, tuple(shape))
    split = {}
    for i, p in enumerate(part):
        axes = axes_of(p)
        if any(a not in size for a in axes):
            raise NotImplementedError(
                f"{key}: partition {part} names axes {axes}; the runtime's "
                f"mesh is (data, model) ({FOLLOW_UP})")
        n = math.prod(size[a] for a in axes)
        ok = (i == 1 and axes in ((), ("data",))) or \
            (i == 2 and axes in ((), ("model",)) and not heads) or \
            (i == 3 and heads and axes == ("model",)) or n == 1
        if not ok:
            what = {1: "slots or blocks", 2: "KV time",
                    3: "kv heads"}.get(i, f"dim {i}")
            raise NotImplementedError(
                f"{key}: partition {part} puts {axes} on {what}; the runtime "
                "splits slots or blocks over data and KV time over model "
                "(a tensor-parallel unit: its kv heads) "
                f"({FOLLOW_UP})")
        split[i] = n > 1
    if heads and part[3] != "model":
        raise NotImplementedError(
            f"{key}: a tensor-parallel unit's cache holds the rank's kv "
            f"heads, so model must be on dim 3, not {part} ({FOLLOW_UP})")
    if len(shape) > 2 and split.get(2) and shape[2] % t:
        raise ValueError(f"{key}: dim 2 of {tuple(shape)} does not split "
                         f"over {t} ranks")
    if split.get(1) and shape[1] % D:
        raise ValueError(f"{key}: dim 1 of {tuple(shape)} does not split "
                         f"over {D} ranks")
    return _Split(split.get(1, False), split.get(2, False))


def _comm(split: _Split, groups):
    """The ranks among which a leaf's keys are split."""
    if split.data and split.time:
        return groups.world
    if split.data:
        return groups.data
    if split.time:
        return groups.model
    return None


def _cache_parts(shardings) -> dict:
    return shardings.caches if isinstance(shardings, DecodeState) \
        else shardings


class _Share(NamedTuple):
    """This rank's share of one pool leaf: its shape, its first row (slot
    or block) and first position, and the ranks that split its keys."""
    shape: Tuple[int, ...]
    r0: int
    p0: int
    comm: object


def _share(part: Partition, full, groups, bundle, key: str) -> _Share:
    split = _leaf_split(part, full, groups, bundle, key)
    D, t = groups.shape
    local, r0, p0 = list(full), 0, 0
    if split.data:
        local[1] //= D
        r0 = groups.data.rank * local[1]
    if split.time:
        local[2] //= t
        p0 = groups.model.rank * local[2]
    return _Share(tuple(local), r0, p0, _comm(split, groups))


def _placed(bundle, batch: int, window: int, shardings, groups):
    """``{seg_key: [(share, dtype or None), ...]}`` of the pool of
    ``batch`` rows (slots or blocks) and ``window`` positions."""
    if groups is None:
        raise ValueError("a pool split over ranks needs the mesh's groups "
                         "(distributed.comm.mesh_comms)")
    check_bundle(bundle)
    parts = _cache_parts(shardings)
    out = {}
    for i, seg in enumerate(bundle.segments):
        key = bundle.seg_key(i)
        if seg.cache_shapes is None or seg.decode is None:
            continue
        out[key] = [(_share(parts[key][j], (seg.n_layers,) + tuple(shape),
                            groups, bundle, f"{key}[{j}]"), dt)
                    for j, (shape, dt) in enumerate(
                        seg.cache_shapes(batch, window))]
    return out


class SlotLeaf:
    """A slot-pool leaf ``(L, S, T, KH, hd)`` as this rank holds it: the
    slots from ``s0`` and the positions from ``t0`` of ``local`` (L, R, W,
    KH, hd). Indexing a layer gives the :class:`HeldWindow` the attention
    reads and writes in place."""

    def __init__(self, local: torch.Tensor, s0: int, t0: int, comm):
        R, W = local.shape[1], local.shape[2]
        dev = local.device
        self.local, self.s0, self.t0, self.comm = local, s0, t0, comm
        self.rows = torch.arange(s0, s0 + R, device=dev)
        self.pos = (t0 + torch.arange(W, dtype=torch.int32, device=dev)) \
            .expand(R, W)

    def __getitem__(self, layer: int) -> HeldWindow:
        return HeldWindow(self.local[layer], self.rows, self.pos, self.comm)

    def insert(self, slots: Sequence[int], rows: torch.Tensor) -> None:
        """Write the rows ``rows`` (L, B, T, ...) of a prefill state into
        slots ``slots`` (B,), where this rank holds them, in place."""
        R, W = self.local.shape[1], self.local.shape[2]
        mine = [(j, s - self.s0) for j, s in enumerate(slots)
                if self.s0 <= s < self.s0 + R]
        if not mine:
            return
        dev = self.local.device
        src = torch.tensor([j for j, _ in mine], device=dev)
        dst = torch.tensor([s for _, s in mine], device=dev)
        self.local[:, dst] = rows[:, src, self.t0:self.t0 + W].to(
            self.local.dtype)


class _PagedView:
    """Per-slot views of a :class:`PagedLeaf` through block tables
    ``(S, MB)``: indexing a layer gathers the rank's part of each slot's
    blocks into a :class:`HeldWindow` (a copy), keys of blocks held
    elsewhere masked by position."""

    def __init__(self, leaf: "PagedLeaf", tables: torch.Tensor, MB: int):
        NB, bl = leaf.local.shape[1], leaf.local.shape[2]
        S = tables.shape[0]
        lid = tables.long() - leaf.b0
        held = (lid >= 0) & (lid < NB)
        self.leaf, self.idx = leaf, lid.clamp(0, NB - 1).reshape(-1)
        dev = tables.device
        pos = (torch.arange(MB, dtype=torch.int32, device=dev)[:, None]
               * leaf.block_size + leaf.o0
               + torch.arange(bl, dtype=torch.int32, device=dev)[None])
        self.pos = torch.where(held[:, :, None], pos[None],
                               torch.full((), NO_POS, dtype=torch.int32,
                                          device=dev)).reshape(S, MB * bl)
        self.rows = torch.arange(S, device=dev)
        self.shape = (S, MB * bl) + tuple(leaf.local.shape[3:])

    def __getitem__(self, layer: int) -> HeldWindow:
        view = self.leaf.local[layer].index_select(0, self.idx) \
            .reshape(self.shape)
        return HeldWindow(view, self.rows, self.pos, self.leaf.comm)


class PagedLeaf:
    """A block-pool leaf ``(L, NB, blk, KH, hd)`` as this rank holds it:
    the blocks from ``b0`` and the offsets from ``o0`` within each block of
    ``local`` (L, NB_r, blk_r, KH, hd)."""

    def __init__(self, local: torch.Tensor, b0: int, o0: int,
                 block_size: int, comm):
        self.local, self.b0, self.o0 = local, b0, o0
        self.block_size, self.comm = block_size, comm

    def view(self, tables: torch.Tensor, MB: int) -> _PagedView:
        return _PagedView(self, tables, MB)

    def write(self, phys: torch.Tensor, off: torch.Tensor,
              kv: torch.Tensor) -> None:
        """Set K/V at (block ``phys``, offset ``off``) where this rank
        holds it; ``kv`` (L, N, ...) as ``paged.pool_write_kv`` takes it."""
        NB, bl = self.local.shape[1], self.local.shape[2]
        p, o = phys.long() - self.b0, off.long() - self.o0
        keep = (p >= 0) & (p < NB) & (o >= 0) & (o < bl)
        self.local[:, p[keep], o[keep]] = kv[:, keep].to(self.local.dtype)


def local_tensor(leaf) -> torch.Tensor:
    """The tensor a pool leaf's bytes live in on this rank."""
    return leaf.local if isinstance(leaf, (SlotLeaf, PagedLeaf)) else leaf


def placed_slot_pool(bundle, num_slots: int, max_len: int, dtype, device,
                     shardings, groups) -> DecodeState:
    """A zero-filled slot pool of which this rank holds the slices its
    partitions (:func:`pool_sharding`) name; ``lengths`` whole."""
    caches = {k: tuple(SlotLeaf(torch.zeros(sh.shape, dtype=dt or dtype,
                                            device=device),
                                sh.r0, sh.p0, sh.comm) for sh, dt in v)
              for k, v in _placed(bundle, num_slots, max_len, shardings,
                                  groups).items()}
    return DecodeState(caches, torch.zeros((num_slots,), dtype=torch.int32,
                                           device=device))


def placed_block_pool(bundle, num_blocks: int, block_size: int, dtype,
                      device, shardings, groups) -> Dict[str, tuple]:
    """A zero-filled block pool of which this rank holds the slices its
    partitions (:func:`paged_pool_sharding`) name."""
    return {k: tuple(PagedLeaf(torch.zeros(sh.shape, dtype=dt or dtype,
                                           device=device),
                               sh.r0, sh.p0, block_size, sh.comm)
                     for sh, dt in v)
            for k, v in _placed(bundle, num_blocks, block_size, shardings,
                                groups).items()}


def place_state(bundle, state: DecodeState, shardings,
                groups) -> DecodeState:
    """This rank's slices of a whole decode state (every rank computes the
    same ``engine.build_prefill``), as ``engine.build_decode`` and
    ``build_append`` take it; ``lengths`` and the extras stay whole."""
    check_bundle(bundle)
    parts = _cache_parts(shardings)
    caches = {}
    for key, leaves in state.caches.items():
        placed = []
        for j, whole in enumerate(leaves):
            sh = _share(parts[key][j], tuple(whole.shape), groups, bundle,
                        f"{key}[{j}]")
            R, W = sh.shape[1], sh.shape[2]
            placed.append(SlotLeaf(
                whole[:, sh.r0:sh.r0 + R, sh.p0:sh.p0 + W].clone(), sh.r0,
                sh.p0, sh.comm))
        caches[key] = tuple(placed)
    return DecodeState(caches, state.lengths, state.extras)
