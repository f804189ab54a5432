"""Collectives on a ``torch.distributed`` process group (the counterpart
of the reference's ``jax.lax.pmean`` / ``psum`` / ``psum_scatter`` /
``all_to_all`` and ``compat.all_gather_tiled``): the sum, mean, max and
min all-reduce, a reduce-scatter and an all-gather along any dim, an
all-to-all along dim 0, a barrier; and the groups of a 2-D ``(data,
model)`` mesh (:func:`mesh_comms`).

``reduce_scatter_tensor`` and ``all_gather_into_tensor`` work on dim 0,
so a collective along another dim moves it first. Tensors go to the
group's backend where they lie: NCCL for ranks on cards of their own, and
gloo for CPU ranks and for two ranks that share one card (NCCL refuses
two ranks on one device). Gloo takes CUDA tensors in each collective used
here (all-reduce, reduce-scatter, all-gather, all-to-all; checked on an
H100 with torch 2.11 by ``tools/gloo_probe.py``, PERF.md) and copies them
through the host itself. The caller names the backend when it creates the
group; nothing here switches it.

Every call is counted in :attr:`Comm.stats` (calls and bytes of the
tensor each rank puts in, by collective); with ``timed`` the device is
synchronized around each call and its wall time added too.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.quant import true_div


class Comm:
    """A process group, its rank and world, and the counts of what its
    collectives moved."""

    def __init__(self, group=None, timed: bool = False):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.timed = timed
        self.stats: Dict[str, List[float]] = {}

    def reset_stats(self) -> None:
        self.stats = {}

    def _count(self, op: str, t: torch.Tensor, seconds: float) -> None:
        s = self.stats.setdefault(op, [0, 0, 0.0])
        s[0] += 1
        s[1] += t.numel() * t.element_size()
        s[2] += seconds

    def _run(self, op: str, fn, *tensors: torch.Tensor):
        """``fn(*tensors)``, counted under ``op`` by the last tensor."""
        sync = self.timed and tensors[0].is_cuda
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*tensors)
        if sync:
            torch.cuda.synchronize()
        self._count(op, tensors[-1], time.perf_counter() - t0)

    # ------------------------------------------------------------------
    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks, in place."""
        if self.world > 1:
            self._run("all_reduce", lambda x: dist.all_reduce(
                x, group=self.group), t)
        return t

    def all_reduce_op(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the ranks by ``op`` ("max" or "min"), in
        place; counted under ``all_reduce_<op>``."""
        if self.world > 1:
            red = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
            self._run(f"all_reduce_{op}", lambda x: dist.all_reduce(
                x, op=red, group=self.group), t)
        return t

    def all_reduce_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (a new tensor): the sum divided
        once by the world size, as ``pmean`` rounds it."""
        if self.world == 1:
            return t
        return true_div(self.all_reduce_sum(t.clone()), self.world)

    def all_reduce_max(self, value: float) -> float:
        if self.world == 1:
            return value
        dev = torch.device("cuda", torch.cuda.current_device()) \
            if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return float(t[0])

    def reduce_scatter(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's ``1/world`` slice along ``dim`` of ``t`` summed over
        the ranks (the tiled ``psum_scatter``): a view of a buffer laid out
        with ``dim`` first, which :meth:`all_gather` along the same dim
        takes without a copy."""
        if self.world == 1:
            return t.clone()
        if t.shape[dim] % self.world:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {self.world} ranks")
        x = t.movedim(dim, 0).contiguous()
        out = torch.empty((x.shape[0] // self.world,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._run("reduce_scatter", lambda o, i: dist.reduce_scatter_tensor(
            o, i, group=self.group), out, x)
        return out.movedim(0, dim)

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' ``t`` concatenated along ``dim`` in rank order."""
        return self.all_gather_many([(t, dim)])[0]

    def all_gather_many(self, parts) -> List[torch.Tensor]:
        """:meth:`all_gather` of each ``(tensor, dim)`` of ``parts``, in
        one collective: every rank puts in the bytes of its tensors, each
        with its ``dim`` moved first, in the order given."""
        if self.world == 1:
            return [t for t, _ in parts]
        xs = [t.movedim(d, 0).contiguous() for t, d in parts]
        metas = [(x.dtype, tuple(x.shape), x.numel() * x.element_size())
                 for x in xs]
        raw = [x.reshape(-1).view(torch.uint8) for x in xs]
        flat = raw[0] if len(raw) == 1 else torch.cat(raw)
        del xs, raw
        total = flat.numel()
        out = torch.empty(self.world * total, dtype=torch.uint8,
                          device=flat.device)
        self._run("all_gather", lambda o, i: dist.all_gather_into_tensor(
            o, i, group=self.group), out, flat)
        del flat              # the inputs' copies go before the outputs come
        out = out.view(self.world, total)
        whole, at = [], 0
        for (dtype, shape, n), (_, d) in zip(metas, parts):
            y = out[:, at:at + n].contiguous().view(dtype).reshape(
                (self.world * shape[0],) + shape[1:])
            whole.append(y.movedim(0, d).contiguous())
            at += n
        return whole

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The all-to-all along dim 0 (``lax.all_to_all`` tiled, split and
        concatenated on axis 0): ``t``'s dim 0 is cut into ``world`` equal
        parts, part ``j`` goes to rank ``j``, and the result holds the part
        each rank sent here, in rank order (a new tensor). Equal parts make
        it its own inverse."""
        if self.world == 1:
            return t.clone()
        if t.shape[0] % self.world:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"over {self.world} ranks")
        x = t.contiguous()
        out = torch.empty_like(x)
        self._run("all_to_all", lambda o, i: dist.all_to_all_single(
            o, i, group=self.group), out, x)
        return out

    def barrier(self) -> None:
        if self.world > 1:
            dist.barrier(group=self.group)


def as_comm(group) -> Optional[Comm]:
    """``group``: None, a ``Comm`` or a process group."""
    if group is None or isinstance(group, Comm):
        return group
    return Comm(group)


class MeshComms(NamedTuple):
    """The groups of a ``(D, t)`` ``("data", "model")`` mesh, as seen by
    one rank: ``world`` (all D·t ranks), ``data`` (the D ranks of this
    rank's model index: gradients are averaged over it) and ``model``
    (the t ranks of this rank's data index: a tensor-parallel layer's
    collectives run on it)."""
    world: Comm
    data: Comm
    model: Comm
    shape: tuple

    @property
    def tp(self) -> int:
        return self.shape[1]


def mesh_comms(world: Comm, shape: Sequence[int]) -> MeshComms:
    """The data and model groups of the ``shape = (D, t)`` mesh over
    ``world``'s ranks, laid out ``rank = d·t + m`` (the model axis
    fastest, as ``jax.make_mesh((D, t))`` orders devices). Every rank
    creates every group, in the same order (``dist.new_group`` is
    collective); each keeps its own two."""
    D, t = (int(x) for x in shape)
    if D * t != world.world:
        raise ValueError(f"a ({D}, {t}) mesh needs {D * t} ranks, the group "
                         f"has {world.world}")
    d_idx, m_idx = divmod(world.rank, t)
    data = model = None
    for m in range(t):
        g = dist.new_group([d * t + m for d in range(D)])
        if m == m_idx:
            data = g
    for d in range(D):
        g = dist.new_group([d * t + m for m in range(t)])
        if d == d_idx:
            model = g
    return MeshComms(world, Comm(data, world.timed),
                     Comm(model, world.timed), (D, t))
