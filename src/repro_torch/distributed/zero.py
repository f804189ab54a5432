"""ZeRO: the optimizer state partitioned over the data-parallel ranks.

``sharding.opt_state_sharding(..., zero_axes=("data",))`` fixes which dim
of each moment and projection array is split (the largest that the world
divides; the quantized last axis never). A rank holds slice ``rank`` of
that dim and nothing of the rest. The reference leaves the gathering to
GSPMD, "at the point of use, inside the fused update"; here it is
explicit, one leaf at a time (:meth:`ZeroPartition.gather`): every rank
runs the leaf's update whole, on the same gradient and the same uniforms,
so the weight stays replicated and equal on every rank, then keeps only
its own slice of the new moments and projection (:meth:`keep`). A
back-projection over a slice of the rank dim would give each rank a
partial sum of the full-rank update, so nothing is updated on a slice.

Under ZeRO-2 a low-rank gradient arrives as this rank's slice of the
reduced gradient along its moment's split dim (``train/step.py``);
:meth:`gather` makes it whole for the update, in the same collective as
the leaf's state.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.core import qgalore
from repro_torch.core.adam8bit import Adam8bitState
from repro_torch.core.qgalore import LeafSpec, QGaLoreState
from repro_torch.core.quant import QTensor
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.comm import Comm


def _split_dim(part) -> Optional[int]:
    if part is None:
        return None
    for d, p in enumerate(part):
        if "data" in sh.axes_of(p):
            return d
    return None


def _dims(spec) -> Optional[Tuple]:
    """The split dim of each array of one state leaf: ``(q, scale)`` for a
    QTensor, ``(dim,)`` for a tensor."""
    if spec is None:
        return None
    if isinstance(spec, sh.QSpec):
        return _split_dim(spec.q), _split_dim(spec.scale)
    return (_split_dim(spec),)


class ZeroPartition:
    """The split of one optimizer state's layout over ``comm``'s ranks."""

    def __init__(self, specs: List[LeafSpec], rules, mesh: sh.Mesh,
                 comm: Comm):
        if mesh.shape.get("data", 1) != comm.world:
            raise ValueError(f"mesh {mesh.shape} does not match a world of "
                             f"{comm.world} ranks")
        self.comm, self.specs = comm, specs
        self.zero_axes = sh.zero_axes_for(mesh)
        self.template = qgalore.state_template(specs, rules)
        self.sharding = sh.opt_state_sharding(
            None, self.template, rules, mesh, zero_axes=self.zero_axes,
            specs=specs)
        self.inner_dims = [None if i is None else (_dims(i.m), _dims(i.v))
                           for i in self.sharding.inner]
        self.proj_dims = [_dims(p) for p in self.sharding.proj]
        self._zero2 = sh.zero2_scatter_dims(self.sharding, specs,
                                            self.zero_axes)

    def zero2_dims(self):
        """``{leaf index: dim}`` of the ZeRO-2 gradient reduce-scatter."""
        return dict(self._zero2)

    # -- one array -------------------------------------------------------
    def _slice(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        if dim is None:
            return t
        n = t.shape[dim] // self.comm.world
        return t.narrow(dim, self.comm.rank * n, n).clone()

    def _map(self, x, dims, like, fn):
        if x is None:
            return None
        if isinstance(x, QTensor):
            dq, ds = dims
            return QTensor(fn(x.q, dq, like.q), fn(x.scale, ds, like.scale),
                           None if x.zero is None
                           else fn(x.zero, ds, like.zero),
                           x.bits, x.block, x.orig_last, x.dtype)
        return fn(x, dims[0], like)

    def _inner(self, idx, inner, fn):
        if inner is None:
            return None
        dm, dv = self.inner_dims[idx]
        tm = self.template.inner[idx]
        return Adam8bitState(self._map(inner.m, dm, tm.m, fn),
                             self._map(inner.v, dv, tm.v, fn))

    # -- one leaf ---------------------------------------------------------
    def _grad_slice(self, idx: int, grad) -> Optional[int]:
        """The dim along which ``grad`` is this rank's ZeRO-2 slice of leaf
        ``idx``'s low-rank gradient, or None (whole, or full-rank)."""
        d = self._zero2.get(idx)
        if d is None or grad is None:
            return None
        part = list(self.specs[idx].low_shape)
        part[d] //= self.comm.world
        return d if tuple(grad.shape) == tuple(part) else None

    def _proj(self, idx: int, P, fn):
        return self._map(P, self.proj_dims[idx], self.template.proj[idx], fn)

    def _gather(self, walks, extra=()):
        """``walks``: functions that map ``fn(t, dim, like)`` over the
        arrays of one structure. The structures with their slices made
        whole, and each ``(tensor, dim)`` of ``extra`` whole, all in one
        all-gather."""
        sliced = lambda t, d, like: d is not None and \
            t.shape[d] != like.shape[d]
        parts = []
        for walk in walks:
            walk(lambda t, d, like: parts.append((t, d))
                 if sliced(t, d, like) else None)
        parts += list(extra)
        whole = iter(self.comm.all_gather_many(parts) if parts else ())
        fill = lambda t, d, like: next(whole) if sliced(t, d, like) else t
        return [walk(fill) for walk in walks], [next(whole) for _ in extra]

    def gather(self, idx: int, inner, P, grad=None):
        """Leaf ``idx``'s moments, projection and gradient whole, in one
        all-gather of the slices among them (whole arrays pass through)."""
        gd = self._grad_slice(idx, grad)
        (inner, P), g = self._gather(
            [lambda fn: self._inner(idx, inner, fn),
             lambda fn: self._proj(idx, P, fn)],
            [] if gd is None else [(grad, gd)])
        return inner, P, g[0] if g else grad

    def gather_proj(self, proj: list) -> list:
        """Every leaf's projection whole, in one all-gather."""
        return self._gather([lambda fn, i=i, P=P: self._proj(i, P, fn)
                             for i, P in enumerate(proj)])[0]

    def keep(self, idx: int, inner, P):
        """This rank's slices of leaf ``idx``'s whole moments and
        projection."""
        cut = lambda t, d, like: self._slice(t, d)
        return self._inner(idx, inner, cut), self._proj(idx, P, cut)

    # -- the whole state --------------------------------------------------
    def shard(self, opt: QGaLoreState) -> QGaLoreState:
        kept = [self.keep(i, inner, P)
                for i, (inner, P) in enumerate(zip(opt.inner, opt.proj))]
        return QGaLoreState([k[0] for k in kept], [k[1] for k in kept],
                            opt.count)

    def gather_state(self, opt: QGaLoreState) -> QGaLoreState:
        whole = [self.gather(i, inner, P)[:2]
                 for i, (inner, P) in enumerate(zip(opt.inner, opt.proj))]
        return QGaLoreState([w[0] for w in whole], [w[1] for w in whole],
                            opt.count)


def require_zero2(distributed: bool, zero_shard: bool,
                  compress: bool) -> None:
    """The reference's refusal of ZeRO-2 without a data-parallel mesh, the
    ZeRO partition and compressed gradients (its trainer's message)."""
    if not (distributed and zero_shard and compress):
        raise ValueError(
            "zero2=True requires a mesh, zero_shard=True, and "
            "compress_dp_grads=True (the reduce-scatter dims come "
            "from the ZeRO moment sharding inside the compressed-DP "
            f"shard_map); got mesh={distributed}, zero_shard={zero_shard}, "
            f"compress_dp_grads={compress}")


def state_nbytes(opt: QGaLoreState) -> int:
    """Bytes of the optimizer-state arrays this process holds."""
    total = 0
    for x in list(opt.inner) + list(opt.proj):
        if x is None:
            continue
        for part in (x if isinstance(x, Adam8bitState) else (x,)):
            ts = [part.q, part.scale, part.zero] \
                if isinstance(part, QTensor) else [part]
            total += sum(t.numel() * t.element_size()
                         for t in ts if t is not None)
    return total
