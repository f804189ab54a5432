"""Logical-axis sharding rules, as plain Python on shapes and path strings
(the counterpart of ``repro/distributed/sharding.py``).

A mesh is a :class:`Mesh`: its axis names and their sizes, nothing else.
A partition is a tuple with one entry per dim: ``None`` (replicated), an
axis name, or a tuple of axis names (the dim split over their product), in
the canonical form ``jax.sharding.PartitionSpec`` prints (a one-name tuple
is the name). The rules give the reference's partition for every leaf:

* parameters: :func:`logical_axes` maps a path to logical axes (``tp`` on
  the matmul dims, ``ep`` on an expert stack) and :func:`spec_for` places
  them on the ``model`` axis where it divides the dim;
* QTensor leaves: the codes take the weight's partition, the scales and
  zero points the same rules on their own shape (:class:`QSpec`);
* optimizer state: the low-rank moments keep the surviving gradient dim's
  partition, the projection the projected-away dim's; with ``zero_axes``
  (ZeRO) each moment and projection is also split over the data-parallel
  axes along the largest dim that divides (:func:`_extend_with_zero`);
* :func:`zero2_scatter_dims`: the dim along which a leaf's low-rank
  gradient is reduce-scattered (ZeRO-2), the dim its moment is split on;
* :func:`data_sharding`: a batch's rows over the data-parallel axes.

The port executes the data-parallel part of these rules (the ``data``
axis: ``train/step.py``, ``distributed/zero.py``) and the
tensor-parallel one (``tp`` on the ``model`` axis, through
``annotate_tp``: ``distributed/tp.py``, which adds the whole-block rule).
Expert parallelism runs on the data axis (``models/moe.py``
``moe_apply_ep``), as the reference's trainer does.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.core import qgalore
from repro_torch.core.adam8bit import Adam8bitState
from repro_torch.core.qgalore import LeafSpec, QGaLoreState
from repro_torch.core.quant import QTensor

Partition = Tuple  # per dim: None | axis name | tuple of axis names


class Mesh:
    """Axis names and sizes (``jax.sharding.Mesh`` without devices)."""

    def __init__(self, shape, axis_names):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} does not match "
                             f"axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(s)
                                      for a, s in zip(axis_names, shape)}

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def __repr__(self):
        return f"Mesh({self.shape})"


class QSpec(NamedTuple):
    """The partitions of a QTensor's codes, scales and zero points."""
    q: Partition
    scale: Partition
    zero: Optional[Partition]


def _canon(part):
    if isinstance(part, tuple):
        if not part:
            return None
        return part[0] if len(part) == 1 else part
    return part


def P(*parts) -> Partition:
    """A partition in canonical form."""
    return tuple(_canon(p) for p in parts)


# (regex on normalized path, (row_logical, col_logical)) for the LAST TWO dims
_MATMUL_RULES = [
    (r"(wq|wk|wv|wq_b|wkv_b)$", (None, "tp")),
    (r"wo$", ("tp", None)),
    (r"(wq_a|wkv_a)$", (None, None)),        # MLA down-proj: small, replicate
    (r"(wi|wg|w_up|in_proj|w_gates|fuse|mtp_proj)$", (None, "tp")),
    (r"(wd|w_down|out_proj|site_out)$", ("tp", None)),
    (r"embedding$", (None, "tp")),
    (r"head$", (None, "tp")),
    (r"(router|conv_w|r_gates)$", (None, None)),
    (r"lora_[qo]/(A|B)$", (None, None)),
]


def _norm_path_str(s: str) -> str:
    """Key-string path → ``'/a/b/c'``."""
    return "/" + re.sub(r"\['([^']*)'\]", r"\1/", s).rstrip("/") \
        .replace("][", "/").replace("[", "").replace("]", "")


def logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    if ndim == 0:
        return ()
    axes: List[Optional[str]] = [None] * ndim
    if ndim >= 2:
        for pat, (row, col) in _MATMUL_RULES:
            if re.search(pat, path):
                axes[-2], axes[-1] = row, col
                break
    if "experts_" in path and ndim >= 3:
        axes[-3] = "ep"
    return tuple(axes)


def _mesh_axis(logical: Optional[str], mesh: Mesh) -> Optional[str]:
    if logical in ("tp", "ep"):
        return "model" if "model" in mesh.axis_names else None
    return None


_EP_FULL_MESH = False


def set_ep_full_mesh(value: bool) -> None:
    """Shard expert stacks over the whole mesh where it divides them (the
    reference enables it only beside its manual expert-parallel MoE)."""
    global _EP_FULL_MESH
    _EP_FULL_MESH = value


def _ep_axes(dim: int, mesh: Mesh):
    """Expert dim: as much of the mesh as divides it (full-mesh mode),
    else the model axis alone."""
    if _EP_FULL_MESH:
        avail = tuple(a for a in ("pod", "data", "model")
                      if a in mesh.axis_names)
        for cand in (avail, avail[1:], avail[2:]):
            if not cand:
                break
            total = 1
            for a in cand:
                total *= mesh.shape[a]
            if total > 1 and dim % total == 0 and dim >= total:
                return cand
    if "model" in mesh.axis_names and dim % mesh.shape["model"] == 0:
        return ("model",)
    return None


def spec_for(shape, logical, mesh: Mesh) -> Partition:
    """Each mesh axis shards at most one dim; ``ep`` takes the model axis
    before ``tp`` does."""
    order = sorted(range(len(logical)),
                   key=lambda i: 0 if logical[i] == "ep" else 1)
    used = set()
    parts: List = [None] * len(logical)
    for i in order:
        dim, log = shape[i], logical[i]
        if log == "ep":
            axes = _ep_axes(dim, mesh)
            if axes and not (set(axes) & used):
                parts[i] = axes if len(axes) > 1 else axes[0]
                used.update(axes)
            continue
        ax = _mesh_axis(log, mesh)
        if ax is not None and ax not in used and dim > 0 \
                and dim % mesh.shape[ax] == 0:
            parts[i] = ax
            used.add(ax)
    return P(*parts)


def axes_of(part) -> Tuple[str, ...]:
    """The axis names of one dim's partition entry."""
    return () if part is None else ((part,) if isinstance(part, str)
                                    else tuple(part))


def _extend_with_zero(spec: Partition, shape, mesh: Mesh, zero_axes,
                      skip_last: bool = False) -> Partition:
    """Split the largest dim that can take ``zero_axes`` over them: a free
    dim their product divides, or a split one whose combined product still
    divides it. ``skip_last`` keeps a QTensor's quantized last axis whole
    (codes and scales disagree on its size). Unchanged when nothing
    divides."""
    if not zero_axes:
        return spec
    ztot = int(np.prod([mesh.shape[a] for a in zero_axes]))
    if ztot <= 1:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    ndims = len(shape) - (1 if skip_last else 0)
    for i in sorted(range(ndims), key=lambda j: (-shape[j], j)):
        cur_t = axes_of(parts[i])
        if set(zero_axes) & set(cur_t):
            continue
        combined = ztot * int(np.prod([mesh.shape[a] for a in cur_t]) or 1)
        if shape[i] > 0 and shape[i] % combined == 0:
            parts[i] = cur_t + tuple(zero_axes)
            return P(*parts)
    return spec


def _qtensor_sharding(qt: QTensor, logical, mesh: Mesh,
                      zero_axes=()) -> QSpec:
    qspec = _extend_with_zero(spec_for(qt.q.shape, logical, mesh),
                              qt.q.shape, mesh, zero_axes, skip_last=True)
    sspec = _extend_with_zero(spec_for(qt.scale.shape, logical, mesh),
                              qt.scale.shape, mesh, zero_axes,
                              skip_last=True)
    return QSpec(qspec, sspec, None if qt.zero is None else sspec)


def param_sharding(params, mesh: Mesh):
    """The partition of every parameter leaf, as a tree like ``params``
    (a :class:`QSpec` per QTensor)."""
    flat = qgalore.flatten(params)
    out = []
    for keys, leaf in flat:
        pstr = _norm_path_str(qgalore.keystr(keys))
        logical = logical_axes(pstr, len(leaf.shape))
        if isinstance(leaf, QTensor):
            out.append(_qtensor_sharding(leaf, logical, mesh))
        else:
            out.append(spec_for(tuple(leaf.shape), logical, mesh))
    return qgalore.unflatten([k for k, _ in flat], out)


# ---------------------------------------------------------------------------
# Tensor-parallel leaf-spec annotation
# ---------------------------------------------------------------------------

def annotate_tp(specs: List[LeafSpec], mesh: Optional[Mesh]
                ) -> List[LeafSpec]:
    """Stamp each spec with the matrix dim the model axis splits
    (``shard_dim``) and its degree (``tp``), from the rules that place the
    weight. No-op without a mesh or at model size 1."""
    if mesh is None or "model" not in mesh.axis_names \
            or mesh.shape["model"] <= 1:
        return specs
    tp = int(mesh.shape["model"])
    out = []
    for spec in specs:
        if len(spec.shape) < 2:
            out.append(spec)
            continue
        pstr = _norm_path_str(spec.path)
        parts = spec_for(spec.shape, logical_axes(pstr, len(spec.shape)),
                         mesh)
        shard_dim = None
        for d in (0, 1):
            part = parts[len(spec.shape) - 2 + d] \
                if len(parts) >= len(spec.shape) - 1 + d else None
            if "model" in axes_of(part):
                shard_dim = d
                break
        if shard_dim is None:
            out.append(spec)
        else:
            out.append(dataclasses.replace(spec, shard_dim=shard_dim, tp=tp))
    return out


# ---------------------------------------------------------------------------
# Optimizer-state sharding
# ---------------------------------------------------------------------------

def _galore_state_logicals(spec: LeafSpec, logical):
    """(moment_logical, proj_logical) for a GaLore leaf."""
    lead = logical[:-2]
    row, col = logical[-2], logical[-1]
    if spec.side == "right":       # low (…, m, r); P (…, n, r)
        return lead + (row, None), lead + (col, None)
    # left: low (…, r, n); P (…, m, r)
    return lead + (None, col), lead + (row, None)


def _shard_like(leaf, logical, mesh, zero_axes=()):
    if leaf is None:
        return None
    if isinstance(leaf, QTensor):
        return _qtensor_sharding(leaf, logical, mesh, zero_axes)
    shape = tuple(leaf.shape)
    return _extend_with_zero(spec_for(shape, logical, mesh), shape, mesh,
                             zero_axes)


def zero_axes_for(mesh: Mesh) -> Tuple[str, ...]:
    """The data-parallel axes a ZeRO-partitioned state is split over."""
    return batch_axes(mesh)


def opt_state_sharding(params, opt_state: QGaLoreState, cfg, mesh: Mesh,
                       zero_axes: Tuple[str, ...] = (),
                       specs: Optional[List[LeafSpec]] = None
                       ) -> QGaLoreState:
    """The partition of every optimizer-state array, as a
    :class:`QGaLoreState` of partitions (``count`` replicated).
    ``zero_axes``: the data-parallel axes the moments and projections are
    also split over (ZeRO). ``specs`` carry rank overrides: the dim choice
    runs on the state's actual shapes."""
    if specs is None:
        specs = qgalore.leaf_specs(params, cfg)
    inner_out, proj_out = [], []
    for spec, inner, proj in zip(specs, opt_state.inner, opt_state.proj):
        logical = logical_axes(_norm_path_str(spec.path), len(spec.shape))
        if spec.galore:
            mom_log, proj_log = _galore_state_logicals(spec, logical)
        else:
            mom_log, proj_log = logical, None
        inner_out.append(None if inner is None else Adam8bitState(
            _shard_like(inner.m, mom_log, mesh, zero_axes),
            _shard_like(inner.v, mom_log, mesh, zero_axes)))
        proj_out.append(None if proj is None
                        else _shard_like(proj, proj_log, mesh, zero_axes))
    return QGaLoreState(inner_out, proj_out, P())


def lowrank_shardings(specs: List[LeafSpec], mesh: Mesh,
                      zero_axes: Tuple[str, ...] = ()) -> Dict[str, Partition]:
    """The moment layout of each GaLore leaf's low-rank values (projected
    gradients, Adam directions), keyed by path."""
    out = {}
    for spec in specs:
        if not spec.galore:
            continue
        logical = logical_axes(_norm_path_str(spec.path), len(spec.shape))
        mom_log, _ = _galore_state_logicals(spec, logical)
        out[spec.path] = _extend_with_zero(
            spec_for(spec.low_shape, mom_log, mesh), spec.low_shape, mesh,
            zero_axes)
    return out


def zero2_scatter_dims(opt_sharding: QGaLoreState, specs: List[LeafSpec],
                       zero_axes: Tuple[str, ...]) -> Dict[int, int]:
    """``{leaf index: dim}``: for each GaLore leaf whose ZeRO moment codes
    are split over the zero axes, the dim they are split on; its steady
    low-rank gradient is reduce-scattered along that dim (ZeRO-2). Leaves
    the ZeRO pass left whole keep the mean all-reduce."""
    if not zero_axes:
        return {}
    out = {}
    for i, (spec, ish) in enumerate(zip(specs, opt_sharding.inner)):
        if not spec.galore or ish is None:
            continue
        m_sh = ish.m.q if isinstance(ish.m, QSpec) else ish.m
        if m_sh is None:
            continue
        for d, part in enumerate(m_sh):
            if set(zero_axes) <= set(axes_of(part)) \
                    and d < len(spec.low_shape):
                out[i] = d
                break
    return out


# ---------------------------------------------------------------------------
# Batch sharding
# ---------------------------------------------------------------------------

def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_sharding(batch_shapes, mesh: Mesh):
    """The partition of every batch input (a tree of shapes): its leading
    dim over the data-parallel axes where their product divides it."""
    dp = batch_axes(mesh)
    total = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1

    def one(shape):
        b = shape[0]
        rest = [None] * (len(shape) - 1)
        if dp and b % total == 0:
            return P(dp, *rest)
        t = int(np.prod([mesh.shape[a] for a in dp[:1]]))
        if b % t == 0:
            return P(dp[:1], *rest)
        return P(None, *rest)

    if isinstance(batch_shapes, dict):
        return {k: data_sharding(v, mesh) if isinstance(v, dict)
                else one(tuple(v)) for k, v in batch_shapes.items()}
    return one(tuple(batch_shapes))

