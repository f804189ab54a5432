"""Tensor parallelism written out: what GSPMD inserts for the reference
(``repro/train/step.py``: "the model axis stays auto").

A ``(D, t)`` mesh splits each data shard's weights over t ranks of a
model group, in the style of Megatron-LM:

* column-parallel ``wq``, ``wk``, ``wv``, ``wi``, ``wg`` (their columns,
  ``shard_dim`` 1) and row-parallel ``wo``, ``wd`` (their rows,
  ``shard_dim`` 0), the placement rules of ``distributed/sharding.py``;
  a layer reads :func:`copy` before a column-parallel pair (identity
  forward, the gradient all-reduced in the backward) and :func:`reduce`
  after the row-parallel matmul (all-reduce forward, identity backward);
* the embedding split on d: each rank looks its columns up, and
  :func:`gather_last` all-gathers them (a slice in the backward);
* the head split on the vocabulary, and :func:`vocab_parallel_cross_entropy`
  all-reduces the row max, the sum of exponentials and the target logit:
  the logits are never gathered.

**The whole-block rule of the port.** A leaf shards on its quantization
axis (the last, blocks of 256) only where each rank's slice holds whole
blocks of codes and scales (and of its 8-bit moments, quantized along the
same axis); otherwise it stays replicated on the model axis. This changes
no number, only where the bytes live: the INT8 kernels and the stochastic
requantization work on whole blocks, so a rank's slice gets the codes the
whole leaf would. The reference shards the padded codes through GSPMD
(``repro/distributed/sharding.py`` ``_qtensor_sharding``). A layer's
column- and row-parallel matrices shard as one unit (attention also needs
its query and KV heads to divide t); where one of them cannot, the unit
stays replicated and runs on every rank whole, with no collective. At
t = 2 llama-1b's FFN (d_ff 5461) and head (vocab 32000: 125 blocks) stay
replicated; every leaf of mistral-nemo-12b shards.

:func:`plan_specs` stamps each leaf spec with the dim it shards on (the
whole-leaf spec, for the controller and checkpoints); :func:`local_specs`
gives a rank's specs (its slices' shapes, the whole leaf's side), on
which the optimizer runs; :func:`shard_params` / :func:`gather_params`
and :func:`shard_opt` / :func:`gather_opt` move between the two, and
:func:`shard_leaf` / :func:`shard_opt_leaf` cut one leaf as they do (a
trainer cuts each leaf as it is drawn or restored, so a rank never holds
the whole state).
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import projector, qgalore
from repro_torch.core.adam8bit import Adam8bitState
from repro_torch.core.qgalore import LeafSpec, QGaLoreState
from repro_torch.core.quant import QTensor
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.comm import Comm

# a layer's units: the column-parallel leaves and the row-parallel one
UNITS = {"attn": (("wq", "wk", "wv"), "wo"),
         "ffn": (("wi", "wg"), "wd")}
ALONE = ("embedding", "head")        # shard alone, each with its own op


# ---------------------------------------------------------------------------
# The f and g operators, the embedding's gather, the vocab-parallel loss
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group in the
    backward (Megatron-LM's f), in float32, rounded once to its dtype."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = ctx.comm.all_reduce_sum(g.to(torch.float32, copy=True))
        return s.to(g.dtype), None


class _Reduce(torch.autograd.Function):
    """The sum over the model group forward (Megatron-LM's g), in
    float32, rounded once to the input's dtype; identity backward: every
    rank holds the same loss of the same sum."""

    @staticmethod
    def forward(ctx, x, comm):
        s = comm.all_reduce_sum(x.to(torch.float32, copy=True))
        return s.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherLast(torch.autograd.Function):
    """The ranks' slices concatenated along the last dim; the backward
    keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm, ctx.n = comm, x.shape[-1]
        return comm.all_gather(x, x.ndim - 1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.comm.rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


class _AllToAll(torch.autograd.Function):
    """``Comm.all_to_all`` along dim 0; its own inverse, so the backward
    is the same exchange of the gradient."""

    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_to_all(g), None


def copy(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    return _Copy.apply(x, comm)


def reduce(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    return _Reduce.apply(x, comm)


def gather_last(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    return _GatherLast.apply(x, comm)


def all_to_all(x: torch.Tensor, comm: Comm) -> torch.Tensor:
    return _AllToAll.apply(x, comm)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 comm: Comm):
    """``layers.cross_entropy`` of logits split on the vocabulary: this
    rank holds columns ``[rank·V/t, (rank+1)·V/t)``. The row max (a
    constant shift), the sum of exponentials and the target logit are
    summed over the group; the loss is ``layers.cross_entropy``'s up to
    summation order. The accuracy takes the lowest index among equal
    maxima, as ``argmax`` does."""
    lf = logits.to(torch.float32)
    v_loc = lf.shape[-1]
    lo = comm.rank * v_loc
    valid = labels >= 0
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    with torch.no_grad():
        row_max = comm.all_reduce_op(lf.amax(dim=-1), "max")
    sum_exp = reduce(torch.exp(lf - row_max[..., None]).sum(dim=-1), comm)
    mine = (safe >= lo) & (safe < lo + v_loc)
    local = torch.where(mine, safe - lo, torch.zeros_like(safe))
    gold = reduce(torch.gather(lf, -1, local[..., None])[..., 0] * mine,
                  comm)
    nll = (row_max + torch.log(sum_exp) - gold) * valid
    denom = torch.clamp_min(valid.sum(), 1)
    loss = nll.sum() / denom
    with torch.no_grad():
        at_max = lf == row_max[..., None]
        first = torch.where(at_max.any(-1), at_max.to(torch.int8)
                            .argmax(-1) + lo, torch.full_like(safe, 2 ** 62))
        pred = comm.all_reduce_op(first, "min")
        acc = ((pred == safe) & valid).sum() / denom
    return loss, {"accuracy": acc, "tokens": denom}


# ---------------------------------------------------------------------------
# The plan: which leaves shard, on which dim
# ---------------------------------------------------------------------------

def _name(path: str) -> tuple:
    """``(parent path, leaf name)`` of a key-string path."""
    keys = re.findall(r"\['([^']*)'\]", path)
    return tuple(keys[:-1]), keys[-1] if keys else ""


def whole_blocks(spec: LeafSpec, t: int, block: int) -> bool:
    """The whole-block rule: a slice along ``spec.shard_dim`` of t holds
    whole quantization blocks (the last axis) or whole rows (dim -2)."""
    m, n = spec.mat_shape
    if spec.shard_dim == 1:
        return n % (t * block) == 0
    return m % t == 0


def plan_specs(specs: List[LeafSpec], t: int, cfg, block: int = 256
               ) -> List[LeafSpec]:
    """The whole-leaf specs stamped with ``(shard_dim, tp)`` where the
    leaf shards at tensor-parallel degree ``t``: the placement rules
    (``sharding.annotate_tp``), then the whole-block rule and the units
    (module docstring). ``cfg``: the model config (its head counts)."""
    if t <= 1:
        return specs
    ann = sh.annotate_tp(specs, sh.Mesh((1, t), ("data", "model")))
    ok = {i: s.shard_dim is not None and whole_blocks(s, t, block)
          for i, s in enumerate(ann)}
    by_name = {_name(s.path): i for i, s in enumerate(ann)}
    heads = cfg.num_heads % t == 0 and cfg.num_kv_heads % t == 0
    keep = set()
    for (parent, name), i in by_name.items():
        col, row = UNITS.get(parent[-1] if parent else "", ((), ""))
        if name in col + (row,):
            members = [by_name.get((parent, n)) for n in col + (row,)]
            if all(j is not None and ok[j] for j in members) and \
                    (parent[-1] != "attn" or heads):
                keep.add(i)
        elif not parent and name in ALONE and ok[i]:
            keep.add(i)
    return [s if i in keep else dataclasses.replace(s, shard_dim=None, tp=1)
            for i, s in enumerate(ann)]


def attn_split(cfg, t: int, block: int = 256) -> bool:
    """Whether :func:`plan_specs` splits a GQA attention unit of ``cfg``
    (``wq``, ``wk``, ``wv``, ``wo``) over t ranks: each rank then computes
    and caches its H/t query and KH/t kv heads."""
    if t <= 1:
        return False
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = {"wq": (d, cfg.num_heads * hd), "wk": (d, cfg.num_kv_heads * hd),
              "wv": (d, cfg.num_kv_heads * hd), "wo": (cfg.num_heads * hd, d)}
    specs = [LeafSpec(f"['block']['attn']['{n}']", s, False, "", 0, ())
             for n, s in shapes.items()]
    return plan_specs(specs, t, cfg, block)[-1].shard_dim is not None


def local_specs(specs: List[LeafSpec]) -> List[LeafSpec]:
    """A rank's specs: each sharded leaf's slice shape, the whole leaf's
    side and rank (so ``low_shape`` and ``proj_shape`` are the rank's
    pieces of the low-rank state and of P, by the table of
    ``core/projector.py``)."""
    out = []
    for s in specs:
        if s.shard_dim is None:
            out.append(s)
            continue
        shape = list(s.shape)
        shape[len(shape) - 2 + s.shard_dim] //= s.tp
        out.append(dataclasses.replace(s, shape=tuple(shape)))
    return out


# ---------------------------------------------------------------------------
# Moving between whole leaves and a rank's slices
# ---------------------------------------------------------------------------

def _slice(x, dim_from_end: int, index: int, world: int):
    """Slice ``index`` of ``world`` along dim ``-dim_from_end`` of a tensor
    or of a QTensor's codes, scales and zeros (whole blocks, by the rule)."""
    def one(t):
        ax = t.ndim - dim_from_end
        size = t.shape[ax] // world
        return t.narrow(ax, index * size, size).contiguous()
    return x.map(one) if isinstance(x, QTensor) else one(x)


def _axis(shard_dim: int) -> int:
    """The dim, counted from the end, of a matrix's ``shard_dim``."""
    return 2 - shard_dim


def shard_leaf(x, spec: LeafSpec, index: int):
    if spec.shard_dim is None:
        return x
    if isinstance(x, QTensor) and spec.shard_dim == 1:
        part = _slice(x, 1, index, spec.tp)
        return dataclasses.replace(part, orig_last=x.orig_last // spec.tp)
    return _slice(x, _axis(spec.shard_dim), index, spec.tp)


def gather_leaf(x, spec: LeafSpec, comm: Comm):
    """The whole leaf from the ranks' slices (an all-gather of codes,
    scales and zeros in one collective)."""
    if spec.shard_dim is None:
        return x
    ax = _axis(spec.shard_dim)
    if not isinstance(x, QTensor):
        return comm.all_gather(x, x.ndim - ax)
    ts = [t for t in (x.q, x.scale, x.zero) if t is not None]
    whole = comm.all_gather_many([(t, t.ndim - ax) for t in ts])
    zero = whole[2] if x.zero is not None else None
    return QTensor(whole[0], whole[1], zero, x.bits, x.block,
                   x.orig_last * (spec.tp if spec.shard_dim == 1 else 1),
                   x.dtype)


def shard_params(params, specs: List[LeafSpec], mesh, model_rank: int):
    """This model rank's slice of every leaf that ``specs`` (whole-leaf,
    :func:`plan_specs`) shard; ``mesh``: the ``(D, t)`` mesh shape (its
    model size must be the specs' degree)."""
    t = int(mesh[1])
    flat = qgalore.flatten(params)
    out = []
    for (keys, leaf), spec in zip(flat, specs):
        if spec.shard_dim is not None and spec.tp != t:
            raise ValueError(f"{spec.path}: planned for {spec.tp} ranks, "
                             f"the mesh has {t}")
        out.append(shard_leaf(leaf, spec, model_rank))
    return qgalore.unflatten([k for k, _ in flat], out)


def serving_params(params, cfg, mesh, model_rank: int):
    """This model rank's slices of a serving tree (the whole INT8 weights,
    ``serve.params.quantize_leaf``'s), by :func:`plan_specs` at the
    mesh's model size, as a ``tp_group`` bundle computes on them."""
    from repro_torch.config import QGaLoreConfig
    specs = plan_specs(qgalore.leaf_specs(params, QGaLoreConfig()),
                       int(mesh[1]), cfg)
    return shard_params(params, specs, mesh, model_rank)


def gather_params(params, specs: List[LeafSpec], comm: Comm):
    """Inverse of :func:`shard_params`, on every rank of the model group."""
    flat = qgalore.flatten(params)
    return qgalore.unflatten([k for k, _ in flat], [
        gather_leaf(leaf, spec, comm) for (_, leaf), spec in zip(flat, specs)])


def moment_dim(spec: LeafSpec) -> Optional[int]:
    """The matrix dim a sharded GaLore leaf's moments split on (None:
    replicated), by the table of ``core/projector.py``."""
    if spec.shard_dim is None or \
            projector.proj_dim_sharded(spec.side, spec.shard_dim):
        return None
    return spec.shard_dim


def _moments_spec(spec: LeafSpec) -> LeafSpec:
    if not spec.galore:
        return spec
    return dataclasses.replace(spec, shard_dim=moment_dim(spec))


def shard_opt_leaf(spec: LeafSpec, st, P, index: int) -> tuple:
    """``(st, P)``: one leaf's moments sliced where they split, its P by
    ``projector.shard_projection`` (both bit-exact slices of the whole
    quantizations)."""
    if spec.shard_dim is None or st is None:
        return st, P
    ms = _moments_spec(spec)
    return (Adam8bitState(shard_leaf(st.m, ms, index),
                          shard_leaf(st.v, ms, index)),
            None if P is None else projector.shard_projection(
                P, spec.side, spec.shard_dim, index, spec.tp))


def shard_opt(opt: QGaLoreState, specs: List[LeafSpec], index: int
              ) -> QGaLoreState:
    """A rank's optimizer state from the whole one (:func:`shard_opt_leaf`
    on each leaf)."""
    inner, proj = [], []
    for spec, st, P in zip(specs, opt.inner, opt.proj):
        st, P = shard_opt_leaf(spec, st, P, index)
        inner.append(st)
        proj.append(P)
    return QGaLoreState(inner, proj, opt.count)


def gather_opt(opt: QGaLoreState, specs: List[LeafSpec], comm: Comm
               ) -> QGaLoreState:
    """Inverse of :func:`shard_opt` on every rank of the model group."""
    inner, proj = [], []
    for spec, st, P in zip(specs, opt.inner, opt.proj):
        if spec.shard_dim is None or st is None:
            inner.append(st)
            proj.append(P)
            continue
        ms = _moments_spec(spec)
        inner.append(Adam8bitState(gather_leaf(st.m, ms, comm),
                                   gather_leaf(st.v, ms, comm)))
        if P is not None and projector.proj_dim_sharded(spec.side,
                                                        spec.shard_dim):
            P = gather_leaf(P, dataclasses.replace(spec, shard_dim=0), comm)
        proj.append(P)
    return QGaLoreState(inner, proj, opt.count)


def sharded_uniforms(uniforms, specs: List[LeafSpec], index: int):
    """A uniform source for a rank's slices: a sharded leaf draws the whole
    leaf's uniforms for ``(leaf, layer)`` and keeps this rank's slice, so
    its stochastic rounding is the one process's."""
    def draw(leaf_idx, layer, shape):
        spec = specs[leaf_idx]
        if spec.shard_dim is None:
            return uniforms(leaf_idx, layer, shape)
        full = list(shape)
        full[len(full) - _axis(spec.shard_dim)] *= spec.tp
        return _slice(uniforms(leaf_idx, layer, tuple(full)),
                      _axis(spec.shard_dim), index, spec.tp)
    return draw


# ---------------------------------------------------------------------------
# Expert parallelism: a rank's share of the expert stacks
# ---------------------------------------------------------------------------

def is_expert(path: str) -> bool:
    """An MoE expert stack (``experts_wi``, ``experts_wg``, ``experts_wd``:
    ``(L, E, ..)``, its experts on axis -3)."""
    return "experts_" in path


def expert_specs(specs: List[LeafSpec], world: int) -> List[LeafSpec]:
    """A rank's specs under expert parallelism over ``world`` ranks: each
    expert stack's E/n experts."""
    out = []
    for s in specs:
        if not is_expert(s.path) or len(s.shape) < 3:
            out.append(s)
            continue
        shape = list(s.shape)
        shape[-3] //= world
        out.append(dataclasses.replace(
            s, shape=tuple(shape),
            batch=tuple(shape[:-2]) if s.galore else s.batch))
    return out


def expert_units(spec: LeafSpec, rank: int, world: int) -> List[int]:
    """The whole leaf's flat unit (layer, expert) index of each of this
    rank's units of a local expert spec (``expert_specs``)."""
    e_loc = spec.shape[-3]
    lead = int(np.prod(spec.shape[:-3])) if len(spec.shape) > 3 else 1
    return [l * e_loc * world + rank * e_loc + e
            for l in range(lead) for e in range(e_loc)]


def expert_cut(spec: LeafSpec, x, rank: int, world: int):
    """A weight, 8-bit moments or P of the leaf ``spec`` cut to this rank's
    experts (axis -3) where the leaf is an expert stack; else ``x``."""
    if x is None or not is_expert(spec.path) or len(spec.shape) < 3:
        return x
    if isinstance(x, Adam8bitState):
        return Adam8bitState(expert_cut(spec, x.m, rank, world),
                             expert_cut(spec, x.v, rank, world))
    return _slice(x, 3, rank, world)


def gather_experts(state, specs: List[LeafSpec], comm: Comm):
    """The whole state from the ranks' expert cuts (:func:`expert_cut`), on
    every rank of ``comm``."""
    def whole(x):
        if x is None:
            return None
        if isinstance(x, QTensor):
            ts = [t for t in (x.q, x.scale, x.zero) if t is not None]
            got = comm.all_gather_many([(t, t.ndim - 3) for t in ts])
            return QTensor(got[0], got[1], got[2] if x.zero is not None
                           else None, x.bits, x.block, x.orig_last, x.dtype)
        return comm.all_gather(x, x.ndim - 3)
    flat = qgalore.flatten(state.params)
    params, inner, proj = [], list(state.opt.inner), list(state.opt.proj)
    for i, ((_, leaf), spec) in enumerate(zip(flat, specs)):
        if not is_expert(spec.path) or len(spec.shape) < 3:
            params.append(leaf)
            continue
        params.append(whole(leaf))
        if inner[i] is not None:
            inner[i] = Adam8bitState(whole(inner[i].m), whole(inner[i].v))
        proj[i] = whole(proj[i])
    return type(state)(qgalore.unflatten([k for k, _ in flat], params),
                       QGaLoreState(inner, proj, state.opt.count))
