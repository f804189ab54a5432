"""The training step: fused projected backward + Q-GaLore update (the
counterpart of the ``impl="fused"`` path of ``repro/train/step.py``), on
one device or data-parallel over the ranks of a process group, and on a
``(D, t)`` mesh tensor- and expert-parallel (:func:`build_train_step`).

A steady step emits GaLore gradients low-rank straight out of the
per-layer backward and updates them through the fused kernel; a refresh
step (a non-empty mask from the controller) takes full-rank gradients so
the masked per-layer subspace refresh can run. With ``accum > 1`` the
batch splits into ``accum`` microbatches along its first axis; their
gradients (low-rank on steady steps, full-rank on refresh steps) are
summed in float32 and divided by ``accum``, the loss is their mean and the
other metrics are the last microbatch's, as the reference's scan does.

Every stochastic rounding draws from a *uniform source*
``uniforms(step, leaf_idx, layer or None, shape) -> float32 tensor``, and
the randomized subspace method from a *normal source* ``omegas(step,
leaf_idx, unit, (k, p))``. The defaults, :func:`generator_uniforms` and
:func:`generator_normals`, seed a ``torch.Generator`` on the device from
the step and the leaf; a test passes the JAX package's own draws instead.
No source depends on the rank: every rank of a data-parallel run draws
the same numbers.

Data parallelism (the reference's ``dp_compress=True``, with a group and
``compress_dp_grads``): each rank runs the backward on its own rows, so
a steady step's GaLore gradients leave it low-rank, and then

* a frozen leaf's gradient becomes zeros, with no reduction;
* at a refresh step, a stacked GaLore leaf whose layer count the world
  divides (``dist_refresh``) is reduce-scattered full-rank over its
  layers: each rank refreshes P for the layers it owns
  (``qgalore.refresh_slice`` with global layer indices), projects them,
  and the low-rank gradients, the new P and the similarities are
  all-gathered, so the leaf reaches the clip low-rank and the optimizer
  as a steady leaf (the clip norm of such a step is not the one-device
  one; it is the reference's data-parallel one);
* under ZeRO-2 (``zero2_dims``) a steady low-rank gradient is
  reduce-scattered along its moment's split dim, and the clip norm sums
  the ranks' slices;
* every other gradient, the loss and the metrics are averaged (f32).

``zero`` (a ``distributed.zero.ZeroPartition``): the state holds this
rank's ZeRO slices; the projections are gathered for the backward, and
each leaf's state for its update. Without ``compress_dp_grads`` a group
averages every gradient as emitted and refreshes replicated.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.core import projector, qgalore, transform
from repro_torch.core.qgalore import LeafSpec, QGaLoreState
from repro_torch.core.quant import QTensor, true_div
from repro_torch.core.rules import as_rules
from repro_torch.distributed import tp as tp_lib
from repro_torch.distributed.comm import Comm, MeshComms, as_comm
from repro_torch.models.base import ModelBundle
from repro_torch.serve.params import quantize_leaf
from repro_torch.train import stack

UniformSource = Callable[[int, int, Optional[int], Tuple[int, ...]],
                         torch.Tensor]
NormalSource = Callable[[int, int, int, Tuple[int, int]], torch.Tensor]


class TrainState(NamedTuple):
    params: dict
    opt: QGaLoreState


def prepare_params(params, qcfg, param_dtype=torch.float32,
                   keys: Tuple[str, ...] = ()):
    """INT8 symmetric QTensors where the leaf's ``weight_bits == 8``,
    ``ndim >= 2`` and the last axis is at least 32; other leaves stay
    float32 (1-D norms) or are cast to ``param_dtype`` (float baselines).
    ``qcfg``: a ``QGaLoreConfig`` or a ``ParamRules`` (each leaf's bits
    from its group, by its path; ``keys`` is the path of ``params``)."""
    rules = as_rules(qcfg)
    if isinstance(params, dict):
        return {k: prepare_params(v, rules, param_dtype, keys + (k,))
                for k, v in params.items()}
    eff = rules.config_for(qgalore.keystr(keys))
    if eff.weight_bits == 8:
        return quantize_leaf(params, eff.quant_block)
    if params.ndim >= 2 and params.is_floating_point():
        return params.to(param_dtype)
    return params


def init_state(bundle: ModelBundle, qcfg, seed: int,
               param_dtype=torch.float32,
               specs: Optional[List[LeafSpec]] = None,
               cut=None) -> TrainState:
    """Weights drawn from ``seed`` on the bundle's device, quantized one
    group at a time, and a fresh optimizer state (shaped by ``specs``
    where given, e.g. rank-overridden). ``cut(i, x)``, with ``specs``:
    this rank's part of leaf ``i``'s weight, or of its ``(moments, P)``,
    taken as each is made, so a tensor- or expert-parallel rank holds its
    part and one drawn group whole at a time, never the whole state."""
    gen = torch.Generator(device=bundle.device).manual_seed(seed)

    def prep(keys, t):
        return prepare_params(t, qcfg, param_dtype, keys)
    if cut is None:
        params = bundle.init_params(gen, leaf_fn=prep)
        return TrainState(params, qgalore.init(params, qcfg, seed + 1,
                                               specs))
    index = {s.path: i for i, s in enumerate(specs)}
    params = bundle.init_params(gen, leaf_fn=lambda keys, t: cut(
        index[qgalore.keystr(keys)], prep(keys, t)))
    inner, proj = [], []
    for i, spec in enumerate(specs):
        st, P = cut(i, qgalore.init_leaf(spec, qcfg, seed + 1, i,
                                         bundle.device))
        inner.append(st)
        proj.append(P)
    return TrainState(params, QGaLoreState(inner, proj, 0))


def abstract_params(bundle: ModelBundle, qcfg, param_dtype=torch.float32):
    """The prepared parameters' layout on the ``meta`` device (no memory):
    leaf specs and restore templates come from it. It is built from the
    shapes and dtypes alone: on the meta device the families' inits draw
    nothing (``layers.draw``) and quantization gives a QTensor's layout
    (``quant.quantize_blockwise``), so no meta decomposition runs, and a
    new process does not import ``torch._dynamo`` for it."""
    return bundle.init_params(
        torch.Generator(), device_="meta",
        leaf_fn=lambda keys, t: prepare_params(t, qcfg, param_dtype, keys))


def abstract_state(bundle: ModelBundle, qcfg, param_dtype=torch.float32,
                   specs: Optional[List[LeafSpec]] = None) -> TrainState:
    """:func:`init_state`'s layout on the ``meta`` device; ``specs`` carry
    rank overrides, so the low-rank state matches a shrunk checkpoint."""
    params = abstract_params(bundle, qcfg, param_dtype)
    specs = specs or qgalore.leaf_specs(params, qcfg)
    return TrainState(params, qgalore.state_template(specs, qcfg))


def generator_uniforms(seed: int, device) -> UniformSource:
    """Uniform [0, 1) draws from a ``torch.Generator`` on ``device`` seeded
    by ``(seed, step, leaf_idx, layer)``."""
    def draw(step, leaf_idx, layer, shape):
        key = ((seed * 1_000_003 + step) * 4099 + leaf_idx) * 1031 \
            + (0 if layer is None else layer + 1)
        gen = torch.Generator(device=device).manual_seed(key % (2 ** 63))
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)
    return draw


def generator_normals(seed: int, device) -> NormalSource:
    """Standard normal ``(k, p)`` draws from a ``torch.Generator`` on
    ``device`` seeded by ``(seed, step, leaf_idx, unit)``."""
    def draw(step, leaf_idx, unit, shape):
        key = ((seed * 1_000_033 + step) * 4111 + leaf_idx) * 1049 + unit
        gen = torch.Generator(device=device).manual_seed(key % (2 ** 63))
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)
    return draw


def _microbatch(batch, accum: int, i: int):
    """Microbatch ``i`` of ``accum``: contiguous rows of every input."""
    return {k: v.reshape((accum, v.shape[0] // accum) + tuple(v.shape[1:]))[i]
            for k, v in batch.items()}


def accumulated_value_and_grad(bundle: ModelBundle, params, batch,
                               proj_trees, accum: int, sides=None):
    """``((loss, metrics), grads)`` over ``accum`` microbatches: gradients
    summed in float32 (each microbatch's added into the first's in place,
    layer by layer) then divided by ``accum``, the mean loss, the last
    microbatch's metrics."""
    if accum == 1:
        return stack.fused_value_and_grad(bundle, params, batch, proj_trees,
                                          sides=sides)
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{accum} microbatches")
    acc, loss_sum = None, None
    for i in range(accum):
        (loss, metrics), g = stack.fused_value_and_grad(
            bundle, params, _microbatch(batch, accum, i), proj_trees, acc,
            sides)
        if acc is None:
            flat = qgalore.flatten(g)
            acc = qgalore.unflatten([k for k, _ in flat],
                                    [x.to(torch.float32) for _, x in flat])
            loss_sum = loss.to(torch.float32)
        else:
            loss_sum = loss_sum + loss
        del g
    flat = qgalore.flatten(acc)
    div = torch.full((), accum, dtype=torch.float32, device=loss_sum.device)
    for _, a in flat:
        a.div_(div)
    return (true_div(loss_sum, accum), metrics), acc


def _map_arrays(P, fn):
    return P.map(fn) if isinstance(P, QTensor) else fn(P)


def _reduce(comm: Comm, specs: List[LeafSpec], loss, metrics,
            g_flat: list, dist_now, zero2_now, experts=()):
    """The data-parallel reduction of one step's gradients (in place in
    ``g_flat``), loss and metrics; returns ``(loss, metrics, sliced)``,
    ``sliced`` the leaves left as this rank's ZeRO-2 slice or its owned
    experts. An expert stack (``experts``, expert parallelism on this
    group) is owned: every rank's tokens reached its experts through the
    all-to-all, so its gradient is the sum of the ranks' local-mean
    losses' gradients, and is divided by the world size, not reduced
    (the reference divides by nothing: ROADMAP, reference caveats)."""
    world = comm.world
    sliced = set()
    for i, g in enumerate(g_flat):
        sp = specs[i]
        if sp.frozen:
            g_flat[i] = torch.zeros_like(g)
        elif i in experts:
            g_flat[i] = true_div(g.to(torch.float32), world)
            sliced.add(i)
        elif i in dist_now:
            g_flat[i] = true_div(comm.reduce_scatter(g.to(torch.float32), 0),
                                 world)
        elif i in zero2_now and tuple(g.shape) == sp.low_shape:
            g_flat[i] = true_div(comm.reduce_scatter(g.to(torch.float32),
                                                     zero2_now[i]), world)
            sliced.add(i)
        else:
            g_flat[i] = comm.all_reduce_mean(g)
    # the loss and every metric in one reduction
    names = sorted(metrics)
    parts = [loss] + [torch.as_tensor(metrics[k], device=loss.device)
                      for k in names]
    flat = comm.all_reduce_mean(torch.cat(
        [p.to(torch.float32).reshape(-1) for p in parts]))
    out, at = [], 0
    for p in parts:
        n = p.numel()
        out.append(flat[at:at + n].reshape(p.shape))
        at += n
    return out[0], dict(zip(names, out[1:])), sliced


def _whole_spec(sp: LeafSpec) -> LeafSpec:
    """The whole leaf's spec of a tensor-parallel rank's slice spec."""
    if sp.shard_dim is None:
        return sp
    shape = list(sp.shape)
    shape[len(shape) - 2 + sp.shard_dim] *= sp.tp
    return dataclasses.replace(sp, shape=tuple(shape))


def _whole_proj(model: Optional[Comm], sp: LeafSpec, P):
    """The whole P of a leaf whose P this rank holds a d-slice of."""
    if model is None or not projector.proj_dim_sharded(sp.side,
                                                       sp.shard_dim):
        return P
    return tp_lib.gather_leaf(P, dataclasses.replace(sp, shard_dim=0), model)


def _rank_pieces(model: Optional[Comm], sp: LeafSpec, low, P):
    """This model rank's pieces of a leaf's whole low-rank gradient and
    whole P (``core/projector.py``'s table)."""
    if model is None or sp.shard_dim is None:
        return low, P
    mom = tp_lib.moment_dim(sp)
    if mom is not None:
        low = projector.shard_matrix(low, mom, model.rank, sp.tp).contiguous()
    return low, projector.shard_projection(P, sp.side, sp.shard_dim,
                                           model.rank, sp.tp)


def _retile(model: Optional[Comm], sp: LeafSpec, g: torch.Tensor, own: int
            ) -> torch.Tensor:
    """The whole matrices of this rank's ``own`` layers from a data rank's
    reduced layers ``g`` (``(t·own, ..)``, this model rank's slice of each
    matrix): the model group's all-to-all hands each rank every peer's
    slice of its layers (a replicated leaf is just cut)."""
    if model is None:
        return g.reshape((own,) + sp.mat_shape)
    whole = _whole_spec(sp).mat_shape
    if sp.shard_dim is None:
        return g.reshape((model.world, own) + whole)[model.rank]
    t = model.world
    y = model.all_to_all(g.reshape((t, own) + sp.mat_shape))
    return y.movedim(0, 1 + sp.shard_dim).reshape((own,) + whole)


def _dist_refresh(front: Comm, model: Optional[Comm], specs: List[LeafSpec],
                  rules, g_flat: list, proj: list, masks, dist_now, omegas):
    """The distributed refresh of the leaves ``dist_now`` over ``front``
    (the data group, or on a ``(D, t)`` mesh the combined front of all
    D·t ranks, ``rank = d·t + m``), whose entries of ``g_flat`` hold this
    data rank's layers of the reduced full-rank gradient: each rank takes
    the whole matrices of its L/(D·t) layers (:func:`_retile`), refreshes
    and projects them (``qgalore.refresh_slice`` with global layer
    indices), and the low-rank gradients, the new P and the similarities
    are all-gathered over the front, so the leaf reaches the clip
    low-rank and the optimizer as a steady leaf; each rank keeps its
    pieces (:func:`_rank_pieces`). Returns ``(sims, ratios)`` by path."""
    world, rank = front.world, front.rank
    sims, ratios = {}, {}
    for i in dist_now:
        sp = specs[i]
        whole = _whole_spec(sp)
        b_loc = sp.nbatch // world
        lo, hi = rank * b_loc, (rank + 1) * b_loc
        g_loc = _retile(model, sp, g_flat[i], b_loc)
        P_all = qgalore._flat_batch(_whole_proj(model, sp, proj[i]),
                                    sp.nbatch, len(sp.batch))
        P_loc = _map_arrays(P_all, lambda t: t[lo:hi])
        del P_all
        mask = np.asarray(masks[i]).reshape(-1)[lo:hi]
        leaf_omegas = None if omegas is None else \
            (lambda unit, shape, i=i: omegas(i, unit, shape))
        P_new, s_loc, r_loc = qgalore.refresh_slice(
            g_loc, P_loc, mask, list(range(lo, hi)), whole,
            qgalore._eff_cfg(sp, rules), leaf_omegas)
        low = stack.project_leaf(g_loc, P_new, sp.side)
        del g_loc
        # the low-rank gradient, P and the similarities (and ratios) of
        # the owned layers, in one all-gather over their layer dim
        dev = low.device
        parts = [low]
        _map_arrays(P_new, lambda t: parts.append(t) or t)
        parts += [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (s_loc, r_loc) if x is not None]
        got = iter(front.all_gather_many([(t, 0) for t in parts]))
        low = next(got).reshape(whole.low_shape)
        P_new = qgalore._unflat_batch(_map_arrays(P_new, lambda t: next(got)),
                                      sp.batch)
        g_flat[i], proj[i] = _rank_pieces(model, sp, low, P_new)
        sims[sp.path] = next(got).cpu().numpy()
        if r_loc is not None:
            ratios[sp.path] = next(got).cpu().numpy()
    return sims, ratios


def _gathered_refresh(model: Comm, specs: List[LeafSpec], rules,
                      g_flat: list, proj: list, masks, leaves, omegas):
    """The refresh of tensor-parallel leaves outside the distributed one
    (no layer stack that the front divides), replicated on the (clipped)
    gradient gathered over the model group, as GSPMD does for the
    reference: every rank refreshes the whole leaf, projects the whole
    gradient, and keeps its pieces, so the leaf reaches the optimizer as
    a steady leaf. A leaf sharded on its surviving dim under the
    randomized method gathers nothing full-rank: its range finder runs on
    the ranks' shards (``projector.randomized_sharded``) and each rank
    projects its own. Under adaptive rank a refreshed layer's
    explained-variance profile comes from the rank's shard
    (``projector.explained_ratio_sharded``, summed over the group).
    Returns ``(sims, ratios)`` by path."""
    sims, ratios = {}, {}
    for i in leaves:
        sp = specs[i]
        whole = _whole_spec(sp)
        cfg = qgalore._eff_cfg(sp, rules)
        leaf_omegas = None if omegas is None else \
            (lambda unit, shape, i=i: omegas(i, unit, shape))
        g_loc = g_flat[i].reshape((sp.nbatch,) + sp.mat_shape)

        def ratio_of(sel, P_fresh, sp=sp, g_loc=g_loc):
            P_mine = projector.shard_projection(P_fresh, sp.side,
                                                sp.shard_dim, model.rank,
                                                sp.tp)
            return projector.explained_ratio_sharded(
                g_loc[sel], P_mine, sp.side, sp.shard_dim,
                model.all_reduce_sum)
        if cfg.subspace_method == "randomized" and \
                not projector.proj_dim_sharded(sp.side, sp.shard_dim):
            def subspace_of(g_sel, omega, sp=sp, cfg=cfg):
                return projector.randomized_sharded(
                    g_sel, sp.rank, sp.side, sp.shard_dim, omega,
                    model.rank, model.all_reduce_sum,
                    lambda t: model.all_gather(t, t.ndim - 1),
                    cfg.subspace_iters)
            P_new, s, r = qgalore.refresh_leaf(
                g_flat[i], proj[i], masks[i], whole, cfg, leaf_omegas,
                ratio_of, subspace_of)
            g_flat[i] = stack.project_leaf(g_flat[i], P_new, sp.side)
            proj[i] = P_new
        else:
            G = tp_lib.gather_leaf(g_flat[i].to(torch.float32), sp, model)
            P_new, s, r = qgalore.refresh_leaf(
                G, _whole_proj(model, sp, proj[i]), masks[i], whole, cfg,
                leaf_omegas, ratio_of)
            low = stack.project_leaf(G, P_new, sp.side)
            del G
            g_flat[i], proj[i] = _rank_pieces(model, sp, low, P_new)
        sims[sp.path] = s
        if r is not None:
            ratios[sp.path] = r
    return sims, ratios


def _dist_refresh_leaves(specs: List[LeafSpec], rules, world: int):
    """The leaves a data-parallel refresh step refreshes distributed:
    stacked GaLore leaves whose layer count ``world`` (the front's ranks)
    divides, expert stacks apart (their experts are owned)."""
    base = as_rules(rules).base
    if not (base.compress_dp_grads and base.dist_refresh):
        return set()
    return {i for i, s in enumerate(specs)
            if s.galore and s.batch and s.batch[0] % world == 0
            and not tp_lib.is_expert(s.path)}


def _expert_draws(uniforms, omegas, specs: List[LeafSpec], ep: Comm):
    """Uniform and normal sources for a rank's expert stacks: each local
    (layer, expert) unit draws as the whole leaf's unit of that expert
    does (``tp.expert_units``), so its rounding is the one process's."""
    units = {i: tp_lib.expert_units(s, ep.rank, ep.world)
             for i, s in enumerate(specs) if tp_lib.is_expert(s.path)
             and len(s.shape) >= 3}

    def draw(leaf, layer, shape):
        if leaf in units and layer is not None:
            layer = units[leaf][layer]
        return uniforms(leaf, layer, shape)

    def normal(leaf, unit, shape):
        return omegas(leaf, units[leaf][unit] if leaf in units else unit,
                      shape)
    return draw, None if omegas is None else normal, units


def build_train_step(bundle: ModelBundle, qcfg, tcfg: TrainConfig,
                     specs: List[LeafSpec], accum: int = 1, group=None,
                     zero2_dims: Optional[Dict[int, int]] = None,
                     zero=None):
    """``step(state, batch, lr, step_idx, uniforms, refresh_masks,
    omegas)`` → ``(state, metrics, opt_metrics)``; a non-empty
    ``refresh_masks`` (``{leaf_idx: (nbatch,) bool}``) makes it a refresh
    step. ``qcfg``: a ``QGaLoreConfig`` or a ``ParamRules``; ``accum``
    microbatches a step. The optimizer half is the canonical transform
    (``transform.qgalore_transform``: project -> quantized_adam ->
    backproject -> sr_requant), executed by ``qgalore.apply_updates``.

    ``group`` (a ``distributed.comm.Comm``, a process group, or the
    ``MeshComms`` of a ``(D, t)`` mesh): run data-parallel over its data
    group, ``batch`` being this rank's rows (module docstring);
    ``zero`` (a ``ZeroPartition``): the state holds this rank's ZeRO
    slices; ``zero2_dims`` (``{leaf: dim}``, ``ZeroPartition.zero2_dims``)
    needs ``compress_dp_grads``.

    Tensor parallelism (a bundle built with ``tp_group``, the mesh's
    model group): ``specs`` are this rank's (``distributed.tp.
    local_specs``) and the state its slices. The backward emits each
    sharded leaf's piece of the low-rank gradient; where the shard lies
    on the contracted dim (``projector.proj_dim_sharded``) the pieces
    are partial products, summed in one all-reduce over the model group
    for all such leaves (``projector.project_sharded``'s psum), before
    the data group's reduction. A refresh step refreshes a stacked leaf
    whose layers the D·t ranks divide over the combined front
    (:func:`_dist_refresh`), and every other sharded leaf on its gradient
    gathered over the model group (:func:`_gathered_refresh`). The
    stochastic rounding of a slice draws the whole leaf's uniforms and
    keeps its slice (``tp.sharded_uniforms``). Expert parallelism (a
    bundle built with ``ep_group``, the data group): an expert stack's
    gradient is owned (:func:`_reduce`), it refreshes in the optimizer on
    the rank's experts, and its draws are the whole leaf's units'
    (:func:`_expert_draws`); its similarities are gathered for the
    controller.

    A bundle built with ``flash_attention=True`` is refused: the flash
    kernel has no backward."""
    if bundle.flash_attention:
        raise ValueError("training through the flash-attention route needs "
                         "a backward kernel, which is not ported; build the "
                         "bundle with flash_attention=False")
    if accum < 1:
        raise ValueError(f"accum must be at least 1, got {accum}")
    rules = as_rules(qcfg)
    groups = group if isinstance(group, MeshComms) else None
    comm = as_comm(groups.data if groups is not None else group)
    model = bundle.tp
    ep = bundle.ep
    if model is not None and (groups is None
                              or groups.model.world != model.world):
        raise ValueError("a tensor-parallel bundle trains on the MeshComms "
                         "of its (D, t) mesh (group=)")
    if ep is not None and (comm is None or comm.world != ep.world):
        raise ValueError("an expert-parallel bundle trains over its "
                         "ep_group as the data group (group=)")
    if ep is not None and zero is not None:
        raise NotImplementedError(
            "ZeRO beside expert parallelism is not ported (ROADMAP queue 1, "
            "5b follow-up)")
    compress = comm is not None and rules.base.compress_dp_grads
    if zero2_dims and not compress:
        raise ValueError("the ZeRO-2 reduce-scatter needs a process group "
                         "and compress_dp_grads=True")
    tx = transform.qgalore_transform(qcfg, specs=specs)
    any_galore = any(s.galore for s in specs)
    world = comm.world if comm is not None else 1
    # the distributed refresh's front: the combined (data x model) ranks
    front = comm if model is None else groups.world
    dist_ok = _dist_refresh_leaves(
        specs, rules, world * (model.world if model else 1)) \
        if compress and any_galore else set()
    experts = {i for i, s in enumerate(specs)
               if ep is not None and tp_lib.is_expert(s.path)}
    zero2 = {i: d for i, d in (zero2_dims or {}).items()
             if specs[i].galore and specs[i].low_shape[d] % world == 0
             and i not in experts}
    sharded = {i for i, s in enumerate(specs) if model is not None
               and s.shard_dim is not None}
    # leaves whose low-rank pieces are partial products (summed over the
    # model group) and leaves whose gradients are the rank's slice
    psum = {i for i in sharded if specs[i].galore
            and projector.proj_dim_sharded(specs[i].side, specs[i].shard_dim)}
    sides = None
    if model is not None:
        sides = qgalore.unflatten(
            [k for k, _ in qgalore.flatten(bundle.init_params(
                torch.Generator(), device_="meta"))],
            [s.side if s.galore else None for s in specs])

    def step(state: TrainState, batch, lr: float, step_idx: int,
             uniforms: UniformSource,
             refresh_masks: Optional[Dict[int, np.ndarray]] = None,
             omegas: Optional[NormalSource] = None):
        params, opt = state
        refresh = bool(refresh_masks)
        step_omegas = None if omegas is None else \
            (lambda leaf, unit, shape: omegas(step_idx, leaf, unit, shape))
        step_uniforms = lambda leaf, layer, shape: uniforms(step_idx, leaf,
                                                            layer, shape)
        if model is not None:
            step_uniforms = tp_lib.sharded_uniforms(step_uniforms, specs,
                                                    model.rank)
        ex_units = {}
        if experts:
            step_uniforms, step_omegas, ex_units = _expert_draws(
                step_uniforms, step_omegas, specs, ep)
        if zero is not None:     # the backward and the refresh take P whole
            opt = opt._replace(proj=zero.gather_proj(opt.proj))
        keys = [k for k, _ in qgalore.flatten(params)]
        proj_trees = {}
        if any_galore and not refresh:
            proj_trees = qgalore.unflatten(keys, opt.proj)
        (loss, metrics), grads = accumulated_value_and_grad(
            bundle, params, batch, proj_trees, accum, sides)
        sliced, dist_sims, dist_ratios = set(), {}, {}
        g_flat = [g for _, g in qgalore.flatten(grads)]
        del grads
        if psum and proj_trees:      # the partial low-rank products, summed
            _sum_over(model, g_flat, sorted(psum))
        if comm is not None:
            dist_now = [i for i in sorted(dist_ok)
                        if refresh and i in refresh_masks]
            loss, metrics, sliced = _reduce(
                comm, specs, loss, metrics, g_flat, dist_now,
                zero2 if proj_trees else {}, experts)
            if dist_now:
                proj = list(opt.proj)
                dist_sims, dist_ratios = _dist_refresh(
                    front, model, specs, rules, g_flat, proj, refresh_masks,
                    dist_now, step_omegas)
                opt = opt._replace(proj=proj)
                refresh_masks = {i: m for i, m in refresh_masks.items()
                                 if i not in dist_now}
        # a sharded leaf's gradient is the rank's slice, but a low-rank
        # piece that the model group summed
        m_sliced = {i for i in sharded if i not in psum
                    or tuple(g_flat[i].shape) == specs[i].shape}
        grads = qgalore.unflatten(keys, g_flat)
        grads, gnorm = transform.clip_by_global_norm(
            grads, tcfg.grad_clip, specs=specs, comm=comm, sliced=sliced,
            model=model, model_sliced=m_sliced)
        # the other sharded leaves refresh after the clip, on the clipped
        # full-rank gradient, as the reference's replicated refresh does
        gathered = [i for i in sorted(sharded) if refresh and specs[i].galore
                    and i in refresh_masks]
        if gathered:
            g_flat = [g for _, g in qgalore.flatten(grads)]
            proj = list(opt.proj)
            g_sims, g_ratios = _gathered_refresh(
                model, specs, rules, g_flat, proj, refresh_masks, gathered,
                step_omegas)
            dist_sims, dist_ratios = ({**dist_sims, **g_sims},
                                      {**dist_ratios, **g_ratios})
            grads = qgalore.unflatten(keys, g_flat)
            opt = opt._replace(proj=proj)
            refresh_masks = {i: m for i, m in refresh_masks.items()
                             if i not in gathered}
        if ex_units and refresh_masks:   # this rank's units of the masks
            refresh_masks = {i: (np.asarray(m).reshape(-1)[ex_units[i]]
                                 if i in ex_units else m)
                             for i, m in refresh_masks.items()}
        new_params, new_opt, opt_metrics = tx.update(
            grads, opt, params, lr=lr, uniforms=step_uniforms,
            omegas=step_omegas, refresh_masks=refresh_masks,
            refresh=refresh, zero=zero)
        if ex_units and opt_metrics["sims"]:
            opt_metrics = _gather_expert_metrics(ep, specs, ex_units,
                                                 opt_metrics)
        if dist_sims:
            opt_metrics = {"sims": {**dist_sims, **opt_metrics["sims"]},
                           "ratios": {**dist_ratios, **opt_metrics["ratios"]}}
        metrics = {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_params, new_opt), metrics, opt_metrics

    step.dist_refresh = sorted(dist_ok)
    step.zero2_dims = dict(zero2)
    step.psum_leaves = sorted(psum)

    return step


def _sum_over(comm: Comm, g_flat: list, idx: List[int]) -> None:
    """``g_flat[i]`` for ``i`` in ``idx`` summed over ``comm``'s ranks, in
    one all-reduce of their float32 values (in place in ``g_flat``)."""
    parts = [g_flat[i].to(torch.float32).reshape(-1) for i in idx]
    flat = comm.all_reduce_sum(torch.cat(parts))
    at = 0
    for i, p in zip(idx, parts):
        g_flat[i] = flat[at:at + p.numel()].reshape(g_flat[i].shape)
        at += p.numel()


def _gather_expert_metrics(ep: Comm, specs: List[LeafSpec], units: dict,
                           opt_metrics: dict) -> dict:
    """The similarities (and ratios) of the ranks' expert units in the
    whole leaf's unit order: every rank's controller sees every expert."""
    out = {"sims": dict(opt_metrics["sims"]),
           "ratios": dict(opt_metrics["ratios"])}
    for i in sorted(units):
        path = specs[i].path
        for key in ("sims", "ratios"):
            if path not in out[key]:
                continue
            loc = torch.from_numpy(np.ascontiguousarray(out[key][path]))
            got = ep.all_gather(loc.reshape((1, -1) + tuple(loc.shape[1:])),
                                0).numpy()
            whole = np.empty((got.shape[0] * got.shape[1],)
                             + got.shape[2:], got.dtype)
            for r in range(ep.world):
                whole[tp_lib.expert_units(specs[i], r, ep.world)] = got[r]
            out[key][path] = whole
    return out
