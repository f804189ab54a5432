"""The training step: fused projected backward + Q-GaLore update (the
counterpart of the ``impl="fused"`` path of ``repro/train/step.py``), on
one device or data-parallel over the ranks of a process group.

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

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import TrainConfig
from repro_torch.core import qgalore, transform
from repro_torch.core.qgalore import LeafSpec, QGaLoreState
from repro_torch.core.quant import QTensor, true_div
from repro_torch.core.rules import as_rules
from repro_torch.distributed.comm import Comm, as_comm
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
               specs: Optional[List[LeafSpec]] = None) -> TrainState:
    """Weights drawn from ``seed`` on the bundle's device, quantized one
    group at a time, and a fresh optimizer state (shaped by ``specs``
    where given, e.g. rank-overridden)."""
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    params = bundle.init_params(
        gen, leaf_fn=lambda keys, t: prepare_params(t, qcfg, param_dtype,
                                                    keys))
    return TrainState(params, qgalore.init(params, qcfg, seed + 1, specs))


def abstract_params(bundle: ModelBundle, qcfg, param_dtype=torch.float32):
    """The prepared parameters' layout on the ``meta`` device (no memory):
    leaf specs and restore templates come from it."""
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
                               proj_trees, accum: int):
    """``((loss, metrics), grads)`` over ``accum`` microbatches: gradients
    summed in float32 (each microbatch's added into the first's in place,
    layer by layer) then divided by ``accum``, the mean loss, the last
    microbatch's metrics."""
    if accum == 1:
        return stack.fused_value_and_grad(bundle, params, batch, proj_trees)
    rows = next(iter(batch.values())).shape[0]
    if rows % accum:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{accum} microbatches")
    acc, loss_sum = None, None
    for i in range(accum):
        (loss, metrics), g = stack.fused_value_and_grad(
            bundle, params, _microbatch(batch, accum, i), proj_trees, acc)
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
            g_flat: list, dist_now, zero2_now):
    """The data-parallel reduction of one step's gradients (in place in
    ``g_flat``), loss and metrics; returns ``(loss, metrics, sliced)``,
    ``sliced`` the leaves left as this rank's ZeRO-2 slice."""
    world = comm.world
    sliced = set()
    for i, g in enumerate(g_flat):
        sp = specs[i]
        if sp.frozen:
            g_flat[i] = torch.zeros_like(g)
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


def _dist_refresh(comm: Comm, specs: List[LeafSpec], rules, g_flat: list,
                  proj: list, masks, dist_now, omegas):
    """The distributed refresh of the leaves ``dist_now``, whose entries
    of ``g_flat`` hold this rank's layers of the reduced full-rank
    gradient: refresh and project the owned layers, all-gather the
    low-rank gradients (into ``g_flat``), the new P (into ``proj``) and
    the similarities. Returns ``(sims, ratios)`` by path."""
    world, rank = comm.world, comm.rank
    sims, ratios = {}, {}
    for i in dist_now:
        sp = specs[i]
        b_loc = sp.nbatch // world
        lo, hi = rank * b_loc, (rank + 1) * b_loc
        g_loc = g_flat[i].reshape((b_loc,) + sp.mat_shape)
        P_loc = _map_arrays(qgalore._flat_batch(proj[i], sp.nbatch,
                                                len(sp.batch)),
                            lambda t: t[lo:hi])
        mask = np.asarray(masks[i]).reshape(-1)[lo:hi]
        leaf_omegas = None if omegas is None else \
            (lambda unit, shape, i=i: omegas(i, unit, shape))
        P_new, s_loc, r_loc = qgalore.refresh_slice(
            g_loc, P_loc, mask, list(range(lo, hi)), sp,
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
        whole = iter(comm.all_gather_many([(t, 0) for t in parts]))
        g_flat[i] = next(whole).reshape(sp.low_shape)
        proj[i] = qgalore._unflat_batch(
            _map_arrays(P_new, lambda t: next(whole)), sp.batch)
        sims[sp.path] = next(whole).cpu().numpy()
        if r_loc is not None:
            ratios[sp.path] = next(whole).cpu().numpy()
    return sims, ratios


def _dist_refresh_leaves(specs: List[LeafSpec], rules, world: int):
    """The leaves a data-parallel refresh step refreshes distributed:
    stacked GaLore leaves whose layer count ``world`` divides."""
    base = as_rules(rules).base
    if not (base.compress_dp_grads and base.dist_refresh):
        return set()
    return {i for i, s in enumerate(specs)
            if s.galore and s.batch and s.batch[0] % world == 0}


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

    ``group`` (a ``distributed.comm.Comm`` or a process group): run
    data-parallel, ``batch`` being this rank's rows (module docstring);
    ``zero`` (a ``ZeroPartition``): the state holds this rank's ZeRO
    slices; ``zero2_dims`` (``{leaf: dim}``, ``ZeroPartition.zero2_dims``)
    needs ``compress_dp_grads``.

    A bundle built with ``flash_attention=True`` is refused: the flash
    kernel has no backward."""
    if bundle.flash_attention:
        raise ValueError("training through the flash-attention route needs "
                         "a backward kernel, which is not ported; build the "
                         "bundle with flash_attention=False")
    if accum < 1:
        raise ValueError(f"accum must be at least 1, got {accum}")
    rules = as_rules(qcfg)
    comm = as_comm(group)
    compress = comm is not None and rules.base.compress_dp_grads
    if zero2_dims and not compress:
        raise ValueError("the ZeRO-2 reduce-scatter needs a process group "
                         "and compress_dp_grads=True")
    tx = transform.qgalore_transform(qcfg, specs=specs)
    any_galore = any(s.galore for s in specs)
    world = comm.world if comm is not None else 1
    dist_ok = _dist_refresh_leaves(specs, rules, world) \
        if compress and any_galore else set()
    zero2 = {i: d for i, d in (zero2_dims or {}).items()
             if specs[i].galore and specs[i].low_shape[d] % world == 0}

    def step(state: TrainState, batch, lr: float, step_idx: int,
             uniforms: UniformSource,
             refresh_masks: Optional[Dict[int, np.ndarray]] = None,
             omegas: Optional[NormalSource] = None):
        params, opt = state
        refresh = bool(refresh_masks)
        step_omegas = None if omegas is None else \
            (lambda leaf, unit, shape: omegas(step_idx, leaf, unit, shape))
        if zero is not None:     # the backward and the refresh take P whole
            opt = opt._replace(proj=zero.gather_proj(opt.proj))
        keys = [k for k, _ in qgalore.flatten(params)]
        proj_trees = {}
        if any_galore and not refresh:
            proj_trees = qgalore.unflatten(keys, opt.proj)
        (loss, metrics), grads = accumulated_value_and_grad(
            bundle, params, batch, proj_trees, accum)
        sliced, dist_sims, dist_ratios = set(), {}, {}
        if comm is not None:
            dist_now = [i for i in sorted(dist_ok)
                        if refresh and i in refresh_masks]
            g_flat = [g for _, g in qgalore.flatten(grads)]
            del grads
            loss, metrics, sliced = _reduce(
                comm, specs, loss, metrics, g_flat, dist_now,
                zero2 if proj_trees else {})
            if dist_now:
                proj = list(opt.proj)
                dist_sims, dist_ratios = _dist_refresh(
                    comm, specs, rules, g_flat, proj, refresh_masks,
                    dist_now, step_omegas)
                opt = opt._replace(proj=proj)
                refresh_masks = {i: m for i, m in refresh_masks.items()
                                 if i not in dist_now}
            grads = qgalore.unflatten(keys, g_flat)
        grads, gnorm = transform.clip_by_global_norm(
            grads, tcfg.grad_clip, specs=specs, comm=comm, sliced=sliced)
        new_params, new_opt, opt_metrics = tx.update(
            grads, opt, params, lr=lr,
            uniforms=lambda leaf, layer, shape: uniforms(step_idx, leaf,
                                                         layer, shape),
            omegas=step_omegas, refresh_masks=refresh_masks,
            refresh=refresh, zero=zero)
        if dist_sims:
            opt_metrics = {"sims": {**dist_sims, **opt_metrics["sims"]},
                           "ratios": {**dist_ratios, **opt_metrics["ratios"]}}
        metrics = {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_params, new_opt), metrics, opt_metrics

    step.dist_refresh = sorted(dist_ok)
    step.zero2_dims = dict(zero2)

    return step

