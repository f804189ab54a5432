"""The training loop: adaptive subspace control, rank adaptation,
checkpoint and resume, fault recovery, straggler detection (the
counterpart of ``repro/train/trainer.py``), on one device or
data-parallel over the ranks of a process group.

Each step: the batch at ``(seed, step)``, the learning rate from the
schedule, the controller's refresh masks; a refresh step hands its
per-layer similarities (and, under ``adaptive_rank``, explained-variance
profiles) back to the controller, and a rank decision migrates the state
and rebuilds the specs and the step (:meth:`Trainer._migrate_ranks`).
Every stochastic rounding draws from ``uniforms`` and every randomized
test matrix from ``omegas`` (defaults :func:`step.generator_uniforms`,
:func:`step.generator_normals`), so a step is replayable: a restart from
the checkpoint of step N repeats the run from N + 1.

``run`` retries a failed step after restoring the last checkpoint, within
a budget of ``max_failures``; a straggler monitor flags steps slower than
``factor`` times the running median.

With a group of D ranks (every rank builds its own ``Trainer``), rank r
takes rows ``[r·B/D, (r+1)·B/D)`` of each global batch and the step runs
data-parallel (``train/step.py``). Every rank draws the same init, the
same uniforms and omegas, and feeds its controller the same gathered
similarities, so every rank takes the same refresh and rank decisions.
``zero_shard`` keeps only this rank's ZeRO slices of the optimizer state
(``distributed/zero.py``); a checkpoint holds the whole state, written by
rank 0, and restores under any world size and mesh.

On a ``(D, t)`` mesh (``mesh=``, or a ``MeshComms`` as ``group``) the
bundle, built with ``tp_group`` (the model group), computes on this
rank's slices (``distributed/tp.py``): data rank d takes rows
``[d·B/D, (d+1)·B/D)``, the t ranks of a data rank the same rows. The
controller keeps the whole leaves' specs (``tp.plan_specs``); the step and
the optimizer state run on the rank's (``tp.local_specs``). A bundle
built with ``ep_group`` (the data group) holds its E/D experts; the
trainer keeps their state alone.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ShapeCell, TrainConfig
from repro_torch.core import adaptive, optimizers, qgalore
from repro_torch.core.adam8bit import Adam8bitState
from repro_torch.core.quant import QTensor
from repro_torch.core.rules import as_rules, group_assignment
from repro_torch.data.synthetic import batch_for_bundle
from repro_torch.distributed import tp as tp_lib
from repro_torch.distributed.comm import MeshComms, as_comm, mesh_comms
from repro_torch.distributed.sharding import Mesh
from repro_torch.distributed.zero import (ZeroPartition, require_zero2,
                                          state_nbytes)
from repro_torch.models import base
from repro_torch.models.base import ModelBundle
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import step as step_lib

log = logging.getLogger("repro_torch.trainer")


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 50
    times: List[float] = field(default_factory=list)
    events: List[Dict] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        if len(self.times) >= 10 and dt > self.factor * med:
            self.events.append({"step": step, "dt": dt, "median": med})
            log.warning("straggler step %d: %.3fs vs median %.3fs",
                        step, dt, med)
            return True
        return False


def _to(x, device):
    """A weight, 8-bit moments or P (or None) on ``device`` (None: where
    it is)."""
    if x is None or device is None:
        return x
    if isinstance(x, Adam8bitState):
        return Adam8bitState(_to(x.m, device), _to(x.v, device))
    if isinstance(x, QTensor):
        return x.map(lambda t: t.to(device))
    return x.to(device)


class Trainer:
    def __init__(self, bundle: ModelBundle, tcfg: TrainConfig, qcfg, *,
                 cell: Optional[ShapeCell] = None,
                 param_dtype=torch.float32, accum: int = 1,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 state: Optional[step_lib.TrainState] = None,
                 uniforms: Optional[step_lib.UniformSource] = None,
                 omegas: Optional[step_lib.NormalSource] = None,
                 batches=None, eval_batches=None, group=None,
                 zero_shard: bool = False, zero2: Optional[bool] = None,
                 mesh=None):
        """``qcfg``: a ``QGaLoreConfig`` or a ``ParamRules``. ``state``: a
        starting TrainState, whole (default: drawn from ``tcfg.seed``);
        ``batches`` / ``eval_batches``: ``step -> batch`` of the global
        batch (default: the synthetic LM stream of ``cell`` at
        ``tcfg.seed`` / ``seed + 1``); ``fault_hook(step)`` runs before each
        step and may raise.

        ``group`` (a process group or ``distributed.comm.Comm``): train
        data-parallel over its ranks, on the ``(D, 1)`` mesh, or with
        ``mesh=(D, t)`` on that mesh (``group`` then spans all D·t ranks;
        a ``MeshComms`` carries its mesh). ``zero_shard`` partitions the
        optimizer state over the data group; ``zero2`` (default: as
        ``zero_shard``) reduce-scatters the steady low-rank gradients onto
        that partition, and forced on needs ``zero_shard`` and
        ``compress_dp_grads``."""
        self.rules = as_rules(qcfg)
        self.qcfg = self.rules.base
        self.groups = group if isinstance(group, MeshComms) else None
        if self.groups is None and mesh is not None:
            self.groups = mesh_comms(as_comm(group), mesh)
        self.comm = self.groups.data if self.groups is not None \
            else as_comm(group)
        self.tp = bundle.tp
        if self.tp is not None and (self.groups is None or
                                    self.groups.model.world != self.tp.world):
            raise ValueError("a tensor-parallel bundle needs the (D, t) mesh "
                             "whose model group it was built with (mesh=)")
        self.mesh = None if self.comm is None else Mesh(
            (self.comm.world, 1), ("data", "model"))
        self.zero_shard = zero_shard and self.comm is not None
        self.zero2 = self.zero_shard if zero2 is None else zero2
        compress = self.qcfg.compress_dp_grads and self.comm is not None
        if zero2:
            require_zero2(self.comm is not None, zero_shard,
                          self.qcfg.compress_dp_grads)
        self._compress = compress
        self.bundle, self.tcfg = bundle, tcfg
        self.param_dtype = param_dtype
        self.cell = cell or ShapeCell("train", tcfg.seq_len,
                                      tcfg.global_batch, "train")
        self.fault_hook = fault_hook
        self.stragglers = StragglerMonitor()
        self._accum = accum
        if self.comm is not None and \
                tcfg.global_batch % (self.comm.world * accum):
            raise ValueError(
                f"global batch {tcfg.global_batch} does not split into "
                f"{self.comm.world} ranks of {accum} microbatches each")
        self._rank_overrides: Dict[str, int] = {}
        self._build_execution()
        self.controller = adaptive.SubspaceController(self._base_specs,
                                                      self.rules)
        self.mgr = None
        if tcfg.checkpoint_dir:
            self.mgr = ckpt_lib.CheckpointManager(
                tcfg.checkpoint_dir, max_to_keep=tcfg.keep_checkpoints,
                async_save=tcfg.async_checkpoint)
        # a fresh state is cut leaf by leaf as it is drawn
        self.state = self._shard(state) if state is not None \
            else self._zero_shard(step_lib.init_state(
                bundle, self.rules, tcfg.seed, param_dtype,
                specs=self.specs, cut=self._cut))
        self.uniforms = uniforms or step_lib.generator_uniforms(
            tcfg.seed + 17, bundle.device)
        self.omegas = omegas or step_lib.generator_normals(
            tcfg.seed + 17, bundle.device)
        # the default streams capture no ``self``: a reference cycle would
        # keep a dropped trainer's state on the device until the collector
        # runs
        cell, seed = self.cell, tcfg.seed
        self.batches = batches or (lambda s: batch_for_bundle(
            bundle, cell, s, seed))
        self.rows = (0, tcfg.global_batch)
        if self.comm is not None:
            n = tcfg.global_batch // self.comm.world
            self.rows = (self.comm.rank * n, (self.comm.rank + 1) * n)
        self.eval_batches = eval_batches or (lambda s: batch_for_bundle(
            bundle, cell, s, seed + 1))
        self.start_step = 0
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    def _build_execution(self):
        """(Re)derive the specs under the current rank overrides and the
        step around them: at construction, when a restore brings a shrunk
        checkpoint's overrides, and after each rank migration."""
        self._base_specs = qgalore.leaf_specs(
            step_lib.abstract_params(self.bundle, self.rules,
                                     self.param_dtype), self.rules)
        if self.tp is not None:
            self._base_specs = tp_lib.plan_specs(
                self._base_specs, self.tp.world, self.bundle.cfg,
                self.qcfg.quant_block)
        self.specs = qgalore.apply_rank_overrides(self._base_specs,
                                                  self._rank_overrides)
        # this rank's: its tensor-parallel slices and its experts
        self.local_specs = tp_lib.local_specs(self.specs)
        if self.bundle.ep is not None:
            self.local_specs = tp_lib.expert_specs(self.local_specs,
                                                   self.bundle.ep.world)
        self.zero = None
        zero2_dims = None
        if self.zero_shard:
            self.zero = ZeroPartition(self.local_specs, self.rules,
                                      self.mesh, self.comm)
            if self.zero2 and self._compress:
                zero2_dims = self.zero.zero2_dims()
            elif self.zero2:
                log.info("zero2 inactive: compress_dp_grads is off (the "
                         "reduce-scatter lives in the compressed "
                         "data-parallel step); pass --compress / "
                         "compress_dp_grads=True to enable it")
        self._step = step_lib.build_train_step(
            self.bundle, self.rules, self.tcfg, self.local_specs,
            self._accum, group=self.groups or self.comm,
            zero2_dims=zero2_dims, zero=self.zero)

    def _cut(self, i: int, x):
        """This rank's part of leaf ``i``'s weight, or of its ``(moments,
        P)`` pair: its tensor-parallel slice, then its experts."""
        spec, pair = self.specs[i], type(x) is tuple
        if self.tp is not None:
            x = tp_lib.shard_opt_leaf(spec, *x, self.tp.rank) if pair \
                else tp_lib.shard_leaf(x, spec, self.tp.rank)
        ep = self.bundle.ep
        if ep is not None:
            x = tuple(tp_lib.expert_cut(spec, y, ep.rank, ep.world)
                      for y in x) if pair \
                else tp_lib.expert_cut(spec, x, ep.rank, ep.world)
        return x

    def _zero_shard(self, state: step_lib.TrainState
                    ) -> step_lib.TrainState:
        if self.zero is None:
            return state
        return step_lib.TrainState(state.params, self.zero.shard(state.opt))

    def _shard(self, state: step_lib.TrainState, device=None
               ) -> step_lib.TrainState:
        """This rank's part of a whole state, leaf by leaf (:meth:`_cut`,
        each part then moved to ``device`` where given), and its ZeRO
        slices."""
        flat = qgalore.flatten(state.params)
        params, inner, proj = [], [], []
        for i, (_, leaf) in enumerate(flat):
            params.append(_to(self._cut(i, leaf), device))
            st, P = self._cut(i, (state.opt.inner[i], state.opt.proj[i]))
            inner.append(_to(st, device))
            proj.append(_to(P, device))
        return self._zero_shard(step_lib.TrainState(
            qgalore.unflatten([k for k, _ in flat], params),
            qgalore.QGaLoreState(inner, proj, state.opt.count)))

    def _adaptive_rank_enabled(self) -> bool:
        return self.qcfg.adaptive_rank or any(
            g.adaptive_rank for g in self.rules.groups)

    def maybe_restore(self) -> int:
        """Adopt the latest checkpoint (one this trainer, another or the
        JAX package's ``Trainer`` wrote); returns the step to run next."""
        if self.mgr is None or self.mgr.latest_step() is None:
            return 0
        # the rules first, from the meta alone: a mismatch fails with its
        # own message, not a shape error from the arrays
        meta = self.mgr.read_meta()
        ckpt_lib.check_rules_compat(
            meta, self.rules.fingerprint(),
            group_assignment(self._base_specs),
            adaptive_rank=self._adaptive_rank_enabled())
        overrides = {str(k): int(v)
                     for k, v in (meta.get("rank_overrides") or {}).items()}
        if overrides != self._rank_overrides:
            self._rank_overrides = overrides
            self._build_execution()
            self.controller.update_specs(self.specs)
        template = step_lib.abstract_state(self.bundle, self.rules,
                                           self.param_dtype, self.specs)
        self.state = None                 # free the old state first
        # on the host: the device takes this rank's part of each leaf
        state, meta = self.mgr.restore(None, template, "cpu")
        self.state = self._shard(state, self.bundle.device)
        del state
        if meta.get("controller"):
            self.controller.from_json(meta["controller"])
        self.start_step = int(meta["step"]) + 1
        log.info("restored checkpoint at step %d", meta["step"])
        return self.start_step

    def whole_state(self) -> step_lib.TrainState:
        """The whole state: the optimizer's ZeRO slices, the experts and
        the tensor-parallel slices gathered (every rank takes part)."""
        state = self.state
        if self.zero is not None:
            state = step_lib.TrainState(state.params,
                                        self.zero.gather_state(state.opt))
        if self.bundle.ep is not None:
            state = tp_lib.gather_experts(state, self.specs, self.bundle.ep)
        if self.tp is not None:
            spec_tp = tp_lib.local_specs(self.specs)
            state = step_lib.TrainState(
                tp_lib.gather_params(state.params, spec_tp, self.tp),
                tp_lib.gather_opt(state.opt, spec_tp, self.tp))
        return state

    def save(self, step: int):
        """Rank 0 writes the whole state; a data-parallel save returns on
        every rank once the checkpoint is published."""
        if self.mgr is None:
            return
        state = self.whole_state()
        world = self.groups.world if self.groups is not None else self.comm
        if world is None or world.rank == 0:
            self.mgr.save(step, state,
                          {"controller": self.controller.to_json(),
                           "rules_fingerprint": self.rules.fingerprint(),
                           "groups": group_assignment(self._base_specs),
                           "rank_overrides": self.controller.current_ranks(),
                           "mesh": None if self.mesh is None
                           else {"data": self.comm.world,
                                 "model": 1 if self.tp is None
                                 else self.tp.world}})
        if world is not None:
            self.mgr.wait()
            world.barrier()

    def opt_state_bytes(self):
        """``(whole, held)``: the bytes of the whole optimizer state and of
        what this rank holds (its ZeRO slices, or everything)."""
        held = state_nbytes(self.state.opt)
        if self.zero is None and self.tp is None and self.bundle.ep is None:
            return held, held
        whole = state_nbytes(qgalore.state_template(self.specs, self.rules))
        return whole, held

    # ------------------------------------------------------------------
    def _run_one(self, step: int) -> dict:
        if self.fault_hook is not None:
            self.fault_hook(step)             # may raise (simulated failure)
        masks = self.controller.masks_for_step(step) \
            if self.controller.units else {}
        if masks:
            # every GaLore leaf takes the refresh path (False where not due)
            masks = {i: masks.get(i, np.zeros((s.nbatch,), bool))
                     for i, s in enumerate(self.specs) if s.galore}
        batch = self.batches(step)
        if self.comm is not None:
            lo, hi = self.rows
            batch = {k: v[lo:hi] for k, v in batch.items()}
        self.state, metrics, opt_metrics = self._step(
            self.state, batch,
            optimizers.lr_at(step, self.tcfg), step, self.uniforms, masks,
            self.omegas)
        if masks:
            self.controller.observe(step, masks, opt_metrics["sims"],
                                    opt_metrics["ratios"])
            decisions = self.controller.take_rank_decisions()
            if decisions:
                self._migrate_ranks(step, decisions)
        return {k: float(v) for k, v in metrics.items()
                if np.ndim(v.detach().cpu() if torch.is_tensor(v) else v)
                == 0}

    def _migrate_ranks(self, step: int, decisions):
        """Apply the controller's shrink decisions: truncate each leaf's
        low-rank state (8-bit moments, INT4 P; deterministic), then swap in
        the rank-overridden specs and rebuild the step."""
        whole = self.whole_state()
        inner, proj = list(whole.opt.inner), list(whole.opt.proj)
        for idx, old, new in decisions:
            spec = self.specs[idx]
            inner[idx], proj[idx] = qgalore.migrate_rank_state(
                inner[idx], proj[idx], spec, new, self.rules)
            self._rank_overrides[spec.path] = new
            log.info("rank transition at step %d: %s %d -> %d", step,
                     spec.path, old, new)
        whole = step_lib.TrainState(
            whole.params, qgalore.QGaLoreState(inner, proj, whole.opt.count))
        self.state = None
        self._build_execution()
        self.controller.update_specs(self.specs)
        self.state = self._shard(whole)   # re-split under the shrunk shapes

    def run(self, steps: Optional[int] = None, max_failures: int = 3
            ) -> List[Dict[str, float]]:
        """Steps ``start_step .. steps - 1``; a failed step restores the
        last checkpoint and goes on from there, at most ``max_failures``
        times. With a checkpoint directory the last step is saved at the
        end."""
        steps = steps if steps is not None else self.tcfg.steps
        failures = 0
        step = self.start_step
        while step < steps:
            t0 = time.monotonic()
            try:
                row = self._run_one(step)
            except Exception as e:   # noqa: BLE001 — fault-tolerance path
                failures += 1
                log.warning("step %d failed (%s); recovering (%d/%d)",
                            step, e, failures, max_failures)
                if failures > max_failures:
                    raise
                if self.mgr is not None and \
                        self.mgr.latest_step() is not None:
                    step = self.maybe_restore()
                continue
            dt = time.monotonic() - t0
            self.stragglers.observe(step, dt)
            row["step"] = step
            row["dt"] = dt
            self.history.append(row)
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, row["loss"], dt)
            if (self.tcfg.checkpoint_every
                    and step % self.tcfg.checkpoint_every == 0
                    and step > 0):
                self.save(step)
            step += 1
        self.start_step = max(self.start_step, steps)
        if self.mgr is not None:
            self.save(steps - 1)
            self.mgr.wait()
        return self.history

    # ------------------------------------------------------------------
    @torch.no_grad()
    def eval_loss(self, n_batches: int = 4, offset: int = 10_000) -> float:
        """Held-out loss on batches the training never sees."""
        losses = [float(base.loss_fn(self.bundle, self.state.params,
                                     self.eval_batches(offset + i))[0])
                  for i in range(n_batches)]
        return float(np.mean(losses))
