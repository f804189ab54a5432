"""The training loop: adaptive subspace control, rank adaptation,
checkpoint and resume, fault recovery, straggler detection (the
counterpart of ``repro/train/trainer.py``, single device).

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
from repro_torch.core.rules import as_rules, group_assignment
from repro_torch.data.synthetic import batch_for_bundle
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


class Trainer:
    def __init__(self, bundle: ModelBundle, tcfg: TrainConfig, qcfg, *,
                 cell: Optional[ShapeCell] = None,
                 param_dtype=torch.float32, accum: int = 1,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 state: Optional[step_lib.TrainState] = None,
                 uniforms: Optional[step_lib.UniformSource] = None,
                 omegas: Optional[step_lib.NormalSource] = None,
                 batches=None, eval_batches=None):
        """``qcfg``: a ``QGaLoreConfig`` or a ``ParamRules``. ``state``: a
        starting TrainState (default: drawn from ``tcfg.seed``);
        ``batches`` / ``eval_batches``: ``step -> batch`` (default: the
        synthetic LM stream of ``cell`` at ``tcfg.seed`` / ``seed + 1``);
        ``fault_hook(step)`` runs before each step and may raise."""
        self.rules = as_rules(qcfg)
        self.qcfg = self.rules.base
        self.bundle, self.tcfg = bundle, tcfg
        self.param_dtype = param_dtype
        self.cell = cell or ShapeCell("train", tcfg.seq_len,
                                      tcfg.global_batch, "train")
        self.fault_hook = fault_hook
        self.stragglers = StragglerMonitor()
        self._accum = accum
        self._rank_overrides: Dict[str, int] = {}
        self._build_execution()
        self.controller = adaptive.SubspaceController(self._base_specs,
                                                      self.rules)
        self.mgr = None
        if tcfg.checkpoint_dir:
            self.mgr = ckpt_lib.CheckpointManager(
                tcfg.checkpoint_dir, max_to_keep=tcfg.keep_checkpoints,
                async_save=tcfg.async_checkpoint)
        self.state = state or step_lib.init_state(
            bundle, self.rules, tcfg.seed, param_dtype, specs=self.specs)
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
        self.specs = qgalore.apply_rank_overrides(self._base_specs,
                                                  self._rank_overrides)
        self._step = step_lib.build_train_step(
            self.bundle, self.rules, self.tcfg, self.specs, self._accum)

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
        self.state, meta = self.mgr.restore(None, template,
                                            self.bundle.device)
        if meta.get("controller"):
            self.controller.from_json(meta["controller"])
        self.start_step = int(meta["step"]) + 1
        log.info("restored checkpoint at step %d", meta["step"])
        return self.start_step

    def save(self, step: int):
        if self.mgr is None:
            return
        self.mgr.save(step, self.state,
                      {"controller": self.controller.to_json(),
                       "rules_fingerprint": self.rules.fingerprint(),
                       "groups": group_assignment(self._base_specs),
                       "rank_overrides": self.controller.current_ranks(),
                       "mesh": None})

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
        self.state, metrics, opt_metrics = self._step(
            self.state, self.batches(step),
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
        opt = self.state.opt
        inner, proj = list(opt.inner), list(opt.proj)
        for idx, old, new in decisions:
            spec = self.specs[idx]
            inner[idx], proj[idx] = qgalore.migrate_rank_state(
                inner[idx], proj[idx], spec, new, self.rules)
            self._rank_overrides[spec.path] = new
            log.info("rank transition at step %d: %s %d -> %d", step,
                     spec.path, old, new)
        self.state = step_lib.TrainState(
            self.state.params, qgalore.QGaLoreState(inner, proj, opt.count))
        self._build_execution()
        self.controller.update_specs(self.specs)

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
