"""The training loop (the counterpart of ``repro/train/trainer.py``,
single device, no checkpoints yet).

Each step: the batch at ``(seed, step)``, the learning rate from the
schedule, the controller's refresh masks; a refresh step hands its
per-layer similarities back to the controller. Every stochastic rounding
draws from ``uniforms`` (default :func:`step.generator_uniforms`).
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
from repro_torch.core import adaptive, optimizers, qgalore
from repro_torch.data.synthetic import batch_for_bundle
from repro_torch.models.base import ModelBundle
from repro_torch.train import step as step_lib

log = logging.getLogger("repro_torch.trainer")


class Trainer:
    def __init__(self, bundle: ModelBundle, tcfg: TrainConfig,
                 qcfg: QGaLoreConfig, *, cell: Optional[ShapeCell] = None,
                 param_dtype=torch.float32,
                 state: Optional[step_lib.TrainState] = None,
                 uniforms: Optional[step_lib.UniformSource] = None,
                 batches=None):
        """``state``: a starting TrainState (default: drawn from
        ``tcfg.seed``); ``batches``: ``step -> batch`` (default: the
        synthetic LM stream of ``cell``)."""
        if tcfg.checkpoint_dir:
            raise NotImplementedError("checkpoints are not ported yet")
        self.bundle, self.tcfg, self.qcfg = bundle, tcfg, qcfg
        self.cell = cell or ShapeCell("train", tcfg.seq_len,
                                      tcfg.global_batch, "train")
        self.state = state or step_lib.init_state(bundle, qcfg, tcfg.seed,
                                                  param_dtype)
        self.specs = qgalore.leaf_specs(self.state.params, qcfg)
        self.controller = adaptive.SubspaceController(self.specs, qcfg)
        self.uniforms = uniforms or step_lib.generator_uniforms(
            tcfg.seed + 17, bundle.device)
        self.batches = batches or (lambda s: batch_for_bundle(
            bundle, self.cell, s, tcfg.seed))
        self._step = step_lib.build_train_step(bundle, qcfg, tcfg,
                                               self.specs)
        self.start_step = 0
        self.history: List[Dict[str, float]] = []

    def run_one(self, step: int) -> dict:
        """One step; returns its metrics (scalars on the host)."""
        masks = self.controller.masks_for_step(step)
        if masks:
            # every GaLore leaf takes the refresh path (False where not due)
            masks = {i: masks.get(i, np.zeros((s.nbatch,), bool))
                     for i, s in enumerate(self.specs) if s.galore}
        self.state, metrics, opt_metrics = self._step(
            self.state, self.batches(step),
            optimizers.lr_at(step, self.tcfg), step, self.uniforms, masks)
        if masks:
            self.controller.observe(step, masks, opt_metrics["sims"])
        return {k: float(v) for k, v in metrics.items()
                if np.ndim(v.detach().cpu() if torch.is_tensor(v) else v)
                == 0}

    def run(self, steps: Optional[int] = None) -> List[Dict[str, float]]:
        steps = steps if steps is not None else self.tcfg.steps
        for step in range(self.start_step, steps):
            t0 = time.monotonic()
            row = self.run_one(step)
            row["step"] = step
            row["dt"] = time.monotonic() - t0
            self.history.append(row)
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.2fs)", step, row["loss"],
                         row["dt"])
        self.start_step = steps
        return self.history
