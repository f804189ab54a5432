"""Lazy layer-wise subspace exploration (paper §3.2): the host-side
controller of ``repro/core/adaptive.py``, without rank adaptation.

Per (leaf, layer) it tracks the SVD interval and the similarity history of
consecutive projections. When the similarity stays at or above
``cos_threshold`` for ``adaptive_k`` consecutive refreshes, the interval
doubles up to ``max_interval``. It is plain Python and numpy: the step
function reads :meth:`SubspaceController.masks_for_step` and hands the
refresh step's similarities back to :meth:`SubspaceController.observe`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.config import QGaLoreConfig
from repro_torch.core.qgalore import LeafSpec


@dataclass
class _Unit:
    """Controller state for one (leaf, layer) projection matrix."""
    interval: int
    next_refresh: int = 0           # step at which the next SVD is due
    streak: int = 0                 # consecutive refreshes above threshold
    sims: List[float] = field(default_factory=list)
    svd_count: int = 0


class SubspaceController:
    """Decides, per training step, which projection matrices to refresh."""

    def __init__(self, specs: List[LeafSpec], cfg: QGaLoreConfig):
        if not isinstance(cfg, QGaLoreConfig):
            raise TypeError("the port takes one QGaLoreConfig; parameter-"
                            "group rules are not ported")
        if cfg.adaptive_rank:
            raise NotImplementedError("adaptive_rank is not ported")
        self.cfg = cfg
        self.specs = specs
        self.units: Dict[int, List[_Unit]] = {
            idx: [_Unit(interval=cfg.update_interval)
                  for _ in range(spec.nbatch)]
            for idx, spec in enumerate(specs) if spec.galore}

    def masks_for_step(self, step: int) -> Dict[int, np.ndarray]:
        """``{leaf_idx: (nbatch,) bool}``; empty ⇒ no refresh this step."""
        masks: Dict[int, np.ndarray] = {}
        for idx, units in self.units.items():
            m = np.array([step >= u.next_refresh for u in units], dtype=bool)
            if m.any():
                masks[idx] = m
        return masks

    def observe(self, step: int, masks: Dict[int, np.ndarray],
                sims: Dict[str, np.ndarray]) -> None:
        """Fold the refresh step's per-layer similarities into the
        intervals."""
        cfg = self.cfg
        for idx, mask in masks.items():
            sim_arr = sims.get(self.specs[idx].path)
            if sim_arr is None:
                continue
            sim_arr = np.asarray(sim_arr).reshape(-1)
            for b, unit in enumerate(self.units[idx]):
                if not mask[b]:
                    continue
                unit.svd_count += 1
                s = float(sim_arr[b])
                if s >= 0:
                    unit.sims.append(s)
                    if cfg.adaptive and s >= cfg.cos_threshold:
                        unit.streak += 1
                        if unit.streak >= cfg.adaptive_k:
                            unit.interval = min(unit.interval * 2,
                                                cfg.max_interval)
                            unit.streak = 0
                    else:
                        unit.streak = 0
                unit.next_refresh = step + unit.interval

    # -- accounting ---------------------------------------------------------
    def total_svd_count(self) -> int:
        return sum(u.svd_count for us in self.units.values() for u in us)

    def baseline_svd_count(self, steps: int) -> int:
        """SVDs a fixed-interval GaLore would have used in ``steps``."""
        if not steps:
            return 0
        t = self.cfg.update_interval
        return sum((1 + (steps - 1) // t) * len(us)
                   for us in self.units.values())

    def interval_summary(self) -> Dict[str, List[int]]:
        return {self.specs[i].path: [u.interval for u in us]
                for i, us in self.units.items()}

    def svd_count_summary(self) -> Dict[str, List[int]]:
        return {self.specs[i].path: [u.svd_count for u in us]
                for i, us in self.units.items()}
