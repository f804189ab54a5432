"""Lazy layer-wise subspace exploration (paper §3.2) and dynamic rank
adaptation: the host-side controller of ``repro/core/adaptive.py``.

Per (leaf, layer) it tracks the SVD interval and the similarity history of
consecutive projections. When the similarity stays at or above
``cos_threshold`` for ``adaptive_k`` consecutive refreshes, the interval
doubles up to ``max_interval``. Under ``adaptive_rank`` it also reads each
refresh's explained-variance profiles and, once every refreshed layer of a
leaf explains at least ``explained_ratio_threshold`` of its gradient at
the next rung for ``rank_patience`` refreshes, decides a shrink that the
trainer applies (:meth:`SubspaceController.take_rank_decisions`).

Every per-leaf knob comes from the leaf's resolved param group
(``spec.cfg``). It is plain Python and numpy: the step function reads
:meth:`SubspaceController.masks_for_step` and hands the refresh step's
similarities (and ratios) back to :meth:`SubspaceController.observe`. Its
state round-trips through JSON in the reference's format, so either
package's checkpoint restores into the other's controller.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.config import QGaLoreConfig
from repro_torch.core.qgalore import LeafSpec, _eff_cfg
from repro_torch.core.rules import as_rules


@dataclass
class _Unit:
    """Controller state for one (leaf, batch-entry) projection matrix."""
    interval: int
    next_refresh: int = 0           # step at which the next SVD is due
    streak: int = 0                 # consecutive refreshes above threshold
    sims: List[float] = field(default_factory=list)
    svd_count: int = 0


class SubspaceController:
    """Decides, per training step, which projection matrices to refresh.

    Group-aware: every per-leaf policy knob (initial ``update_interval``,
    ``adaptive`` on/off, ``cos_threshold`` / ``adaptive_k`` /
    ``max_interval``) comes from the leaf's resolved param group
    (``spec.cfg``, see ``repro.core.rules``) — an attention group can
    refresh every 100 steps while an MLP group coasts at 400. ``cfg`` may
    be a plain ``QGaLoreConfig`` (single group, pre-rules behavior) or a
    ``ParamRules``."""

    def __init__(self, specs: List[LeafSpec], cfg):
        self.rules = as_rules(cfg)
        self.cfg = self.rules.base
        self.specs = specs
        self.units: Dict[int, List[_Unit]] = {}
        # dynamic rank adaptation (per-LEAF: a stacked leaf's units share
        # one rank because the state arrays are stacked)
        self.ranks: Dict[int, int] = {}
        self.rank_streaks: Dict[int, int] = {}
        self.transitions: List[dict] = []
        self._pending: List[tuple] = []
        for idx, spec in enumerate(specs):
            if spec.galore:
                eff = _eff_cfg(spec, self.rules)
                self.units[idx] = [
                    _Unit(interval=eff.update_interval)
                    for _ in range(spec.nbatch)
                ]
                self.ranks[idx] = spec.rank
                self.rank_streaks[idx] = 0
        self._orig_ranks = dict(self.ranks)

    def _cfg_for(self, idx: int) -> QGaLoreConfig:
        return _eff_cfg(self.specs[idx], self.rules)

    def update_specs(self, specs: List[LeafSpec]) -> None:
        """Swap in rebuilt (rank-overridden) specs after a migration; the
        leaf set and ordering must be unchanged."""
        if [s.path for s in specs] != [s.path for s in self.specs]:
            raise ValueError("update_specs: leaf set changed")
        self.specs = specs

    # -- scheduling ---------------------------------------------------------
    def masks_for_step(self, step: int) -> Dict[int, np.ndarray]:
        """{leaf_idx: (nbatch,) bool} — empty dict ⇒ no refresh this step."""
        masks: Dict[int, np.ndarray] = {}
        for idx, units in self.units.items():
            m = np.array([step >= u.next_refresh for u in units], dtype=bool)
            if m.any():
                masks[idx] = m
        return masks

    def is_refresh_step(self, step: int) -> bool:
        return bool(self.masks_for_step(step))

    # -- feedback -----------------------------------------------------------
    def observe(self, step: int, masks: Dict[int, np.ndarray],
                sims: Dict[str, np.ndarray],
                ratios: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Consume the per-layer similarities (and, under dynamic rank
        adaptation, the explained-variance profiles) returned by the
        refresh step."""
        path_by_idx = {i: s.path for i, s in enumerate(self.specs)}
        for idx, mask in masks.items():
            sim_arr = sims.get(path_by_idx[idx])
            if sim_arr is None:
                continue
            eff = self._cfg_for(idx)
            sim_arr = np.asarray(sim_arr).reshape(-1)
            for b, unit in enumerate(self.units[idx]):
                if not mask[b]:
                    continue
                unit.svd_count += 1
                s = float(sim_arr[b])
                if s >= 0:
                    unit.sims.append(s)
                    if eff.adaptive and s >= eff.cos_threshold:
                        unit.streak += 1
                        if unit.streak >= eff.adaptive_k:
                            unit.interval = min(unit.interval * 2,
                                                eff.max_interval)
                            unit.streak = 0
                    else:
                        unit.streak = 0
                unit.next_refresh = step + unit.interval
            if eff.adaptive_rank and ratios is not None:
                self._observe_rank(step, idx, mask, eff,
                                   ratios.get(path_by_idx[idx]))

    # -- dynamic rank adaptation --------------------------------------------
    def _next_rank(self, idx: int, eff: QGaLoreConfig) -> Optional[int]:
        """The next rung below the leaf's CURRENT rank: the largest ladder
        value strictly below it, or half of it with an empty ladder; None
        once the floor ``min_rank`` would be crossed."""
        cur = self.ranks[idx]
        if eff.rank_ladder:
            below = [r for r in eff.rank_ladder if r < cur]
            target = max(below) if below else None
        else:
            target = cur // 2
        if target is None or target < max(eff.min_rank, 1):
            return None
        return target

    def _observe_rank(self, step: int, idx: int, mask, eff: QGaLoreConfig,
                      ratio_arr) -> None:
        """One refresh observation of a leaf's explained-variance profile:
        the leaf's streak counts consecutive refreshes where EVERY refreshed
        unit already explains >= threshold of its gradient energy at the
        next-smaller rank; ``rank_patience`` such refreshes trigger a
        shrink decision (picked up by the trainer via
        :meth:`take_rank_decisions`).

        ``rank_hysteresis`` opens a dead band below the threshold:
        observations in ``[threshold - band, threshold)`` HOLD the streak
        instead of resetting it, so a ratio that jitters across the
        threshold between refreshes cannot oscillate the streak (and, with
        rank growth, the rank itself) — a shrink still requires
        ``rank_patience`` observations at/above the full threshold, and
        only a clear drop below the band resets progress."""
        if ratio_arr is None:
            return
        target = self._next_rank(idx, eff)
        if target is None:
            return
        ratio_arr = np.asarray(ratio_arr).reshape(-1, self.ranks[idx])
        vals = [float(ratio_arr[b, target - 1])
                for b in range(ratio_arr.shape[0]) if mask[b]]
        vals = [v for v in vals if v >= 0]
        if not vals:
            return
        if min(vals) >= eff.explained_ratio_threshold - eff.rank_hysteresis \
                and min(vals) < eff.explained_ratio_threshold:
            return                      # dead band: hold the streak
        if min(vals) >= eff.explained_ratio_threshold:
            self.rank_streaks[idx] += 1
            if self.rank_streaks[idx] >= eff.rank_patience:
                old = self.ranks[idx]
                self.ranks[idx] = target
                self.rank_streaks[idx] = 0
                self.transitions.append(
                    {"step": int(step), "path": self.specs[idx].path,
                     "old": int(old), "new": int(target)})
                self._pending.append((idx, old, target))
        else:
            self.rank_streaks[idx] = 0

    def take_rank_decisions(self) -> List[tuple]:
        """Drain pending (leaf_idx, old_rank, new_rank) shrink decisions —
        the trainer migrates state and rebuilds execution for each."""
        out, self._pending = self._pending, []
        return out

    def current_ranks(self) -> Dict[str, int]:
        """{leaf path: rank} for leaves shrunk below their configured rank
        — the override map persisted in checkpoint meta and fed to
        ``qgalore.apply_rank_overrides``."""
        return {self.specs[i].path: r for i, r in self.ranks.items()
                if r != self._orig_ranks[i]}

    def rank_transition_summary(self) -> List[dict]:
        """The exact (step, path, old → new) shrink schedule of the run."""
        return [dict(t) for t in self.transitions]

    # -- accounting ---------------------------------------------------------
    def total_svd_count(self) -> int:
        return sum(u.svd_count for us in self.units.values() for u in us)

    def baseline_svd_count(self, steps: int) -> int:
        """SVDs a fixed-interval GaLore would have used in `steps` steps
        (per-group initial intervals honored)."""
        if not steps:
            return 0
        total = 0
        for idx, us in self.units.items():
            t = self._cfg_for(idx).update_interval
            total += (1 + (steps - 1) // t) * len(us)
        return total

    def interval_summary(self) -> Dict[str, List[int]]:
        return {self.specs[i].path: [u.interval for u in us]
                for i, us in self.units.items()}

    def svd_count_summary(self) -> Dict[str, List[int]]:
        """{leaf path: per-unit SVD counts}: the layer-adaptive signature
        of a run."""
        return {self.specs[i].path: [u.svd_count for u in us]
                for i, us in self.units.items()}

    # -- checkpointing ------------------------------------------------------
    def to_json(self) -> str:
        blob = {
            "units": {
                str(i): [
                    {"interval": u.interval,
                     "next_refresh": u.next_refresh,
                     "streak": u.streak, "svd_count": u.svd_count,
                     "sims": u.sims[-16:]}
                    for u in us]
                for i, us in self.units.items()
            },
            "ranks": {str(i): r for i, r in self.ranks.items()},
            "rank_streaks": {str(i): s
                             for i, s in self.rank_streaks.items()},
            "transitions": self.transitions,
        }
        return json.dumps(blob)

    def from_json(self, s: str) -> None:
        """Restore controller state, STRICTLY: the serialized leaf set must
        match this controller's exactly — unknown keys, missing keys, or a
        per-leaf unit-count mismatch mean the checkpoint was written under
        different specs (model/rules drift), and silently dropping entries
        would resume with desynchronized refresh schedules. Accepts the
        pre-rank-adaptation flat format (units only) for old checkpoints."""
        blob = json.loads(s)
        unit_blob = blob["units"] if "units" in blob else blob
        want = {str(i) for i in self.units}
        got = set(unit_blob)
        if got != want:
            raise ValueError(
                "SubspaceController.from_json: serialized leaf set does "
                f"not match the current specs (unknown={sorted(got - want)}"
                f", missing={sorted(want - got)}) — the checkpoint was "
                "written under different model/rules")
        for i_str, dumps in unit_blob.items():
            units = self.units[int(i_str)]
            if len(dumps) != len(units):
                raise ValueError(
                    f"SubspaceController.from_json: leaf {i_str} has "
                    f"{len(dumps)} serialized units, expected "
                    f"{len(units)} (stacked-layer layout changed)")
            for u, d in zip(units, dumps):
                u.interval = d["interval"]
                u.next_refresh = d["next_refresh"]
                u.streak = d["streak"]
                u.svd_count = d["svd_count"]
                u.sims = list(d.get("sims", []))
        if "units" in blob:
            for i_str, r in blob.get("ranks", {}).items():
                if int(i_str) not in self.ranks:
                    raise ValueError(
                        f"SubspaceController.from_json: rank entry for "
                        f"unknown leaf {i_str}")
                self.ranks[int(i_str)] = int(r)
            for i_str, st in blob.get("rank_streaks", {}).items():
                self.rank_streaks[int(i_str)] = int(st)
            self.transitions = [dict(t) for t in blob.get("transitions",
                                                          [])]
