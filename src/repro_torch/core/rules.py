"""Param-group rules: ordered, path-pattern overrides of the Q-GaLore
recipe (a copy of ``repro/core/rules.py``; the port imports nothing from
``repro``).

* :class:`ParamGroup` is a named override of the recipe for the leaves
  whose path matches its regex ``pattern`` (``re.search`` against both the
  key-string form ``['seg0_dense']['attn']['wq']`` and the normalized
  ``/seg0_dense/attn/wq`` form). Overridable knobs: rank, interval, scale,
  bit widths, the controller's parameters, weight decay, stochastic
  rounding, a learning-rate multiplier ``lr_scale``, and ``frozen=True``,
  which drops the leaf from the optimizer (no state, no update).
* :class:`ParamRules` is an ordered tuple of groups over a base config;
  the first group whose pattern matches supplies the overrides, and
  unmatched leaves fall through to the base (the implicit default group).

Every optimizer entry point of the port (``qgalore.leaf_specs``, ``init``,
``apply_updates``, ``memory_report``, ``SubspaceController``, ``Trainer``)
takes a plain ``QGaLoreConfig`` or a ``ParamRules``; :func:`as_rules` is
the one normalization point, and a plain config is exactly
``ParamRules(base=cfg)``. :meth:`ParamRules.fingerprint` returns the
reference's string for the same rules: checkpoints of either package
carry it.
"""
from __future__ import annotations

import hashlib
import json
import re
from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.config import QGaLoreConfig, replace

# QGaLoreConfig fields a group may override (None on the group = inherit).
OVERRIDE_FIELDS: Tuple[str, ...] = (
    "enabled", "rank", "scale", "update_interval",
    "adaptive", "cos_threshold", "adaptive_k", "max_interval",
    "proj_bits", "weight_bits", "adam_bits", "stochastic_rounding",
    "weight_decay", "subspace_method", "subspace_iters",
    "min_dim", "galore_embeddings",
    "adaptive_rank", "rank_ladder", "explained_ratio_threshold",
    "rank_patience", "min_rank",
)


@dataclass(frozen=True)
class ParamGroup:
    """One named override rule. ``pattern`` is a regex matched with
    ``re.search`` against the leaf path; an empty pattern matches every
    leaf (useful as an explicit catch-all last group)."""
    name: str
    pattern: str = ""
    frozen: bool = False
    lr_scale: float = 1.0
    # --- QGaLoreConfig overrides (None = inherit from the base config) ---
    enabled: Optional[bool] = None
    rank: Optional[int] = None
    scale: Optional[float] = None
    update_interval: Optional[int] = None
    adaptive: Optional[bool] = None
    cos_threshold: Optional[float] = None
    adaptive_k: Optional[int] = None
    max_interval: Optional[int] = None
    proj_bits: Optional[int] = None
    weight_bits: Optional[int] = None
    adam_bits: Optional[int] = None
    stochastic_rounding: Optional[bool] = None
    weight_decay: Optional[float] = None
    subspace_method: Optional[str] = None
    subspace_iters: Optional[int] = None
    min_dim: Optional[int] = None
    galore_embeddings: Optional[bool] = None
    adaptive_rank: Optional[bool] = None
    rank_ladder: Optional[Tuple[int, ...]] = None
    explained_ratio_threshold: Optional[float] = None
    rank_patience: Optional[int] = None
    min_rank: Optional[int] = None

    def matches(self, path: str) -> bool:
        if not self.pattern:
            return True
        return re.search(self.pattern, path) is not None \
            or re.search(self.pattern, normalize_path(path)) is not None

    def overrides(self) -> dict:
        out = {}
        for f in OVERRIDE_FIELDS:
            v = getattr(self, f)
            if v is not None:
                out[f] = v
        return out

    def apply_to(self, base: QGaLoreConfig) -> QGaLoreConfig:
        ov = self.overrides()
        return replace(base, **ov) if ov else base


# The implicit catch-all: no overrides, trainable, unit lr.
DEFAULT_GROUP = ParamGroup(name="default")


@dataclass(frozen=True)
class ParamRules:
    """Ordered first-match-wins param-group rules over a base recipe."""
    base: QGaLoreConfig = QGaLoreConfig()
    groups: Tuple[ParamGroup, ...] = ()

    def resolve(self, path: str) -> ParamGroup:
        """The first group whose pattern matches ``path`` (the implicit
        default group when none does)."""
        for g in self.groups:
            if g.matches(path):
                return g
        return DEFAULT_GROUP

    def config_for(self, path: str) -> QGaLoreConfig:
        """The effective per-leaf config: base + first-matching overrides."""
        return self.resolve(path).apply_to(self.base)

    def group_names(self) -> Tuple[str, ...]:
        return tuple(g.name for g in self.groups) + (DEFAULT_GROUP.name,)

    def fingerprint(self) -> str:
        """Stable short hash of the rule-set's STATE-STRUCTURAL content —
        persisted in checkpoint metadata so a restore under different
        rules fails loudly instead of silently mis-grouping optimizer
        state. Only fields that change which state arrays exist or their
        shapes/dtypes participate (group membership, frozen, galore
        eligibility, ranks, bit widths, quant block); recipe knobs that
        leave the state layout alone (lr_scale, scale, intervals, adaptive
        thresholds, SR, weight decay) and pure execution-strategy flags
        (fused_update, batch_leaves, compress_dp_grads, dist_refresh) do
        NOT — toggling those must never refuse a resume."""
        blob = json.dumps(_structural_describe(self), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def normalize_path(path: str) -> str:
    """``['seg0_dense']['attn']['wq']`` → ``/seg0_dense/attn/wq``."""
    s = re.sub(r"\['([^']*)'\]", r"/\1", path)
    s = s.replace("][", "/").replace("[", "/").replace("]", "")
    return s if s.startswith("/") else "/" + s


def as_rules(cfg_or_rules) -> ParamRules:
    """Normalize: a plain ``QGaLoreConfig`` becomes single-default-group
    rules (bit-identical pipeline); ``ParamRules`` passes through."""
    if isinstance(cfg_or_rules, ParamRules):
        return cfg_or_rules
    if isinstance(cfg_or_rules, QGaLoreConfig):
        return ParamRules(base=cfg_or_rules)
    raise TypeError(
        f"expected QGaLoreConfig or ParamRules, got {type(cfg_or_rules)}")


# QGaLoreConfig fields that determine the optimizer state's STRUCTURE
# (which leaves hold state, array shapes, QTensor-vs-array dtypes). The
# checkpoint fingerprint covers exactly these — see fingerprint().
STRUCTURAL_FIELDS: Tuple[str, ...] = (
    "enabled", "rank", "min_dim", "galore_embeddings",
    "proj_bits", "weight_bits", "adam_bits", "quant_block",
)


def _structural_describe(rules: ParamRules) -> dict:
    def base_dict(cfg):
        return {f: getattr(cfg, f) for f in STRUCTURAL_FIELDS}

    def group_dict(g: ParamGroup):
        d = {f: getattr(g, f) for f in STRUCTURAL_FIELDS
             if getattr(g, f, None) is not None}
        d.update(name=g.name, pattern=g.pattern, frozen=g.frozen)
        return d

    return {
        "base": base_dict(rules.base),
        "groups": [group_dict(g) for g in rules.groups],
    }


def group_assignment(specs) -> dict:
    """{leaf path: group name} for a spec list — the per-leaf group map
    persisted as checkpoint metadata (see ``Trainer.save``)."""
    return {s.path: s.group for s in specs}
