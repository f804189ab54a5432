"""The roofline on the NVIDIA H100: the counterpart of
``repro/analysis/roofline.py`` (TPU v5e peaks there), for one card.

    compute    = cell FLOPs  / peak FLOP/s of the work's type
    memory     = cell bytes  / HBM B/s
    collective = 0 on one card

``PEAKS`` are the dense rates of NVIDIA's H100 SXM data sheet, by work
type, and the HBM rate. :func:`kernel_bound` is a kernel's least time from
its bytes and FLOPs; :class:`Roofline` is a whole step's, built from
``analysis.analytic`` and set against a measured time (``mfu``,
``share``). :func:`from_artifact`, :func:`load_artifacts` and :func:`table`
read the dry run's artifacts (``launch/dryrun.py``) a chip, their
collective term at the card's NVLink rate (:data:`NVLINK_BW`).
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.config import ModelConfig, ShapeCell

# NVIDIA H100 SXM, dense (no sparsity): FLOP/s by work type; B/s of HBM3
PEAKS: Dict[str, float] = {
    "bf16": 989e12, "fp16": 989e12, "int8": 1979e12, "tf32": 495e12,
    "f32": 67e12, "hbm": 3.35e12,
}
CARDS: Dict[str, Dict[str, float]] = {"NVIDIA H100 80GB HBM3": PEAKS}
# NVIDIA H100 SXM: NVLink 900 GB/s a card, both directions together; a
# collective's bytes a rank leave at one direction's half
NVLINK_BW = 450e9


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of the card ``torch.cuda.get_device_name`` names; a card
    without a table raises (no default)."""
    try:
        return dict(CARDS[device_name])
    except KeyError:
        raise ValueError(f"no peak rates for {device_name!r}; known: "
                         f"{sorted(CARDS)}") from None


def kernel_bound(flops: float, nbytes: float, peak: str = "bf16",
                 rates: Dict[str, float] = PEAKS) -> Tuple[float, str]:
    """Least time (ms) of work that moves ``nbytes`` through HBM and does
    ``flops`` at the ``peak`` type's rate, and what bounds it: ``"bytes"``
    or ``"operations"``."""
    t_bytes = nbytes / rates["hbm"]
    t_ops = flops / rates[peak] if flops else 0.0
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@dataclass(frozen=True)
class Roofline:
    """One step's roofline against its measured time (seconds)."""
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    measured_s: float
    flops: float = 0.0          # the step's FLOPs (analytic.cell_flops)
    nbytes: float = 0.0         # its HBM bytes (analytic.cell_bytes)
    peak_flops: float = PEAKS["bf16"]

    @classmethod
    def for_step(cls, cfg: ModelConfig, cell: ShapeCell, measured_s: float,
                 *, rank: int = 128, peaks: Dict[str, float] = PEAKS,
                 collective_s: float = 0.0) -> "Roofline":
        """The step of ``cell`` at GaLore rank ``rank``, its compute at the
        bf16 rate, measured at ``measured_s``."""
        from repro_torch.analysis import analytic
        fl = analytic.cell_flops(cfg, cell, rank)
        nb = analytic.cell_bytes(cfg, cell, rank=rank)
        return cls(compute_s=fl / peaks["bf16"], memory_s=nb / peaks["hbm"],
                   collective_s=collective_s,
                   model_flops=analytic.model_flops(cfg, cell),
                   measured_s=measured_s, flops=fl, nbytes=nb,
                   peak_flops=peaks["bf16"])

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOPs over the step's FLOPs: < 1 is recompute and
        overhead."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """The model-FLOPs utilization the roofline allows: useful FLOPs
        over (bf16 peak × bound time)."""
        if self.bound_s == 0:
            return 0.0
        return self.model_flops / (self.peak_flops * self.bound_s)

    @property
    def mfu(self) -> float:
        """Model FLOPs over (bf16 peak × measured time); 0 unmeasured (a
        dry run's)."""
        if not self.measured_s:
            return 0.0
        return self.model_flops / (self.peak_flops * self.measured_s)

    @property
    def share(self) -> float:
        """The bound's share of the measured time; 0 unmeasured."""
        if not self.measured_s:
            return 0.0
        return self.bound_s / self.measured_s

    def row(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s,
                "measured_s": self.measured_s, "bound_s": self.bound_s,
                "dominant": self.dominant,
                "useful_flops_ratio": self.useful_flops_ratio,
                "mfu_bound": self.mfu_bound, "mfu": self.mfu,
                "share": self.share, "flops": self.flops,
                "nbytes": self.nbytes, "model_flops": self.model_flops}


def serving_mfu(cfg: ModelConfig, tokens_per_s: float,
                peaks: Dict[str, float] = PEAKS) -> float:
    """A serving run's MFU: tokens/s × the model FLOPs of one token over
    the bf16 peak."""
    from repro_torch.analysis import analytic
    one = analytic.model_flops(cfg, ShapeCell("token", 1, 1, "decode"))
    return tokens_per_s * one / peaks["bf16"]


# ---------------------------------------------------------------------------
# The dry run's artifacts
# ---------------------------------------------------------------------------

def from_artifact(art: Dict, peaks: Dict[str, float] = PEAKS
                  ) -> Optional[Roofline]:
    """A chip's roofline from a dry-run artifact (``launch/dryrun.py``):
    its analytic FLOPs at the bf16 rate, its analytic bytes at the HBM
    rate and its collective bytes at :data:`NVLINK_BW`; the model FLOPs a
    chip; nothing measured. None for a failed cell."""
    if not art.get("ok"):
        return None
    cost = art.get("cost_analysis") or {}
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    coll = float(((art.get("collectives") or {}).get("total") or {})
                 .get("bytes") or 0.0)
    chips = int(art.get("chips") or 1)
    return Roofline(compute_s=flops / peaks["bf16"],
                    memory_s=nbytes / peaks["hbm"],
                    collective_s=coll / NVLINK_BW,
                    model_flops=float(art.get("model_flops", 0.0)) / chips,
                    measured_s=0.0, flops=flops, nbytes=nbytes,
                    peak_flops=peaks["bf16"])


def load_artifacts(directory: str) -> Dict[str, Dict]:
    """``{name: artifact}`` of the ``*.json`` in ``directory``, by name."""
    out = {}
    if not os.path.isdir(directory):
        return out
    for name in sorted(os.listdir(directory)):
        if name.endswith(".json"):
            with open(os.path.join(directory, name)) as f:
                out[name[:-5]] = json.load(f)
    return out


def table(directory: str) -> str:
    """The artifacts' rooflines a chip, as a markdown table."""
    lines = [
        "| arch × cell | compute (s) | memory (s) | collective (s) | "
        "dominant | useful FLOPs ratio | MFU bound |",
        "|---|---|---|---|---|---|---|",
    ]
    for key, art in load_artifacts(directory).items():
        r = from_artifact(art)
        if r is None:
            lines.append(f"| {key} | FAILED: "
                         f"{str(art.get('error', '?'))[-60:]} | | | | | |")
            continue
        lines.append(
            f"| {key} | {r.compute_s:.4f} | {r.memory_s:.4f} | "
            f"{r.collective_s:.4f} | **{r.dominant}** | "
            f"{r.useful_flops_ratio:.2f} | {r.mfu_bound:.1%} |")
    return "\n".join(lines)
