"""Fine-tuning launcher of the port: the paper's Tables 3-4 scenario on
param-group rules (the counterpart of ``repro/launch/finetune.py``).

Freezes the embedding, final norm, head and the first ``--freeze-layers``
transformer layers (the block stack is split into ``seg0_`` / ``seg1_``
segments, so a range of layers is addressable by path), fine-tunes the
rest with Q-GaLore at ``--rank``, and reports the weights' and optimizer's
memory against a QLoRA baseline at the same rank (the INT8 frozen base,
float LoRA adapters and their Adam moments; ``models/lora.py``).

The run checks four contracts before it writes the report, each a
function of this module:

* frozen leaves hold no optimizer state (:func:`check_frozen_stateless`);
* the tuned group's rank and name are in ``leaf_specs``
  (:func:`check_group_ranks`);
* frozen weights come back bit-identical (:func:`frozen_weights`,
  :func:`check_frozen_unchanged`);
* the Q-GaLore memory is at most the QLoRA baseline's
  (:func:`memory_vs_qlora`, :func:`check_memory_leq_qlora`).

    PYTHONPATH=src python -m repro_torch.launch.finetune --smoke \
        --device cpu --out finetune_memory.json
    PYTHONPATH=src python -m repro_torch.launch.finetune --arch llama-60m \
        --steps 200 --rank 128 --freeze-layers 2       # full shapes, card

Without ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
from repro_torch.core import qgalore
from repro_torch.core.optimizers import preset
from repro_torch.core.rules import ParamGroup, ParamRules
from repro_torch.device import resolve_device
from repro_torch.models import lora, model_zoo
from repro_torch.train.trainer import Trainer


def build_finetune_rules(base_qcfg: QGaLoreConfig, rank: int,
                         freeze_early: bool = True) -> ParamRules:
    """The fine-tune rule-set: a frozen base (embedding, final norm, head,
    and the early layers, ``seg0_``, unless ``freeze_early=False``: use
    that for a model built without ``split_layers``, whose one block
    segment is itself ``seg0_``), Q-GaLore at ``rank`` on the other
    blocks."""
    frozen_pat = r"embedding|final_norm|head"
    tune_pat = r"seg\d+_"
    if freeze_early:
        frozen_pat += r"|seg0_"
        tune_pat = r"seg1_"
    return ParamRules(
        base=preset("qgalore", base_qcfg),
        groups=(ParamGroup("frozen_base", pattern=frozen_pat, frozen=True),
                ParamGroup("qgalore_blocks", pattern=tune_pat, rank=rank)))


# ---------------------------------------------------------------------------
# The four contracts
# ---------------------------------------------------------------------------

def check_frozen_stateless(specs: List[qgalore.LeafSpec],
                           opt: qgalore.QGaLoreState) -> List[int]:
    """Contract 1: the frozen leaves hold no optimizer state (no moments,
    no projection). Returns their flat indices; raises if there are none."""
    frozen = [i for i, s in enumerate(specs) if s.frozen]
    if not frozen:
        raise AssertionError("the rule-set froze nothing: a pattern "
                             "mismatch?")
    for i in frozen:
        if opt.inner[i] is not None or opt.proj[i] is not None:
            raise AssertionError(f"frozen leaf {specs[i].path} holds "
                                 "optimizer state")
    return frozen


def check_group_ranks(specs: List[qgalore.LeafSpec], rank: int) -> None:
    """Contract 2: every GaLore leaf is in ``qgalore_blocks`` at
    ``min(rank, min(m, n))``."""
    galore = [s for s in specs if s.galore]
    if not galore:
        raise AssertionError("no leaf got Q-GaLore treatment")
    for s in galore:
        want = min(rank, min(s.mat_shape))
        if s.rank != want or s.group != "qgalore_blocks":
            raise AssertionError(f"{s.path}: rank {s.rank} in group "
                                 f"{s.group!r}, want {want} in "
                                 "'qgalore_blocks'")


def _tensors(leaf) -> List[torch.Tensor]:
    if isinstance(leaf, qgalore.QTensor):
        return [t for t in (leaf.q, leaf.scale, leaf.zero) if t is not None]
    return [leaf]


def frozen_weights(params, specs: List[qgalore.LeafSpec]
                   ) -> List[torch.Tensor]:
    """Host copies of every tensor of the frozen leaves (codes, scales,
    zero points), in flat order."""
    flat = [l for _, l in qgalore.flatten(params)]
    return [t.to("cpu", copy=True) for i, s in enumerate(specs) if s.frozen
            for t in _tensors(flat[i])]


def check_frozen_unchanged(before: List[torch.Tensor], params,
                           specs: List[qgalore.LeafSpec]) -> None:
    """Contract 3: the frozen weights are bit-identical to ``before``."""
    after = frozen_weights(params, specs)
    if len(after) != len(before):
        raise AssertionError("the frozen leaves changed in number")
    for i, (a, b) in enumerate(zip(before, after)):
        if a.shape != b.shape or not torch.equal(a, b):
            raise AssertionError(f"frozen tensor {i} changed in training")


def memory_vs_qlora(params, rules, rank: int,
                    specs: Optional[List[qgalore.LeafSpec]] = None
                    ) -> Dict[str, Dict[str, float]]:
    """Q-GaLore's weights and optimizer state (the group-aware
    ``memory_report``) against QLoRA at the same rank, both under
    ``memory_report``'s conventions: the QLoRA side is ``memory_report``
    of the adapter tree under the ``full`` recipe (the adapters and their
    Adam moments) plus the same INT8 base. The adapters are drawn from a
    generator seeded 0 on the weights' device."""
    rep = qgalore.memory_report(params, rules, specs=specs)
    dev = qgalore.leaf_device(qgalore.flatten(params)[0][1])
    adapters = lora.init_adapters(
        params, rank, torch.Generator(device=dev).manual_seed(0))
    adapter_gb = qgalore.memory_report(adapters, preset("full"))["total_gb"]
    del adapters
    return {"qgalore": {"weights_gb": rep["weights_gb"],
                        "optimizer_gb": rep["optimizer_gb"],
                        "total_gb": rep["total_gb"]},
            "qlora": {"weights_gb": rep["weights_gb"],
                      "adapter_plus_opt_gb": adapter_gb,
                      "total_gb": rep["weights_gb"] + adapter_gb}}


def check_memory_leq_qlora(mem: Dict[str, Dict[str, float]],
                           rank: int) -> None:
    """Contract 4: the Q-GaLore total is at most the QLoRA baseline's."""
    if not mem["qgalore"]["total_gb"] <= mem["qlora"]["total_gb"]:
        raise AssertionError(
            f"Q-GaLore fine-tune memory {mem['qgalore']['total_gb']:.6f} GB "
            f"exceeds the QLoRA baseline {mem['qlora']['total_gb']:.6f} GB "
            f"at rank {rank}")


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def run(arch: str = "llama-60m", smoke: bool = True, steps: int = 8,
        rank: int = 8, freeze_layers: int = 1, lr: float = 1e-3,
        seq: int = 32, batch: int = 4, out: str = "",
        device=None) -> dict:
    """Fine-tune ``arch`` for ``steps`` steps under the fine-tune rules,
    check the four contracts, and return (and with ``out``, write) the
    report. ``device``: default ``cuda``, which must be present."""
    dev = resolve_device(device)
    dtype = torch.float32 if smoke else torch.bfloat16
    bundle = model_zoo.build_arch(arch, smoke=smoke, device=dev, dtype=dtype,
                                  split_layers=freeze_layers)
    rules = build_finetune_rules(
        QGaLoreConfig(rank=rank, min_dim=32 if smoke else 128,
                      update_interval=max(steps // 4, 2)), rank,
        freeze_early=freeze_layers > 0)
    tcfg = TrainConfig(global_batch=batch, seq_len=seq, steps=steps,
                       learning_rate=lr, warmup_steps=max(steps // 10, 1),
                       log_every=0)
    trainer = Trainer(bundle, tcfg, rules,
                      cell=ShapeCell("finetune", seq, batch, "train"),
                      param_dtype=dtype)
    specs = trainer.specs
    frozen = check_frozen_stateless(specs, trainer.state.opt)
    check_group_ranks(specs, rank)
    before = frozen_weights(trainer.state.params, specs)
    losses = [h["loss"] for h in trainer.run()]
    if not np.isfinite(losses).all():
        raise AssertionError(f"fine-tune diverged: losses {losses}")
    check_frozen_unchanged(before, trainer.state.params, specs)
    mem = memory_vs_qlora(trainer.state.params, rules, rank, specs=specs)
    report = {
        "arch": arch, "smoke": smoke, "steps": steps, "rank": rank,
        "freeze_layers": freeze_layers,
        "groups": {g: sum(1 for s in specs if s.group == g)
                   for g in sorted({s.group for s in specs})},
        "frozen_leaves": len(frozen),
        "tuned_leaves": len(specs) - len(frozen),
        "final_loss": float(np.mean(losses[-3:])),
        "first_loss": float(losses[0]),
        **mem,
        "qgalore_leq_qlora": bool(mem["qgalore"]["total_gb"]
                                  <= mem["qlora"]["total_gb"]),
        "svd_used": trainer.controller.total_svd_count(),
    }
    check_memory_leq_qlora(mem, rank)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.finetune",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--freeze-layers", type=int, default=1,
                    help="early layers to freeze (they become seg0_)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--out", default="finetune_memory.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be "
                         "present); cpu runs the plain versions")
    args = ap.parse_args(argv)
    report = run(arch=args.arch, smoke=args.smoke, steps=args.steps,
                 rank=args.rank, freeze_layers=args.freeze_layers,
                 lr=args.lr, seq=args.seq, batch=args.batch, out=args.out,
                 device=args.device)
    print(json.dumps(report, indent=2, sort_keys=True))
    print(f"\nQ-GaLore fine-tune total "
          f"{report['qgalore']['total_gb'] * 1024:.2f} MiB vs QLoRA "
          f"{report['qlora']['total_gb'] * 1024:.2f} MiB at rank "
          f"{report['rank']} -> qgalore_leq_qlora="
          f"{report['qgalore_leq_qlora']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
