"""Training launcher of the port: any ported ``--arch`` on one device (the
counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --smoke --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \
        --batch 8 --seq 256 --accum 2 --rank 512 --steps 20

Without ``--device`` it runs on the card. The flags of distributed
training (``--mesh``, ``--tp``, ``--devices``, ``--compress``, ``--zero``,
``--zero2``, ``--multihost``) are accepted by name and refused: the port
trains on one device (ROADMAP queue 1 item 5). It closes with the
reference's lines: the final loss and the SVDs used against a fixed
interval's, and under ``--adaptive-rank`` the rank transitions and the
optimizer state's size.
"""
from __future__ import annotations

import argparse
import logging
from typing import List, Optional

DISTRIBUTED_FLAGS = ("mesh", "tp", "devices", "compress", "zero", "zero2",
                     "multihost")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-60m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--rank", type=int, default=128)
    ap.add_argument("--adaptive-rank", action="store_true",
                    help="dynamic per-layer rank adaptation: shrink a "
                         "leaf's rank down the --rank-ladder when its "
                         "explained-variance ratio holds above "
                         "--rank-threshold for --rank-patience refreshes")
    ap.add_argument("--rank-ladder", default="",
                    help="comma-separated shrink rungs, e.g. 64,32 "
                         "(empty = halve)")
    ap.add_argument("--rank-threshold", type=float, default=0.95)
    ap.add_argument("--rank-patience", type=int, default=2)
    ap.add_argument("--min-rank", type=int, default=8)
    ap.add_argument("--optimizer", default="qgalore")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be "
                         "present); cpu runs the plain versions")
    # distributed training: refused (see the module docstring)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--zero", action="store_true")
    ap.add_argument("--zero2", type=int, default=-1, choices=(-1, 0, 1))
    ap.add_argument("--mesh", default="")
    ap.add_argument("--tp", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0)
    ap.add_argument("--multihost", action="store_true")
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    given = [f"--{f}" for f in DISTRIBUTED_FLAGS
             if getattr(args, f) != ap.get_default(f)]
    if given:
        ap.error(f"{', '.join(given)}: distributed training is not ported; "
                 "the port trains on one device (ROADMAP queue 1 item 5)")

    import torch

    from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
    from repro_torch.core import qgalore
    from repro_torch.core.optimizers import preset
    from repro_torch.device import resolve_device
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    bundle = model_zoo.build_arch(args.arch, smoke=args.smoke, device=device,
                                  dtype=dtype)
    ladder = tuple(int(x) for x in args.rank_ladder.split(",") if x)
    qcfg = preset(args.optimizer, QGaLoreConfig(
        rank=args.rank, min_dim=64 if args.smoke else 128,
        adaptive_rank=args.adaptive_rank, rank_ladder=ladder,
        explained_ratio_threshold=args.rank_threshold,
        rank_patience=args.rank_patience, min_rank=args.min_rank))
    tcfg = TrainConfig(global_batch=args.batch, seq_len=args.seq,
                       steps=args.steps, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 20, 1), log_every=10,
                       checkpoint_dir=args.checkpoint_dir,
                       checkpoint_every=args.checkpoint_every)
    cell = ShapeCell("train", args.seq, args.batch, "train")
    # float weights (the baselines) in f32 on a smoke model, else bf16
    trainer = Trainer(bundle, tcfg, qcfg, cell=cell, accum=args.accum,
                      param_dtype=torch.float32 if args.smoke
                      else torch.bfloat16)
    trainer.maybe_restore()
    hist = trainer.run()
    print(f"final loss {hist[-1]['loss']:.4f}; "
          f"SVD used {trainer.controller.total_svd_count()} / "
          f"{trainer.controller.baseline_svd_count(args.steps)} baseline")
    if args.adaptive_rank:
        for t in trainer.controller.rank_transition_summary():
            print(f"rank transition: step {t['step']} {t['path']} "
                  f"{t['old']} -> {t['new']}")
        bytes_now = qgalore.optimizer_state_bytes(
            trainer.state.params, trainer.rules, specs=trainer.specs)
        print(f"optimizer state {bytes_now / 2**20:.2f} MB; "
              f"DP payload {qgalore.dp_payload_bytes(trainer.specs)} B/step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
