"""Training launcher of the port: any ported ``--arch``, on one device or
data-parallel (the counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --smoke --steps 50 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-1b \
        --batch 8 --seq 256 --accum 2 --rank 512 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --smoke --device cpu --devices 4 --mesh 4x1 --compress --zero
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-60m \
        --device cpu --devices 4 --tp 2 --compress --zero
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch llama-1b --multihost --mesh 8x1 --compress --zero

Without ``--device`` it runs on the card. For the encoder-decoder
(``--arch seamless-m4t-medium``) ``--seq`` is the frames a row; its
decoder takes ``max(seq // 4, 16)`` tokens, as in the JAX package.

Data parallelism: ``--devices N`` starts N ranks itself (processes of its
own, joined through a file store), the CPU emulation of the reference's
N host devices; ``--multihost`` joins the group ``torchrun`` describes
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``), one
card per local rank. ``--mesh DxM`` names the (D, M) mesh (D·M the
world; by default the world's (N, 1)), ``--tp t`` the (N/t, t) one: t
tensor-parallel ranks a data shard (``distributed/tp.py``; the dense GQA
families). ``--compress`` averages the low-rank gradients and refreshes
distributed, ``--zero`` partitions the optimizer state over the data
ranks and ``--zero2`` (default: as ``--zero``) reduce-scatters the
gradients onto it. ``--backend`` names the process group's backend:
``nccl`` by default on cards, ``gloo`` on the CPU and for ranks that
share one card.

It closes with the reference's lines (rank 0's in a data-parallel run):
the final loss and the SVDs used against a fixed interval's, and under
``--adaptive-rank`` the rank transitions and the optimizer state's size.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

log = logging.getLogger("repro_torch.launch")


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
    ap.add_argument("--compress", action="store_true",
                    help="data parallelism: average the low-rank gradient "
                         "payload and refresh distributed")
    ap.add_argument("--zero", action="store_true",
                    help="partition the optimizer state over the ranks "
                         "(with --compress also turns on --zero2)")
    ap.add_argument("--zero2", type=int, default=-1, choices=(-1, 0, 1),
                    help="force the ZeRO-2 low-rank-gradient "
                         "reduce-scatter on (1) or off (0); default -1 "
                         "follows --zero")
    ap.add_argument("--mesh", default="",
                    help="DxM (data x model); default: the world's Nx1")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree t: the (N/t, t) mesh")
    ap.add_argument("--devices", type=int, default=0,
                    help="start N data-parallel ranks in this machine")
    ap.add_argument("--multihost", action="store_true",
                    help="join the process group torchrun describes")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="the process group's backend (default: nccl on "
                         "cards, gloo on the CPU)")
    return ap


def _train(args, comm=None) -> List[str]:
    """Build the trainer (on this rank), train, and return the closing
    lines."""
    import torch

    from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
    from repro_torch.core import qgalore
    from repro_torch.core.optimizers import preset
    from repro_torch.device import resolve_device
    from repro_torch.distributed.comm import mesh_comms
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer

    logging.basicConfig(level=logging.INFO)
    device = resolve_device(args.device)
    if comm is not None and device.type == "cuda":
        n = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", comm.rank)) \
            if args.multihost else comm.rank
        device = torch.device("cuda", local % n)
        torch.cuda.set_device(device)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    groups = None
    if comm is not None:
        groups = mesh_comms(comm, (comm.world // args.model_ranks,
                                   args.model_ranks))
    bundle = model_zoo.build_arch(
        args.arch, smoke=args.smoke, device=device, dtype=dtype,
        tp_group=None if args.model_ranks == 1 else groups.model)
    ladder = tuple(int(x) for x in args.rank_ladder.split(",") if x)
    qcfg = preset(args.optimizer, QGaLoreConfig(
        rank=args.rank, min_dim=64 if args.smoke else 128,
        compress_dp_grads=args.compress,
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
                      else torch.bfloat16, group=groups,
                      zero_shard=args.zero and comm is not None,
                      zero2=None if args.zero2 < 0 else bool(args.zero2))
    if comm is not None:
        whole, held = trainer.opt_state_bytes()
        most = comm.all_reduce_max(held)
        if comm.rank == 0:
            log.info("optimizer state: %.1f MB global, %.1f MB max/rank "
                     "(zero_shard=%s)", whole / 2**20, most / 2**20,
                     trainer.zero_shard)
    trainer.maybe_restore()
    hist = trainer.run()
    lines = [f"final loss {hist[-1]['loss']:.4f}; "
             f"SVD used {trainer.controller.total_svd_count()} / "
             f"{trainer.controller.baseline_svd_count(args.steps)} baseline"]
    if args.adaptive_rank:
        for t in trainer.controller.rank_transition_summary():
            lines.append(f"rank transition: step {t['step']} {t['path']} "
                         f"{t['old']} -> {t['new']}")
        bytes_now = qgalore.optimizer_state_bytes(
            trainer.whole_state().params, trainer.rules, specs=trainer.specs)
        lines.append(f"optimizer state {bytes_now / 2**20:.2f} MB; "
                     f"DP payload {qgalore.dp_payload_bytes(trainer.specs)} "
                     "B/step")
    return lines


def _rank_main(comm, args) -> List[str]:
    import torch
    if args.device == "cpu":      # N ranks share the host's cores
        torch.set_num_threads(1)
    return _train(args, comm)


def main(argv: Optional[List[str]] = None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import make_tp_mesh, parse_mesh
    mesh = None
    if args.mesh:
        try:
            mesh = parse_mesh(args.mesh)
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
    if os.environ.get("WORLD_SIZE") and not args.multihost:
        ap.error("WORLD_SIZE is set (torchrun): pass --multihost to join "
                 "its process group")
    if args.multihost and args.devices:
        ap.error("--multihost and --devices both start the ranks: pass one")
    world = args.devices or (int(os.environ.get("WORLD_SIZE", 0))
                             if args.multihost else 1)
    if args.multihost and not world:
        ap.error("--multihost needs the environment torchrun sets "
                 "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
    if args.tp:
        try:
            tp_mesh = make_tp_mesh(args.tp, world)
        except ValueError as e:
            ap.error(f"--tp {args.tp}: {e}")
        if mesh is not None and mesh.shape != tp_mesh.shape:
            ap.error(f"--tp {args.tp} and --mesh {args.mesh} disagree")
        mesh = tp_mesh
    if mesh is not None and mesh.size != world:
        ap.error(f"--mesh {args.mesh or mesh.shape} needs {mesh.size} "
                 f"devices, have {world} (use --devices on CPU)")
    args.model_ranks = 1 if mesh is None else mesh.shape["model"]
    distributed = mesh is not None or world > 1
    if args.zero2 == 1:      # the trainer's refusal, before any rank starts
        from repro_torch.distributed.zero import require_zero2
        require_zero2(distributed, args.zero, args.compress)
    backend = args.backend or ("gloo" if args.device == "cpu" else "nccl")
    if not distributed:
        lines = _train(args)
    elif args.multihost:
        import torch.distributed as dist

        from repro_torch.distributed.comm import Comm
        dist.init_process_group(backend, init_method="env://")
        try:
            comm = Comm()
            lines = _train(args, comm)
            if comm.rank:
                lines = []
        finally:
            dist.destroy_process_group()
    else:
        from repro_torch.distributed.spawn import run_ranks
        lines = run_ranks(_rank_main, world, args, backend=backend)[0]
    for line in lines:
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
