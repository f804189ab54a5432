#!/usr/bin/env python3
"""Prefill times of the port's llama-1b serving runs, and the tiled
``int8_matmul``'s time at short and long M, on one NVIDIA GPU.

    PYTHONPATH=<tree>/src python3 tools/prefill_probe.py [--seed 0] \
        [--kc 512,1024,2048] [--out FILE]

Imports ``repro_torch`` and ``chip_smoke.py`` from the tree that
``PYTHONPATH`` names, so a checkout of another commit (unpacked with
``git archive``; it builds its own ``build/``) runs its own code and its
own launch plans. To compare two commits, run both in one call,
alternated (parent, change, change, parent, ...), one process a run.

Prints one JSON line (and writes it to ``--out``):

* ``slot``: ``chip_smoke.py``'s phase 3, the slot scheduler (8 slots, 16
  requests; each group prefill synchronised and timed);
* ``paged``: phase 10a's 8-slot paged run (each append and fused dispatch
  synchronised and timed);
* ``matmul``: one ``int8_matmul`` call (CUDA events, median of 20, L2
  flushed before each, the partials' reduction included) at llama-1b's
  four (K, N) and LLaMA-7B's three, bf16 x, at M = 32, 64, 128, 256 and
  2048 (1024 for LLaMA-7B), under the tree's own plan, and with ``--kc``
  under each other bound of the tiled path's K split (``TILED_KC``) where
  the tree has one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

SHAPES = {"llama-1b": ([(2048, 2048), (2048, 5461), (5461, 2048),
                        (2048, 32000)], (32, 64, 128, 256, 2048)),
          "llama-7b": ([(4096, 4096), (4096, 11008), (11008, 4096)],
                       (32, 64, 128, 256, 1024))}


def matmul_rows(smoke, seed: int, kcs: list) -> list:
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    own = getattr(ti8, "TILED_KC", None)
    bounds = ["plan"] + (kcs if own is not None else [])
    rows = []
    for model, (kn, ms) in SHAPES.items():
        for K, N in kn:
            qt = quant.quantize_blockwise(
                torch.randn((K, N), generator=gen, device=dev) * 0.02, 8,
                symmetric=True)
            for M in ms:
                x = torch.randn((M, K), generator=gen,
                                device=dev).to(torch.bfloat16)
                row = {"model": model, "M": M, "K": K, "N": N, "ms": {},
                       "splits": {}}
                try:
                    for kc in bounds:
                        ti8.TILED_KC = own if kc == "plan" else kc
                        row["splits"][kc] = ti8.plan(M, K,
                                                     qt.q.shape[1]).splits
                        row["ms"][kc] = smoke.time_ms(
                            lambda: ti8.int8_matmul(x, qt.q, qt.scale),
                            flush)
                finally:
                    if own is not None:
                        ti8.TILED_KC = own
                rows.append(row)
                print(f"  {model} M={M:5d} K={K:5d} N={N:5d} "
                      + " ".join(f"{kc}: {row['ms'][kc]:.4f} ms "
                                 f"({row['splits'][kc]} splits)"
                                 for kc in bounds), flush=True)
            del qt
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kc", default="",
                    help="comma-separated K-split bounds to time beside "
                         "the tree's own plan")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("prefill_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    tree = Path(repro_torch.__file__).resolve().parents[2]
    sys.path.insert(0, str(tree))
    import chip_smoke as smoke
    card = smoke.nvidia_smi_line()
    print("card:", card, "tree:", tree, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    slot = smoke.phase_serving(args.seed)
    cfg, bundle, params = smoke.serving_model(args.seed)
    paged = smoke.paged_run(
        bundle, params, smoke.serving_requests(args.seed, cfg.vocab_size),
        slots=smoke.SERVE_SLOTS, window=smoke.SERVE_WINDOW, shapes=set())
    del bundle, params
    torch.cuda.empty_cache()
    kcs = [int(k) for k in args.kc.split(",") if k]
    line = json.dumps({
        "card": card, "tree": str(tree),
        "slot": {k: slot[k] for k in ("prefill_ms_total", "median_prefill_ms",
                                      "mean_ttft_s", "tokens_per_s")},
        "paged": {k: paged[k] for k in ("median_append_ms", "median_fused_ms",
                                        "dispatches", "mean_ttft_s",
                                        "tokens_per_s")},
        "matmul": matmul_rows(smoke, args.seed, kcs)})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
