#!/usr/bin/env python3
"""Probe of how one prompt's prefill, or one request's decode step,
depends on the rows that share its dispatch, on one NVIDIA GPU.

    PYTHONPATH=<tree>/src python3 tools/batch_probe.py \
        [--arch llama-1b] [--prompt 64] [--rows 1,2,4,8] [--dtype bf16] \
        [--decode]

Builds the architecture at full width and depth on the card (INT8
weights drawn from ``--seed``), then prefills the same prompt as the only
row of a dispatch and as every row of dispatches of 2, 4 and 8 rows
(``engine.build_prefill``). Every operation of each prefill is recorded
in order: each ATen operation (through a ``TorchDispatchMode``) and each
launch of the port's kernels (``int8_matmul``, ``int8_matmul_t``), keeping
the first row's block of every output whose leading axis is a multiple
of the batch (B, the flattened tokens B x prompt, B x heads); outputs of
other shapes fall out of the comparison. Each dispatch of B rows is then held
against the one-row dispatch operation by operation, bit for bit, and the
first operation whose output differs is named, with the first difference
of every other operation that differs and the last logits' difference.

With ``--decode`` (rows 1,4 unless given) the probe holds a decode step
instead: request 0 (a ``--prompt``-token prompt) and the other requests
(prompts of other lengths and tokens) are each prefilled alone, as the
slot scheduler admits them, and written into a slot pool; request 0's
decode step alone (one slot) is then held against the same step as row 0
of a pool of 4 slots, operation by operation, as ``chip_smoke.py``'s
``batch_dependence`` holds the logits alone.

The ``repro_torch`` imported is the one ``PYTHONPATH`` names, so the same
probe compares two checkouts in one run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SKIP = {"empty", "empty_like", "empty_strided", "new_empty", "detach",
        "_to_copy", "lift_fresh", "alias", "view", "_unsafe_view",
        "expand", "reshape", "select", "slice", "t", "transpose",
        "permute", "unsqueeze", "squeeze", "as_strided", "clone",
        "zeros", "zeros_like", "full", "arange", "scalar_tensor",
        "_local_scalar_dense", "item", "is_nonzero", "copy_"}


class Recorder(TorchDispatchMode):
    """Records ``(name, first row's slice or None)`` for every operation
    run under it; ``note`` adds the port's kernel launches."""

    def __init__(self, rows: int, seq: int):
        super().__init__()
        self.rows, self.seq, self.log = rows, seq, []

    def row0(self, t):
        """The first row's block of a batch-major output: its leading
        axis is the rows times something (the tokens of a row, the heads
        of a flattened ``bmm``), so the first 1/rows of it."""
        if not isinstance(t, torch.Tensor) or t.dim() == 0 \
                or t.shape[0] % self.rows:
            return None
        return t[: t.shape[0] // self.rows].detach().clone()

    def note(self, name, out):
        self.log.append((name, self.row0(out)))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name not in SKIP:
            first = out[0] if isinstance(out, (tuple, list)) and out else out
            self.log.append((name, self.row0(first)))
        return out


def run(bundle, params, prompt, rows: int, window: int):
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.serve import engine
    batch = {"tokens": prompt.expand(rows, -1).contiguous()}
    rec = Recorder(rows, prompt.shape[1])
    kernels = {n: getattr(ti8, n) for n in ("int8_matmul", "int8_matmul_t")}

    def wrap(n):
        def call(*a, **k):
            out = kernels[n](*a, **k)
            rec.note(f"{n} K={a[1].shape[0]} N={a[1].shape[1]}", out)
            return out
        return call

    for n in kernels:
        setattr(ti8, n, wrap(n))
    try:
        with rec:
            logits, _ = engine.build_prefill(bundle, window)(params, batch)
    finally:
        for n, f in kernels.items():
            setattr(ti8, n, f)
    return rec.log, logits[:1].float()


def run_decode(bundle, params, prompts, rows: int, window: int, dtype):
    """Request 0's decode step as row 0 of ``rows`` slots: the first
    ``rows`` prompts each prefilled alone into a fresh pool, then one
    decode step of every slot, its operations recorded."""
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.serve import engine
    from repro_torch.serve.scheduler import init_pool, insert_requests
    prefill = engine.build_prefill(bundle, window)
    outs = [prefill(params, {"tokens": p}) for p in prompts[:rows]]
    toks = torch.stack([lg[:, -1].argmax(-1) for lg, _ in outs]) \
        .to(torch.int32)
    pool = init_pool(bundle, rows, window, dtype, "cuda")
    for i, (_, st) in enumerate(outs):
        insert_requests(pool, [i], st)
    rec = Recorder(rows, 1)
    kernels = {n: getattr(ti8, n) for n in ("int8_matmul", "int8_matmul_t")}

    def wrap(n):
        def call(*a, **k):
            out = kernels[n](*a, **k)
            rec.note(f"{n} K={a[1].shape[0]} N={a[1].shape[1]}", out)
            return out
        return call

    for n in kernels:
        setattr(ti8, n, wrap(n))
    try:
        with rec:
            logits, _ = engine.build_decode(bundle)(params, pool, toks)
    finally:
        for n, f in kernels.items():
            setattr(ti8, n, f)
    return rec.log, logits[:1].float()


def compare(ref_log, log) -> dict:
    """The first operation whose first-row output differs, and the first
    difference of each operation name."""
    if [n for n, _ in ref_log] != [n for n, _ in log]:
        return {"same_sequence": False}
    first, by_name, n_diff, n_cmp = None, {}, 0, 0
    for i, ((name, a), (_, b)) in enumerate(zip(ref_log, log)):
        if a is None or b is None or a.shape != b.shape:
            continue
        n_cmp += 1
        if torch.equal(a, b):
            continue
        n_diff += 1
        d = (a.float() - b.float()).abs().max().item()
        key = name.split(" ")[0]
        if key not in by_name:
            by_name[key] = {"index": i, "op": name, "max_abs_diff": d}
        if first is None:
            first = {"index": i, "op": name, "max_abs_diff": d,
                     "before": [n for n, _ in ref_log[max(0, i - 4): i]]}
    return {"same_sequence": True, "compared": n_cmp, "differing": n_diff,
            "first": first, "first_by_op": sorted(by_name.values(),
                                                   key=lambda r: r["index"])}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-1b")
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--rows", default=None,
                    help="rows of the dispatches (default 1,2,4,8; with "
                         "--decode 1,4)")
    ap.add_argument("--dtype", default="bf16", choices=("bf16", "f32"))
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth (0: the config's)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--decode", action="store_true",
                    help="probe request 0's decode step, not a prefill")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("batch_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.config import replace
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    cfg = model_zoo.get_config(args.arch)
    if args.layers:
        cfg = replace(cfg, num_layers=args.layers)
    bundle = model_zoo.build(cfg, device="cuda", dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = bundle.init_params(gen, leaf_fn=lambda _, t: quantize_leaf(t))
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(1, args.prompt)).astype(np.int32)).cuda()
    window = args.prompt + 8
    rows = [int(r) for r in (args.rows or ("1,4" if args.decode
                                           else "1,2,4,8")).split(",")]
    if args.decode:
        # request 0, then prompts of other lengths and tokens
        lens = [args.prompt] + [max(8, args.prompt + d) for d in
                                (-16, 16, -32, 32, -8, 8)][:max(rows) - 1]
        prompts = [prompt] + [torch.from_numpy(rng.integers(
            1, cfg.vocab_size, size=(1, n)).astype(np.int32)).cuda()
            for n in lens[1:]]
        window = max(lens) + 8

        def probe(b):
            return run_decode(bundle, params, prompts, b, window, dtype)
    else:
        def probe(b):
            return run(bundle, params, prompt, b, window)
    ref_log, ref_logits = probe(rows[0])
    out = {"card": card, "arch": args.arch, "layers": cfg.num_layers,
           "dtype": args.dtype, "prompt": args.prompt,
           "mode": "decode" if args.decode else "prefill",
           "ops_recorded": len(ref_log), "against_rows": rows[0], "runs": {}}
    for b in rows[1:]:
        log, logits = probe(b)
        res = compare(ref_log, log)
        res["logits_max_abs_diff"] = (logits - ref_logits).abs().max().item()
        res["argmax_equal"] = bool(logits.argmax(-1).eq(
            ref_logits.argmax(-1)).all())
        out["runs"][b] = res
        first = res.get("first")
        print(f"rows {b} against {rows[0]}: "
              + ("operation sequence differs" if not res["same_sequence"]
                 else f"{res['differing']} of {res['compared']} outputs "
                 f"differ; first: {first}; logits max abs diff "
                 f"{res['logits_max_abs_diff']:.3e}, argmax equal "
                 f"{res['argmax_equal']}"), flush=True)
        for r in res.get("first_by_op", []):
            print(f"    first {r['op']} difference at operation "
                  f"{r['index']}: {r['max_abs_diff']:.3e}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
