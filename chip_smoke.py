#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, serves and
trains.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. Environment: card name and power limit, torch / CUDA / nvcc versions,
   and the build of every kernel source (one ``nvcc`` each, in parallel).
2. ``int8_matmul`` against its plain PyTorch version on the card, at the
   llama-1b (K, N) problems, M in {1, 4, 8, 64, 512, 2048, 4096} (512 and
   4096: a group prefill's rows), x in f32 and bf16: pass if
   ``max|kernel - plain| / max|plain| <= 1e-4`` where the kernel takes two
   passes (M <= 16 in both dtypes, f32 x at any M) and <= 2e-2 for one
   pass (bf16 x, M > 16). A small-M row also prints ``hi_only_rel``, the
   plain version on bf16(x * s) (what one pass would leave), and fails
   unless it exceeds 1e-4, so the gate can tell a dropped pass. Times
   (CUDA events, median of 20 launches, L2 flushed before each), the
   plain version's and one library call's times, the bound, TFLOP/s and
   the design that ran (``mma.sync`` bf16 throughout: M <= 16 two passes
   with the K split in a cluster; M > 16 one pass for bf16 x, two for f32
   x). Then one decode step's 169 calls (M 8, bf16) back to back on
   resident weights between one pair of events, beside cuBLAS bf16 on the
   same weights dequantized and the step's bound.
3. Serving at full width: llama-1b (24 layers, INT8 weights, bf16
   activations, weights drawn on the card from ``--seed``) behind the slot
   ``Scheduler`` with 8 slots and 16 requests (prompts 16-512 tokens,
   16-64 new tokens, greedy). Every request must complete, and every
   prefill and decode step must go through the kernel 7 * 24 + 1 times
   while the plain versions stay unused. Every distinct (M, K, N, x dtype)
   the kernel was launched with is then held against the plain version.
4. Path parity: llama-1b widths at 2 layers, f32, the same INT8 weights;
   ``generate`` on the CPU (plain versions) and on the card (kernel) must
   agree on the first-step logits (2e-2 of max|logits|) and the greedy
   tokens.
5. Training at full width: Q-GaLore pre-training of llama-1b (24 layers,
   INT8 weights, bf16 activations, rank 512, the ``qgalore`` preset) for
   6 steps of 8 x 256 synthetic tokens from ``--seed``. Step 0 refreshes
   all 169 projections by SVD; steps 1-5 are steady steps, each of which
   must launch ``int8_matmul`` 337 times (169 forward, 168 recompute),
   ``int8_matmul_t`` 169 and ``fused_qgalore_update`` 169 times, and no
   plain version. Losses must be finite. Every distinct problem each new
   kernel was launched with is then held against its plain version on the
   run's own inputs (``int8_matmul_t``: 1e-4 of max|plain| on bf16 g as
   the path hands it over, whose products are exact, and 1e-4 on f32 g
   made from it with bits below bf16's, which only the second pass
   carries; the fused update: the weight within one INT8 quantum, codes
   equal on more than 0.999 of the elements, scales and moments within
   1e-5) and timed beside it, each with its design (``int8_matmul_t``:
   ``mma.sync`` bf16, one pass for bf16 g, two for f32 g; the fused
   update: ``mma.sync`` bf16, two passes on the direction, P read
   packed), TFLOP/s, and factor against cuBLAS bf16 or time against the
   bound. The fused update also takes a stress row per side on the run's
   own inputs, at an lr where lr * gscale * max|U| is 256 quanta of the
   old scale: the kernel must hold the same gate there, and the plain
   version run on bf16(dir) (one pass) must fall below 0.99 of equal
   codes (``hi_only_codes_equal``), so the gate can tell a dropped
   second pass. The run writes checkpoints (every 3 steps, into a
   temporary directory); a fresh ``Trainer`` then restores the step-3
   checkpoint through ``maybe_restore`` and runs steps 4-5, whose losses
   must equal the first run's within 1e-6 relative (the save and restore
   seconds are printed).
6. Flash-attention prefill at full width. (a) The kernel against its
   plain version on the card at llama-1b's heads (H 32, d 64, bf16):
   B in {1, 8}, S in {48, 128, 512, 2048}, causal, plus non-causal at
   B 8, S 512 and 2048, a dv = 128 and an f32 case; pass if
   ``max|kernel - plain| / max|plain|`` is at most 1e-4 (f32, three
   passes on split operands) or 1e-2 (bf16 output); the f32 row also
   prints ``hi_only_rel``, the plain arithmetic on bf16-rounded q, k, v
   and P, and fails unless it exceeds 1e-4. Each row is timed beside the
   plain version, one ``scaled_dot_product_attention`` call (the
   yardstick, never on the port's path), the bound, TFLOP/s and the design
   that ran (``mma.sync``, FlashAttention-2: bf16 one pass, f32 three).
   (b) Phase 3's 16
   requests through llama-1b built with ``flash_attention=True``: every
   group prefill must launch ``flash_attention`` 24 times (once a layer),
   run no chunked attention and no plain version; tokens/s, mean TTFT,
   the time of the group prefills (each synchronised, so the host's
   decode loop does not blur the route's effect) and the launches of
   each prefill are printed beside phase 3's, and
   every distinct (B, S) the kernel was launched with is held against
   the plain version. (c) Phase 4's path parity with the flash route on
   both sides (2 layers, f32): 2e-2 of max|logits|, equal greedy tokens,
   4 flash launches on the card and 4 plain ones on the CPU.
7. The unfused Q-GaLore update and the quantizer at llama-1b's shapes:
   ``ops.unfused_qgalore_update`` (``int4_project`` → Adam →
   back-projection → ``sr_requant_update``) for the right-side weights
   2048 x 2048 and 5461 x 2048 at rank 512 must launch ``int4_matmul``
   and ``sr_requant`` once each a weight; ``int4_matmul`` is held to 1e-4
   of max|plain| on the chain's f32 gradients and to 2e-2 on the same in
   bf16 (design, TFLOP/s and factor against cuBLAS printed as in phase
   2), and ``sr_requant`` to equal codes and scales within
   1e-6 on the chain's own inputs (``sr_requant`` also at the other two
   weight shapes); the chain is timed beside the fused path of phase 5's
   kernel. ``quantize_int8`` of all 169 llama-1b weights must launch
   ``blockwise_quant`` 169 times and equal ``core.quant.
   quantize_blockwise`` bit for bit.
8. LLaMA-7B pre-training at full width and depth (32 layers, d 4096, 32
   heads, d_ff 11008, vocab 32000; INT8 weights drawn on the card from
   ``--seed``, bf16 activations): the ``qgalore`` preset at rank 1024
   with the randomized subspace method, 8 x 256 tokens a step at
   ``accum`` 2, 4 steps. Step 0 refreshes all 225 GaLore units; each
   steady step must launch ``int8_matmul`` 898 times (2 microbatches x
   (225 forward + 224 recompute)), ``int8_matmul_t`` 450 and
   ``fused_qgalore_update`` 225, and no plain version. Losses must be
   finite. Printed: the refresh step's and its subspace seconds, the
   median steady step and tokens/s, ``max_memory_allocated`` over the
   steady steps and over the whole phase beside the analytic
   ``memory_report``, and whether the steady peak is under 16 GiB. Every
   distinct problem of the three kernels is then held against its plain
   version as in phase 5 (``int8_matmul`` as in phase 2) and timed.
9. Fine-tuning. (a) ``launch.finetune.main`` with its default flags on
   llama-60m at its published widths and depth (8 layers, d 512, vocab
   32000; rank 8, the first layer, embedding, final norm and head frozen,
   8 steps of 4 x 32 tokens), the report written to
   ``build/finetune_memory.json`` beside the kernels the run built: it
   must say ``qgalore_leq_qlora: true`` (``main`` checks the four
   contracts), the three training kernels must launch and no plain
   version; then one more step from the trained state on the same
   clipped low-rank gradients and uniforms through
   ``transform.qgalore_transform`` (the fused kernel) and
   ``transform.qgalore_reference_chain`` (plain stages): every tuned
   weight within one INT8 quantum, with the share of equal codes
   printed. (b) LLaMA-7B fine-tuning at full width and depth (phase 8's
   model built with ``split_layers=1``) under ``launch.finetune``'s
   rule-set at rank 8 with the randomized subspace method,
   ``update_interval`` 2, 8 x 256 tokens a step, 4 steps (steps 0 and 2
   refresh): the four contracts through ``launch.finetune``'s functions,
   every steady step launching ``int8_matmul`` 449 times (225 forward, 224
   recompute), ``int8_matmul_t`` 225 and ``fused_qgalore_update`` 217 (the
   31 tuned layers x 7) and no plain version; the refresh and steady
   steps, each step's ``max_memory_allocated``, ``memory_report`` beside
   the QLoRA baseline at rank 8; then every distinct kernel problem
   against its plain version as in phase 8.

The last three lines are the kernels JSON (all seven kernels;
``int8_matmul``'s and ``int8_matmul_t``'s training step, flash's prefill
and ``int4_matmul``'s projections with ``factor`` = ms / library_ms; the
three training kernels also carry their LLaMA-7B pre-training and
fine-tuning rows),
the ``nvidia-smi`` name and power limit, and ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the repository's ``src/``
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core rate
TOL = 2e-2
RESUME_TOL = 1e-6    # a resumed step's loss against the first run's
F32_X_TOL = 1e-4     # f32 x: two bf16 passes on the tiled path
KN = [(2048, 2048), (2048, 5461), (5461, 2048), (2048, 32000)]
MS = [1, 4, 8, 64, 512, 2048, 4096]


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"nvidia-smi failed (exit {out.returncode}): "
                           f"{out.stderr.strip()}")
    return lines[0]


def num_layers() -> int:
    from repro_torch.models import model_zoo
    return model_zoo.get_config("llama-1b").num_layers


def small_m(M: int, K: int, N: int) -> bool:
    """Whether ``int8_matmul`` runs an (M, K) x (K, N) problem on its
    small-M path (two passes in both dtypes)."""
    from repro_torch.kernels import int8_matmul as ti8
    return ti8.plan(M, K, N).path == 0


def i8_design(M: int, K: int, N: int, dtype) -> str:
    """Which ``int8_matmul`` kernel design runs a problem."""
    if small_m(M, K, N):
        return ("mma.sync bf16 x2 (hi/lo) small-M, K split in a cluster "
                "(DSMEM reduction)")
    return mma_design(dtype)


def mma_design(dtype) -> str:
    """The tensor-core design that runs an operand of ``dtype``: one bf16
    ``mma.sync`` pass, or two (hi and lo) for f32."""
    return ("mma.sync bf16 x1" if dtype == torch.bfloat16
            else "mma.sync bf16 x2 (hi/lo)")


def i8_tol(M: int, K: int, N: int, dtype) -> float:
    """Two passes (the small-M path in both dtypes, f32 x on any path):
    1e-4 of max|plain|; one bf16 pass: 2e-2."""
    two = small_m(M, K, N) or dtype == torch.float32
    return F32_X_TOL if two else TOL


def i8_hi_only(x, qt) -> float:
    """The error a single bf16 pass would leave: the plain version on
    bf16(x * s), relative to max|plain|."""
    from repro_torch.kernels import ref
    K, N = qt.q.shape
    xs = (x.float()[:, :, None] * qt.scale[None]).to(torch.bfloat16).float()
    got = torch.einsum("mkg,kgb->mgb", xs,
                       qt.q.float().reshape(K, N // 256, 256)).reshape(-1, N)
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    return ((got - want).abs().max() / want.abs().max()).item()


def check_against_plain(x, qt) -> tuple[float, float]:
    """Max abs and relative error of the kernel against
    ``int8_matmul_ref`` on the same inputs."""
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    got = ti8.int8_matmul(x, qt.q, qt.scale)
    want = ref.int8_matmul_ref(x, qt.q, qt.scale, 256)
    abs_err = (got - want).abs().max().item()
    return abs_err, abs_err / max(want.abs().max().item(), 1e-30)


def time_ms(fn, flush: torch.Tensor, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each timed with
    CUDA events after the L2 cache was overwritten. A spin kernel before
    the start event keeps the device busy while the host enqueues ``fn``,
    so the events bracket device work and not the host's launch path."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound(M, K, N, x_itemsize):
    """Least time (ms) for the work, and what bounds it: each input read
    once, the f32 output written once (the count of repro/kernels/ops.py
    _i8_bytes), against the multiply-adds at the bf16 peak."""
    nbytes = M * K * x_itemsize + K * N + K * (N // 256) * 4 + M * N * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * M * K * N / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_environment():
    from repro_torch.kernels import build
    log("== phase 1: environment")
    log("card:", nvidia_smi_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)} "
        f"sms {torch.cuda.get_device_properties(0).multi_processor_count}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log("nvcc:", nvcc[-1] if nvcc else "?")
    try:
        import triton
        log("triton:", triton.__version__)
    except ImportError:
        log("triton: not installed")
    log("cutlass headers:",
        Path("/usr/local/cutlass/include/cutlass/cutlass.h").exists())
    t0 = time.monotonic()
    built = build.build(verbose=True)
    log(f"kernel build: {len(built)} source(s) in "
        f"{time.monotonic() - t0:.1f} s")
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_kernels(seed: int):
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    log("== phase 2: int8_matmul against int8_matmul_ref on the card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows, max_abs, max_rel, failed = [], 0.0, 0.0, []
    for K, N0 in KN:
        w = torch.randn((K, N0), generator=gen, device=dev) * 0.02
        qt = quant.quantize_blockwise(w, bits=8, symmetric=True)
        w_lib = quant.dequantize(qt, torch.bfloat16)
        N = qt.q.shape[1]
        del w
        for M in MS:
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn((M, K), generator=gen, device=dev).to(dt)
                abs_err, rel = check_against_plain(x, qt)
                max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
                ms = time_ms(lambda: ti8.int8_matmul(x, qt.q, qt.scale),
                             flush)
                plain_ms = time_ms(
                    lambda: ref.int8_matmul_ref(x, qt.q, qt.scale, 256),
                    flush)
                x_lib = x.to(torch.bfloat16)
                lib_ms = time_ms(lambda: torch.matmul(x_lib, w_lib), flush)
                b_ms, b_by = bound(M, K, N, x.element_size())
                # a small-M row must also show that one pass would fail
                hi_only = i8_hi_only(x, qt) if small_m(M, K, N) else None
                row = {"M": M, "K": K, "N": N, "n_real": N0,
                       "x": str(dt).replace("torch.", ""), "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "rel_err": rel,
                       "hi_only_rel": hi_only,
                       "tflops": 2 * M * K * N0 / ms / 1e9,
                       "design": i8_design(M, K, N, dt)}
                rows.append(row)
                ok = rel <= i8_tol(M, K, N, dt) and (hi_only is None
                                              or hi_only > F32_X_TOL)
                if not ok:
                    failed.append(row)
                log(f"  M={M:5d} K={K:5d} N={N:6d} x={row['x']:8s} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"tflops={row['tflops']:.1f} [{row['design']}] "
                    f"rel_err={rel:.2e}"
                    + ("" if hi_only is None
                       else f" hi_only_rel={hi_only:.2e}")
                    + f" {'ok' if ok else 'FAIL'}")
                del x, x_lib
        del qt, w_lib
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"on {len(failed)} problem(s): {failed}")
    two = [r["rel_err"] for r in rows
           if r["hi_only_rel"] is not None or r["x"] == "float32"]
    log(f"  {len(rows)} problems agree: max rel err {max_rel:.2e} "
        f"<= tolerance {TOL} (two passes, small-M path or f32 x: "
        f"{max(two):.2e} <= {F32_X_TOL}; one pass would leave hi_only_rel >= "
        f"{min(r['hi_only_rel'] for r in rows if r['hi_only_rel']):.2e})")
    layers = num_layers()
    # one decode step of the main path at 8 slots, bf16: 7 matmuls a layer
    # (wq, wk, wv, wo at (2048, 2048); wi, wg at (2048, 5461); wd at
    # (5461, 2048)) and the head (2048, 32000)
    pick = {(r["K"], r["n_real"]): r for r in rows
            if r["M"] == 8 and r["x"] == "bfloat16"}
    mult = {(2048, 2048): 4 * layers, (2048, 5461): 2 * layers,
            (5461, 2048): layers, (2048, 32000): 1}
    step = {k: sum(pick[s][k] * n for s, n in mult.items())
            for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    step_by = "bytes" if all(pick[s]["bound_by"] == "bytes"
                             for s in mult) else "operations"
    log(f"  decode step (M=8, bf16, {7 * layers + 1} calls), sum of "
        "per-call times: " + " ".join(f"{k}={v:.4f}" for k, v in step.items()))
    step["sequence"] = decode_sequence(seed)
    return rows, step, step_by, max_abs, max_rel


def sequence_ms(fn, reps: int = 10) -> tuple:
    """Median device time of ``fn`` (many launches) between one pair of
    events, and the host's time to enqueue it. A long spin kernel before
    the start event keeps the device busy while the host enqueues, so the
    events bracket back-to-back device work only."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(reps):
        torch.cuda._sleep(100_000_000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        fn()
        stop.record()
        host.append((time.perf_counter() - t) * 1e3)
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), statistics.median(host)


def decode_sequence(seed: int) -> dict:
    """One decode step's ``int8_matmul`` calls at 8 slots, bf16 x (7 a
    layer at llama-1b's 24 layers, then the head), each on its own weight,
    all resident on the card, back to back on the stream between one pair
    of events: 1.29 GB of codes, far past the 50 MB L2, so the sequence is
    cold by itself. Beside it cuBLAS bf16 on the same weights dequantized,
    and the bound of the step's bytes. The codes and scales are drawn
    directly (the arithmetic does not care how they were made)."""
    from repro_torch.kernels import int8_matmul as ti8
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    layers = num_layers()
    per_layer = [(2048, 2048)] * 4 + [(2048, 5461)] * 2 + [(5461, 2048)]
    probs = [p for _ in range(layers) for p in per_layer] + [(2048, 32000)]
    weights, xs = [], {}
    for K, N0 in probs:
        N = -(-N0 // 256) * 256
        q = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                          dtype=torch.int8)
        q[:, N0:] = 0
        sc = torch.rand((K, N // 256), generator=gen, device=dev) * 2e-4 \
            + 1e-4
        weights.append((q, sc, N0))
        if K not in xs:
            xs[K] = torch.randn((8, K), generator=gen,
                                device=dev).to(torch.bfloat16)
    ms, host_ms = sequence_ms(lambda: [ti8.int8_matmul(xs[q.shape[0]], q, sc)
                                       for q, sc, _ in weights])
    lib = [(q.float().reshape(q.shape[0], -1, 256) * sc[..., None])
           .reshape(q.shape[0], -1)[:, :n0].to(torch.bfloat16)
           for q, sc, n0 in weights]
    lib_ms, lib_host_ms = sequence_ms(
        lambda: [torch.matmul(xs[w.shape[0]], w) for w in lib])
    b_ms = sum(bound(8, K, -(-N0 // 256) * 256, 2)[0] for K, N0 in probs)
    out = {"calls": len(probs), "ms": ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "host_enqueue_ms": host_ms,
           "library_host_enqueue_ms": lib_host_ms,
           "gbytes_per_s": sum(K * -(-N0 // 256) * 256 for K, N0 in probs)
           / ms / 1e6}
    log(f"  decode step (M=8, bf16, {len(probs)} calls) back to back on "
        f"resident weights: ms={ms:.4f} library_ms={lib_ms:.4f} "
        f"bound_ms={b_ms:.4f} ({out['gbytes_per_s']:.0f} GB/s of codes; "
        f"host enqueue {host_ms:.2f} / {lib_host_ms:.2f} ms, inside the "
        "spin)")
    del weights, lib, xs
    torch.cuda.empty_cache()
    return out


def phase_serving(seed: int, flash: bool = False):
    """Phase 3, or with ``flash`` phase 6's serving run: the same requests
    through a bundle built with ``flash_attention=True``, where every
    group prefill must launch ``flash_attention`` once a layer and never
    the chunked attention or a plain version."""
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import attention, model_zoo
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, Scheduler
    log("== phase 6b: llama-1b serving, prefill through flash_attention"
        if flash else "== phase 3: llama-1b serving through the slot "
        "scheduler")
    cfg = model_zoo.get_config("llama-1b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16,
                             flash_attention=flash)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init_params(gen,
                                leaf_fn=lambda _, t: quantize_leaf(t))
    torch.cuda.synchronize()
    log(f"  init + INT8 quantization on the card: "
        f"{time.monotonic() - t0:.2f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(seed)
    n_req, slots, max_new = 16, 8, 64
    lens = rng.integers(16, 513, size=n_req)
    news = rng.integers(16, max_new + 1, size=n_req)
    reqs = [Request(rid=i, tokens=rng.integers(1, cfg.vocab_size,
                                                size=int(lens[i]))
                    .astype(np.int32), max_new_tokens=int(news[i]))
            for i in range(n_req)]
    sched = Scheduler(bundle, params, num_slots=slots, max_len=512 + max_new,
                      dtype=torch.bfloat16, device="cuda")
    # warm-up: first launches, library handles; then a fresh pool
    sched.run([Request(rid=-1, tokens=reqs[0].tokens[:16],
                       max_new_tokens=2)])
    sched.reset()

    step_ms = []
    inner = sched._step

    def timed_step(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    sched._step = timed_step
    # every distinct problem the kernel is launched with, checked after
    # the run (``ops`` calls the wrapper through its module attribute)
    shapes = set()
    kernel = ti8.int8_matmul

    def recording(x, q, scale, block=256):
        shapes.add((x.shape[0], q.shape[0], q.shape[1], x.dtype))
        return kernel(x, q, scale, block)

    ti8.int8_matmul = recording
    # each prefill's time (synchronised: the route's own effect, apart
    # from the host's decode loop), launches and chunked-attention blocks,
    # and every distinct (B, S) the flash kernel is launched with
    prefills, prefill_ms, flash_shapes, dense = [], [], set(), []
    k_flash, k_dense, k_prefill = (tflash.flash_attention,
                                   attention._attend_dense, sched._prefill)

    def rec_flash(q, k, v, *, causal=True):
        flash_shapes.add((q.shape[0], q.shape[1], q.shape[2], k.shape[2],
                          q.shape[3], v.shape[3], causal, q.dtype))
        return k_flash(q, k, v, causal=causal)

    def rec_dense(*a, **k):
        dense.append(1)
        return k_dense(*a, **k)

    def rec_prefill(*a):
        before, n_dense = Counter(LAUNCHES), len(dense)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = k_prefill(*a)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
        prefills.append(({n: LAUNCHES[n] - before[n] for n in LAUNCHES
                          if LAUNCHES[n] != before[n]},
                         len(dense) - n_dense))
        return out

    sched._prefill = rec_prefill
    if flash:
        tflash.flash_attention, attention._attend_dense = rec_flash, rec_dense
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        comps = sched.run(reqs)
        torch.cuda.synchronize()
    finally:
        ti8.int8_matmul = kernel
        tflash.flash_attention, attention._attend_dense = k_flash, k_dense
        sched._prefill = k_prefill
    wall = time.monotonic() - t0
    counts = dict(LAUNCHES)
    st = sched.stats
    by_rid = {c.rid: c for c in comps}
    problems = []
    if st["admitted"] != n_req or st["retired"] != n_req:
        problems.append(f"admitted/retired {st['admitted']}/{st['retired']}")
    for r in reqs:
        c = by_rid.get(r.rid)
        if c is None or len(c.tokens) != r.max_new_tokens:
            problems.append(f"request {r.rid} incomplete")
        elif not all(0 <= t < cfg.vocab_size for t in c.tokens):
            problems.append(f"request {r.rid} token out of range")
    per_call = 7 * cfg.num_layers + 1
    calls = st["prefills"] + st["decode_steps"]
    launched = counts.get("int8_matmul", 0)
    if launched != per_call * calls:
        problems.append(f"int8_matmul launches {launched}"
                        f" != {per_call} x {calls}")
    if any(n.endswith("_ref") or n.startswith("deq_") for n in counts):
        problems.append(f"plain versions ran on the main path: {counts}")
    if flash:
        for i, (launches, n_dense) in enumerate(prefills):
            if launches.get("flash_attention") != cfg.num_layers or n_dense:
                problems.append(f"prefill {i}: launches {launches}, "
                                f"{n_dense} chunked attention blocks")
        if len(prefills) != st["prefills"]:
            problems.append(f"{len(prefills)} prefills seen of "
                            f"{st['prefills']}")
    elif counts.get("flash_attention"):
        problems.append(f"flash_attention ran with the route off: {counts}")
    n_tok = sum(len(c.tokens) for c in comps)
    result = {"tokens_per_s": n_tok / wall, "wall_s": wall,
              "tokens": n_tok,
              "mean_ttft_s": float(np.mean([c.ttft for c in comps])),
              "median_decode_step_ms": statistics.median(step_ms),
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "stats": st, "launches": counts,
              "launches_per_step": launched / max(calls, 1),
              "prefill_ms_total": sum(prefill_ms),
              "median_prefill_ms": statistics.median(prefill_ms)}
    if flash:
        result["launches_per_prefill"] = [p[0] for p in prefills]
    log(f"  {n_req} requests, {slots} slots: {n_tok} tokens in {wall:.2f} s"
        f" -> {result['tokens_per_s']:.1f} tok/s; mean TTFT "
        f"{result['mean_ttft_s']:.3f} s; median decode step "
        f"{result['median_decode_step_ms']:.2f} ms; {len(prefill_ms)} "
        f"prefills {result['prefill_ms_total']:.1f} ms in all (median "
        f"{result['median_prefill_ms']:.2f} ms); peak "
        f"{result['peak_gib']:.2f} GiB; stats {st}; launches {counts}")
    if flash:
        log(f"  launches of each prefill: {result['launches_per_prefill']}")
    if problems:
        raise AssertionError("serving: " + "; ".join(problems))
    if flash:
        del sched, params
        torch.cuda.empty_cache()
        result.update(check_flash_shapes(flash_shapes, seed))
        return result
    result.update(check_shapes(shapes, seed))
    result.update(profile_decode(sched, reqs[:slots]))
    del sched, params
    torch.cuda.empty_cache()
    return result


def check_shapes(shapes, seed: int) -> dict:
    """Hold the kernel against its plain version at every (M, K, N, x
    dtype) the serving run launched it with, on fresh seeded inputs."""
    from repro_torch.core import quant
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    max_abs, max_rel, failed = 0.0, 0.0, []
    for K, N in sorted({(k, n) for _, k, n, _ in shapes}):
        qt = quant.quantize_blockwise(
            torch.randn((K, N), generator=gen, device=dev) * 0.02,
            bits=8, symmetric=True)
        for M, _, _, dt in sorted(s for s in shapes if s[1:3] == (K, N)):
            x = torch.randn((M, K), generator=gen, device=dev).to(dt)
            abs_err, rel = check_against_plain(x, qt)
            max_abs, max_rel = max(max_abs, abs_err), max(max_rel, rel)
            if rel > i8_tol(M, K, N, dt):
                failed.append((M, K, N, str(dt), rel))
        del qt
    torch.cuda.empty_cache()
    ms = sorted({s[0] for s in shapes})
    log(f"  {len(shapes)} distinct launch problems of the run (M in "
        f"{ms}) against the plain version: max rel err {max_rel:.2e}, "
        f"tolerance {F32_X_TOL} (M <= 16 or f32 x) or {TOL}")
    if failed:
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"at serving problems: {failed}")
    return {"checked_problems": len(shapes), "check_max_abs_err": max_abs,
            "check_max_rel_err": max_rel}


def device_rows(prof) -> list:
    """``(name, device us, calls)`` of the kernels the device ran. Only
    device-side events count: a host op's own device time repeats the
    kernels it launched (a kernel bound with ``ctypes`` is attributed to
    the host op around it), and summing both would count them twice."""
    from torch.autograd import DeviceType
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def profile_decode(sched, reqs, steps: int = 5) -> dict:
    """Device busy time against the host clock over ``steps`` decode steps
    with every slot in flight (after the timed run, outside its counts).
    If the profiler fails, its numbers are null and the error is kept."""
    from torch.profiler import ProfilerActivity, profile
    sched.reset()
    for r in reqs:
        sched.submit(r)
    sched.step()                        # admission prefill + first decode
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                sched.step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        log(f"  PROFILER FAILED: {e}")
        return {"profile_step_wall_ms": None, "profile_step_device_ms": None,
                "device_idle_share": None, "profile_error": str(e)}
    rows = device_rows(prof)
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    top = sorted(rows, key=lambda r: -r[1])[:8]
    log(f"  profiled {steps} decode steps: wall {wall_ms / steps:.2f} ms a "
        f"step, device busy {busy_ms / steps:.2f} ms a step, idle share "
        f"{1 - busy_ms / wall_ms:.3f}")
    for key, t, _ in top:
        log(f"    device {t / 1e3 / steps:8.3f} ms/step  {key[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])[:8]
    for key, t, n in host:
        log(f"    host   {t / 1e3 / steps:8.3f} ms/step  "
            f"{n // steps:5d} calls/step  {key[:80]}")
    return {"profile_step_wall_ms": wall_ms / steps,
            "profile_step_device_ms": busy_ms / steps,
            "device_idle_share": 1 - busy_ms / wall_ms}


def phase_parity(seed: int, flash: bool = False):
    """Phase 4, or with ``flash`` phase 6c: both bundles built with
    ``flash_attention=True``, so the card's prefill runs the flash kernel
    and the CPU's its plain version."""
    from repro_torch.config import replace
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    log("== phase 6c: path parity of the flash route, card against CPU"
        if flash else "== phase 4: path parity, card (kernel) against CPU "
        "(plain)")
    cfg = replace(model_zoo.get_config("llama-1b"), num_layers=2)
    gpu = model_zoo.build(cfg, device="cuda", dtype=torch.float32,
                          flash_attention=flash)
    cpu = model_zoo.build(cfg, device="cpu", dtype=torch.float32,
                          flash_attention=flash)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    p_gpu = gpu.init_params(
        gen, leaf_fn=lambda _, t: quantize_leaf(t))

    def to_cpu(t):
        if isinstance(t, dict):
            return {k: to_cpu(v) for k, v in t.items()}
        return t.to("cpu")          # QTensor.to and Tensor.to alike

    p_cpu = to_cpu(p_gpu)
    rng = np.random.default_rng(seed + 1)
    lengths = [12, 7]
    toks = np.zeros((2, 12), np.int32)
    for i, L in enumerate(lengths):
        toks[i, :L] = rng.integers(1, cfg.vocab_size, size=L)
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.tensor(lengths, dtype=torch.int32)}
    out = {}
    for name, bundle, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
        LAUNCHES.clear()
        dev = bundle.device
        b = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = engine.build_prefill(bundle, 24)(params, b)
        gen_toks, _ = engine.generate(bundle, params, b, steps=8,
                                      max_len=24, device=dev)
        out[name] = (logits.float().cpu(), gen_toks.cpu(), dict(LAUNCHES))
    (l_c, t_c, n_c), (l_g, t_g, n_g) = out["cpu"], out["gpu"]
    rel = ((l_g - l_c).abs().max() / l_c.abs().max()).item()
    log(f"  first-step logits rel err {rel:.2e}; tokens cpu "
        f"{t_c.tolist()} gpu {t_g.tolist()}; launches cpu {n_c} gpu {n_g}")
    if not n_g.get("int8_matmul") or n_g.get("deq_matmul"):
        raise AssertionError(f"card run did not go through the kernel: {n_g}")
    if not n_c.get("deq_matmul") or n_c.get("int8_matmul"):
        raise AssertionError(f"CPU run did not take the plain path: {n_c}")
    # one prefill of ``build_prefill`` and one of ``generate``, 2 layers
    want = {"flash_attention": 4} if flash else {}
    if {n: c for n, c in n_g.items() if n.startswith("flash")} != want or \
            n_c.get("flash_attention_ref", 0) != want.get("flash_attention",
                                                          0):
        raise AssertionError(f"flash launches: card {n_g}, CPU {n_c}")
    if rel > TOL or not torch.equal(t_c, t_g):
        raise AssertionError(f"path parity failed: rel {rel:.2e}, tokens "
                             f"{t_c.tolist()} vs {t_g.tolist()}")
    return rel


def bound_t(M, K, N, g_itemsize):
    """Least time (ms) of ``g (M, N) @ deq(q (K, N))^T``: g, codes and
    scales read once, the f32 (M, K) output written once, against the
    multiply-adds at the bf16 peak."""
    nbytes = M * N * g_itemsize + K * N + K * (N // 256) * 4 + M * K * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * M * K * N / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_fused(args):
    """Least time (ms) of one fused update: every input read once (the
    low-rank triple, packed P with its scales and zeros, the codes and
    scales, the f32 uniforms), every output written once (codes, scales,
    m', v'), against the rank-r back-projection's multiply-adds at the
    bf16 peak (the fastest rate the card has for this work)."""
    g, m, v, pq, ps, pz, q, ws, u01 = args
    ins = sum(t.numel() * t.element_size() for t in args)
    outs = (q.numel() * q.element_size() + ws.numel() * 4
            + 2 * g.numel() * 4)
    R = pq.shape[-1] * 2
    t_bytes = (ins + outs) / HBM_BYTES_PER_S
    t_ops = 2 * q.shape[0] * q.shape[1] * R / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_counted(tr, steps: int, names, at_step=None) -> list:
    """``tr.run(steps)`` with, for each step, its loss, grad norm, host
    seconds (the trainer's clock around the step, which ends on the
    metrics' copy to the host, so the device work is done) and the
    launches of each of ``names`` it made; ``at_step(step)`` runs (after
    a synchronize) before each step."""
    from repro_torch.kernels import LAUNCHES
    snaps = {}

    def hook(step):
        torch.cuda.synchronize()
        snaps[step] = Counter(LAUNCHES)
        if at_step is not None:
            at_step(step)

    first = tr.start_step
    tr.fault_hook = hook
    try:
        hist = tr.run(steps)
    finally:
        tr.fault_hook = None
    torch.cuda.synchronize()
    snaps[steps] = Counter(LAUNCHES)
    rows = []
    for h in hist:
        s = h["step"]
        if s < first:
            continue
        row = {"step": s, "loss": h["loss"], "grad_norm": h["grad_norm"],
               "s": h["dt"], "launches": {n: snaps[s + 1][n] - snaps[s][n]
                                          for n in names}}
        rows.append(row)
        log(f"  step {s}: loss {row['loss']:.4f} grad_norm "
            f"{row['grad_norm']:.4f} {row['s']:.3f} s launches "
            f"{row['launches']}")
    return rows


def time_saves(tr) -> list:
    """Wrap ``tr``'s checkpoint manager so each save (host copy and write)
    records its step and seconds in the returned list."""
    saves, save = [], tr.mgr.save

    def timed(step, state, extra_meta=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save(step, state, extra_meta)
        tr.mgr.wait()
        saves.append({"step": step, "s": time.perf_counter() - t})
    tr.mgr.save = timed
    return saves


def check_resume(bundle, tcfg, qcfg, ckpt_root: Path, rows, save_s) -> dict:
    """A fresh trainer restores the run's periodic checkpoint (moved alone
    into a directory of its own, so ``maybe_restore`` finds it as the
    latest) and runs the steps after it: its losses must equal the first
    run's within ``RESUME_TOL`` relative."""
    from repro_torch.config import replace
    from repro_torch.train.trainer import Trainer
    every = tcfg.checkpoint_every
    src = ckpt_root / "run" / f"step_{every:08d}"
    (ckpt_root / "resume").mkdir()
    os.rename(src, ckpt_root / "resume" / src.name)
    tr = Trainer(bundle, replace(tcfg, checkpoint_dir=str(
        ckpt_root / "resume")), qcfg)
    torch.cuda.synchronize()
    t = time.perf_counter()
    start = tr.maybe_restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    if start != every + 1:
        raise AssertionError(f"resume: restored to step {start}, want "
                             f"{every + 1}")
    tr.mgr = None
    hist = tr.run(tcfg.steps)
    first = {r["step"]: r["loss"] for r in rows}
    rel = max(abs(h["loss"] - first[h["step"]]) / abs(first[h["step"]])
              for h in hist)
    ok = rel <= RESUME_TOL
    saves = [(x["step"], round(x["s"], 3)) for x in save_s]
    log(f"  resume: checkpoint saves (step, s) {saves}; restore of step "
        f"{every} {restore_s:.3f} s; steps "
        f"{[h['step'] for h in hist]} losses "
        f"{[round(h['loss'], 6) for h in hist]}; largest relative "
        f"difference from the first run {rel:.3e} (limit {RESUME_TOL:g}) "
        f"{'ok' if ok else 'FAIL'}")
    del tr
    shutil.rmtree(ckpt_root, ignore_errors=True)
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"resume: losses differ by {rel:.3e} relative")
    return {"checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
            "resume_steps": [h["step"] for h in hist],
            "resume_max_rel_diff": rel}


def phase_training(seed: int):
    """Q-GaLore pre-training of llama-1b for 6 steps: step 0 refreshes
    every projection by SVD, steps 1-5 are steady steps through the fused
    update. Launch counts per step, every distinct kernel problem against
    its plain version, and the kernels timed at the slice's shapes."""
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core import projector, quant
    from repro_torch.core.optimizers import preset
    from repro_torch.kernels import LAUNCHES, ref
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    log("== phase 5: llama-1b Q-GaLore training (rank 512, 8 x 256 tokens)")
    cfg = model_zoo.get_config("llama-1b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    qcfg = preset("qgalore", QGaLoreConfig(rank=512))
    ckpt_root = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256, steps=6,
                       learning_rate=1e-3, warmup_steps=2, grad_clip=1.0,
                       log_every=0, checkpoint_dir=str(ckpt_root / "run"),
                       checkpoint_every=3, async_checkpoint=False)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, qcfg)
    torch.cuda.synchronize()
    n_units = sum(s.nbatch for s in tr.specs if s.galore)
    log(f"  init (weights, INT8, random-orthonormal INT4 P for {n_units} "
        f"GaLore units) on the card: {time.monotonic() - t0:.2f} s")
    save_s = time_saves(tr)

    # the first real inputs of every distinct problem each new kernel is
    # launched with, checked after the run (``ops`` calls the wrappers
    # through their module attributes)
    probs_t, probs_f, calls, svd_s = {}, {}, Counter(), []
    k_t, k_f, svd = ti8.int8_matmul_t, tfu.fused_qgalore_update, \
        projector.compute_subspace

    def rec_t(g, q, scale, block=256):
        key = (g.shape[0], q.shape[0], q.shape[1], g.dtype)
        calls["t", key] += 1
        if key not in probs_t:
            probs_t[key] = (g.clone(), q, scale)
        return k_t(g, q, scale, block)

    def rec_f(*args, **kw):
        q = args[6]
        key = (q.shape[0], q.shape[1], args[3].shape[-1] * 2, kw["side"])
        calls["f", key] += 1
        if key not in probs_f:
            probs_f[key] = ([t.clone() for t in args[:9]], args[9:], kw)
        return k_f(*args, **kw)

    def timed_svd(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = svd(*a, **k)
        torch.cuda.synchronize()
        svd_s.append(time.perf_counter() - t)
        return out

    ti8.int8_matmul_t, tfu.fused_qgalore_update = rec_t, rec_f
    projector.compute_subspace = timed_svd
    names = ("int8_matmul", "int8_matmul_t", "fused_qgalore_update",
             "int8_matmul_ref", "int8_matmul_t_ref",
             "fused_qgalore_update_ref", "deq_matmul", "deq_matmul_t")
    LAUNCHES.clear()
    try:
        rows = run_counted(tr, tcfg.steps, names)
    finally:
        ti8.int8_matmul_t, tfu.fused_qgalore_update = k_t, k_f
        projector.compute_subspace = svd
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = 7 * cfg.num_layers + 1
    want_steady = {"int8_matmul": 2 * per_step - 1,
                   "int8_matmul_t": per_step,
                   "fused_qgalore_update": per_step}
    problems = []
    for r in rows:
        want = dict(want_steady, **({"fused_qgalore_update": 0}
                                    if r["step"] == 0 else {}))
        got = {n: r["launches"][n] for n in want}
        if got != want:
            problems.append(f"step {r['step']} launches {got} != {want}")
        plain = {n: c for n, c in r["launches"].items()
                 if n not in want and c}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    ln_v = float(np.log(cfg.vocab_size))
    if not 0.8 * ln_v <= rows[0]["loss"] <= 1.25 * ln_v:
        problems.append(f"first loss {rows[0]['loss']:.3f} far from "
                        f"ln(vocab) = {ln_v:.3f}")
    svd_count = tr.controller.total_svd_count()
    if svd_count != n_units:
        problems.append(f"{svd_count} SVDs at the refresh, want {n_units}")
    steady = [r["s"] for r in rows[1:]]
    tokens = tcfg.global_batch * tcfg.seq_len
    result = {
        "losses": [r["loss"] for r in rows],
        "refresh_step_s": rows[0]["s"], "refresh_svd_s": sum(svd_s),
        "svd_calls": len(svd_s), "svd_units": svd_count,
        "median_steady_step_ms": statistics.median(steady) * 1e3,
        "tokens_per_s": tokens / statistics.median(steady),
        "peak_gib": peak, "launches": counts,
        "launches_per_steady_step": rows[-1]["launches"]}
    log(f"  losses {[round(x, 4) for x in result['losses']]}")
    log(f"  refresh step {result['refresh_step_s']:.2f} s, of it SVD "
        f"{result['refresh_svd_s']:.2f} s ({len(svd_s)} batched calls, "
        f"{svd_count} units); median steady step "
        f"{result['median_steady_step_ms']:.1f} ms -> "
        f"{result['tokens_per_s']:.1f} tokens/s; peak {peak:.2f} GiB")
    log(f"  measured launches per steady step: "
        f"{result['launches_per_steady_step']}")
    if problems:
        raise AssertionError("training: " + "; ".join(problems))
    tr.mgr = None                     # the profiled step writes no checkpoint
    result.update(profile_train_step(tr))
    del tr
    torch.cuda.empty_cache()
    result.update(check_resume(bundle, tcfg, qcfg, ckpt_root, rows,
                               save_s))
    # launches of each problem in one step: int8_matmul_t runs at every
    # step, the fused update at the steady ones
    mult = {"int8_matmul_t": {}, "fused_qgalore_update": {}}
    for (kind, key), n in calls.items():
        if kind == "t":
            mult["int8_matmul_t"][key[:3]] = n // tcfg.steps
        else:
            mult["fused_qgalore_update"][key] = n // (tcfg.steps - 1)
    result.update(check_train_kernels(probs_t, probs_f, mult, seed))
    return result


SEVEN_B_STEPS = 4        # step 0 refreshes all 225 units; 1-3 are steady
SEVEN_B_ACCUM = 2
MEMORY_CLAIM_GIB = 16.0  # the paper's LLaMA-7B budget


PLAIN_NAMES = ("int8_matmul_ref", "int8_matmul_t_ref",
               "fused_qgalore_update_ref", "deq_matmul", "deq_matmul_t")
TRAIN_KERNELS = ("int8_matmul", "int8_matmul_t", "fused_qgalore_update")


class ProblemRecorder:
    """Wraps the three training kernels' wrappers and
    ``projector.compute_subspace`` while installed (``with``): the first
    inputs of each distinct problem, copied to the host so that neither
    the copies nor the weights they were views of count in the run's
    device memory; the calls of each problem; and the subspace seconds
    and calls of each step (``step``, set by the caller before each)."""

    def __init__(self):
        self.i, self.t, self.f = {}, {}, {}
        self.calls = Counter()
        self.sub_s, self.sub_n = Counter(), Counter()
        self.step = -1

    def __enter__(self):
        from repro_torch.core import projector
        from repro_torch.kernels import fused_update as tfu
        from repro_torch.kernels import int8_matmul as ti8
        k_i, k_t, k_f, sub = ti8.int8_matmul, ti8.int8_matmul_t, \
            tfu.fused_qgalore_update, projector.compute_subspace
        self._saved = (k_i, k_t, k_f, sub)
        host = lambda ts: [t.to("cpu", copy=True) for t in ts]

        def rec_i(x, q, scale, block=256):
            key = (x.shape[0], q.shape[0], q.shape[1], x.dtype)
            self.calls["i", key] += 1
            if key not in self.i:
                self.i[key] = host((x, q, scale))
            return k_i(x, q, scale, block)

        def rec_t(g, q, scale, block=256):
            key = (g.shape[0], q.shape[0], q.shape[1], g.dtype)
            self.calls["t", key] += 1
            if key not in self.t:
                self.t[key] = host((g, q, scale))
            return k_t(g, q, scale, block)

        def rec_f(*args, **kw):
            q = args[6]
            key = (q.shape[0], q.shape[1], args[3].shape[-1] * 2,
                   kw["side"])
            self.calls["f", key] += 1
            if key not in self.f:
                self.f[key] = (host(args[:9]), args[9:], kw)
            return k_f(*args, **kw)

        def timed_sub(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = sub(*a, **k)
            torch.cuda.synchronize()
            self.sub_s[self.step] += time.perf_counter() - t
            self.sub_n[self.step] += 1
            return out

        ti8.int8_matmul, ti8.int8_matmul_t = rec_i, rec_t
        tfu.fused_qgalore_update, projector.compute_subspace = rec_f, \
            timed_sub
        return self

    def __exit__(self, *exc):
        from repro_torch.core import projector
        from repro_torch.kernels import fused_update as tfu
        from repro_torch.kernels import int8_matmul as ti8
        (ti8.int8_matmul, ti8.int8_matmul_t, tfu.fused_qgalore_update,
         projector.compute_subspace) = self._saved
        return False

    def check(self, steps: int, steady_steps: int, seed: int) -> dict:
        """Every recorded problem against its plain version on the card
        (``check_i8_problems``, ``check_train_kernels``), with each
        problem's launches in one step: the matmuls run at every step,
        the fused update at the steady ones."""
        mult = {"int8_matmul": {}, "int8_matmul_t": {},
                "fused_qgalore_update": {}}
        for (kind, key), n in self.calls.items():
            if kind == "i":
                mult["int8_matmul"][key[:3]] = n // steps
            elif kind == "t":
                mult["int8_matmul_t"][key[:3]] = n // steps
            else:
                mult["fused_qgalore_update"][key] = n // steady_steps
        card = lambda ts: [t.cuda() for t in ts]
        out = {"int8_matmul": check_i8_problems(
            {k: card(v) for k, v in self.i.items()}, mult["int8_matmul"])}
        out.update(check_train_kernels(
            {k: card(v) for k, v in self.t.items()},
            {k: (card(a), rest, kw) for k, (a, rest, kw) in self.f.items()},
            mult, seed))
        return out


def phase_training_7b(seed: int) -> dict:
    """Q-GaLore pre-training of LLaMA-7B at full width and depth: rank
    1024 with the randomized subspace method, 8 x 256 tokens a step at
    ``accum`` 2. Losses, the refresh step and its subspace seconds, the
    steady steps, launches per step, both memory peaks beside the
    analytic ``memory_report``; then every distinct problem of the three
    training kernels against its plain version."""
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.core import qgalore
    from repro_torch.core.optimizers import preset
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    log("== phase 8: LLaMA-7B Q-GaLore pre-training (32 layers, rank 1024, "
        f"randomized subspace, 8 x 256 tokens at accum {SEVEN_B_ACCUM})")
    cfg = model_zoo.get_config("llama-7b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    qcfg = preset("qgalore", QGaLoreConfig(rank=1024,
                                           subspace_method="randomized"))
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256,
                       steps=SEVEN_B_STEPS, learning_rate=1e-3,
                       warmup_steps=2, grad_clip=1.0, log_every=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    log(f"  device memory held before the phase: {before:.2f} GiB")
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, qcfg, accum=SEVEN_B_ACCUM)
    torch.cuda.synchronize()
    n_units = sum(s.nbatch for s in tr.specs if s.galore)
    init_s = time.monotonic() - t0
    report = qgalore.memory_report(tr.state.params, tr.rules, specs=tr.specs)
    log(f"  init on the card: {init_s:.2f} s; {n_units} GaLore units; "
        f"memory_report (GiB): " + ", ".join(
            f"{k} {v:.3f}" for k, v in report.items()))

    rec = ProblemRecorder()
    peaks, held = {}, {}

    def at_step(step):
        # each step's peak (the one before it ends here); the steady peak
        # is the largest of steps 1 on
        peaks[step - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
        held[step] = torch.cuda.memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        rec.step = step

    LAUNCHES.clear()
    with rec:
        rows = run_counted(tr, tcfg.steps, TRAIN_KERNELS + PLAIN_NAMES,
                           at_step)
    counts = dict(LAUNCHES)
    peaks[tcfg.steps - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
    steady_peak = max(peaks[s] for s in range(1, tcfg.steps))
    phase_peak = max(peaks.values())    # peaks[-1]: the init
    micro = 7 * cfg.num_layers + 1         # dense calls a forward
    want_steady = {"int8_matmul": SEVEN_B_ACCUM * (2 * micro - 1),
                   "int8_matmul_t": SEVEN_B_ACCUM * micro,
                   "fused_qgalore_update": micro}
    problems = []
    for r in rows:
        want = dict(want_steady, **({"fused_qgalore_update": 0}
                                    if r["step"] == 0 else {}))
        got = {n: r["launches"][n] for n in want}
        if got != want:
            problems.append(f"step {r['step']} launches {got} != {want}")
        plain = {n: c for n, c in r["launches"].items()
                 if n not in want and c}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    ln_v = float(np.log(cfg.vocab_size))
    if not 0.8 * ln_v <= rows[0]["loss"] <= 1.25 * ln_v:
        problems.append(f"first loss {rows[0]['loss']:.3f} far from "
                        f"ln(vocab) = {ln_v:.3f}")
    if tr.controller.total_svd_count() != n_units:
        problems.append(f"{tr.controller.total_svd_count()} subspaces at "
                        f"the refresh, want {n_units}")
    steady = [r["s"] for r in rows[1:]]
    tokens = tcfg.global_batch * tcfg.seq_len
    under = steady_peak < MEMORY_CLAIM_GIB
    result = {
        "steps": tcfg.steps, "accum": SEVEN_B_ACCUM, "rank": qcfg.rank,
        "subspace_method": qcfg.subspace_method, "units": n_units,
        "init_s": init_s, "losses": [r["loss"] for r in rows],
        "refresh_step_s": rows[0]["s"],
        "refresh_subspace_s": sum(rec.sub_s.values()),
        "subspace_calls": sum(rec.sub_n.values()),
        "median_steady_step_ms": statistics.median(steady) * 1e3,
        "tokens_per_s": tokens / statistics.median(steady),
        "steady_peak_gib": steady_peak, "phase_peak_gib": phase_peak,
        "peak_gib_by_step": {str(k): v for k, v in sorted(peaks.items())},
        "held_before_phase_gib": before,
        "memory_report_gib": report,
        "steady_peak_under_16_gib": under, "launches": counts,
        "launches_per_steady_step": rows[-1]["launches"]}
    log(f"  losses {[round(x, 4) for x in result['losses']]}")
    log(f"  refresh step {result['refresh_step_s']:.2f} s, of it subspace "
        f"{result['refresh_subspace_s']:.2f} s "
        f"({result['subspace_calls']} batched "
        f"calls, {n_units} units); median steady step "
        f"{result['median_steady_step_ms']:.1f} ms -> "
        f"{result['tokens_per_s']:.1f} tokens/s")
    log(f"  measured launches per steady step: "
        f"{result['launches_per_steady_step']} (want {want_steady})")
    log(f"  max_memory_allocated by step (GiB; -1: the init): "
        + ", ".join(f"{s}: {v:.2f}" for s, v in sorted(peaks.items()))
        + "; allocated as each step starts: "
        + ", ".join(f"{s}: {v:.2f}" for s, v in sorted(held.items())))
    log(f"  max_memory_allocated: steady steps {steady_peak:.2f} GiB, whole "
        f"phase (init and the refresh step too) {phase_peak:.2f} GiB; "
        f"memory_report total {report['total_gb']:.2f} GiB (weights "
        f"{report['weights_gb']:.2f}, optimizer {report['optimizer_gb']:.2f}"
        f", of it projection {report['projection_gb']:.3f})")
    log(f"  the steady-step peak of {steady_peak:.2f} GiB is "
        + ("under" if under else "NOT under")
        + f" {MEMORY_CLAIM_GIB:g} GiB")
    if problems:
        raise AssertionError("training 7b: " + "; ".join(problems))
    del tr
    torch.cuda.empty_cache()
    result.update(rec.check(tcfg.steps, tcfg.steps - 1, seed))
    return result


def check_i8_problems(probs, mult: dict) -> dict:
    """``int8_matmul`` against its plain version at every distinct problem
    of a training run, on the run's own inputs (``i8_tol``), timed beside
    the plain version, cuBLAS bf16 on the weight dequantized beforehand,
    and the bound; with the sums over one step's calls (``mult``)."""
    from repro_torch.core import quant
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    dev = next(iter(probs.values()))[0].device
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rows, failed = [], []
    for (M, K, N, dt), (x, q, scale) in sorted(probs.items(),
                                               key=lambda kv: kv[0][:3]):
        qt = quant.QTensor(q, scale, None, 8, 256, N, "float32")
        abs_err, rel = check_against_plain(x, qt)
        w_lib = quant.dequantize(qt, torch.bfloat16)
        x_lib = x.to(torch.bfloat16)
        row = {"M": M, "K": K, "N": N,
               "x": str(dt).replace("torch.", ""),
               "design": i8_design(M, K, N, dt),
               "ms": time_ms(lambda: ti8.int8_matmul(x, q, scale), flush),
               "plain_ms": time_ms(
                   lambda: ref.int8_matmul_ref(x, q, scale, 256), flush),
               "library_ms": time_ms(lambda: torch.matmul(x_lib, w_lib),
                                     flush),
               "max_abs_err": abs_err, "rel_err": rel,
               "tol": i8_tol(M, K, N, dt),
               "launches_per_step": mult[(M, K, N)]}
        row["bound_ms"], row["bound_by"] = bound(M, K, N, x.element_size())
        row["tflops"] = 2 * M * K * N / row["ms"] / 1e9
        row["factor"] = row["ms"] / row["library_ms"]
        rows.append(row)
        ok = rel <= row["tol"]
        if not ok:
            failed.append(row)
        log(f"  int8_matmul M={M} K={K} N={N} x={row['x']} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"tflops={row['tflops']:.1f} [{row['design']}] "
            f"factor={row['factor']:.2f} rel_err={rel:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        del w_lib, x_lib
    if failed:
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"at 7B problems: {failed}")
    sums = {f: sum(r[f] * r["launches_per_step"] for r in rows)
            for f in ("ms", "plain_ms", "library_ms", "bound_ms")}
    sums["launches_per_step"] = sum(r["launches_per_step"] for r in rows)
    sums["tflops"] = sum(2 * r["M"] * r["K"] * r["N"]
                         * r["launches_per_step"] for r in rows) \
        / sums["ms"] / 1e9
    sums["factor"] = sums["ms"] / sums["library_ms"]
    log("  one training step's int8_matmul calls: " + " ".join(
        f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in sums.items()))
    return {"per_shape": rows, "step_sums": sums}


def profile_train_step(tr) -> dict:
    """Device busy time against the host clock over one more steady step
    (after the counted run). If the profiler fails, its numbers are null
    and the error is kept."""
    from torch.profiler import ProfilerActivity, profile
    step = tr.start_step
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(step + 1)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    except RuntimeError as e:
        log(f"  PROFILER FAILED: {e}")
        return {"profile_step_wall_ms": None, "profile_step_device_ms": None,
                "device_idle_share": None, "profile_error": str(e)}
    rows = device_rows(prof)
    busy_ms = sum(t for _, t, _ in rows) / 1e3
    log(f"  profiled steady step {step}: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {1 - busy_ms / wall_ms:.3f}")
    top = []
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:12]:
        log(f"    device {t / 1e3:9.2f} ms {n:6d} calls  {key[:80]}")
        top.append({"kernel": key[:80], "ms": t / 1e3, "calls": n})
    return {"profile_step_wall_ms": wall_ms, "profile_step_device_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "profile_top": top}


def f32_beside(g: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """``g`` in float32 with each value moved by up to 2^-8 of itself: bits
    below bf16's precision, so that ``lo = g - bf16(g)`` is not zero and
    a two-pass kernel that drops it shows an error far above ``F32_X_TOL``."""
    g = g.float()
    u = torch.rand(g.shape, generator=gen, device=g.device) * 2 - 1
    return g + g * u * 2 ** -8


FUSED_DESIGN = "mma.sync bf16 x2 (dir hi + lo), INT4 P read packed"
STRESS_QUANTA = 256


def plain_direction(args, count, kw) -> torch.Tensor:
    """The plain version's Adam direction (``ref.fused_qgalore_update_ref``'s
    arithmetic)."""
    from repro_torch.core.adam8bit import bias_correction
    g, m, v = (t.float() for t in args[:3])
    b1, b2 = kw["beta1"], kw["beta2"]
    m_hat = (b1 * m + (1.0 - b1) * g) / bias_correction(b1, count)
    v_hat = (b2 * v + (1.0 - b2) * (g * g)) / bias_correction(b2, count)
    return m_hat / (torch.sqrt(v_hat) + kw["eps"])


def plain_from_dir(dirn, args, lr, kw) -> tuple:
    """The plain version's back-projection, step and SR requantization on a
    given direction (the tail of ``ref.fused_qgalore_update_ref``, op for
    op): the codes, and ``dir @ P^T`` (right) or ``P @ dir`` (left)."""
    from repro_torch.core.quant import true_div
    _, _, _, pq, ps, pz, q, ws, u01 = args
    pb, wb = kw["pblock"], kw["wblock"]
    u4 = torch.stack([(pq & 0xF).float(), ((pq >> 4) & 0xF).float()],
                     dim=-1).reshape(pq.shape[0], -1) - 8.0
    d, r = u4.shape
    P = ((u4.reshape(d, r // pb, pb) - pz[..., None])
         * ps[..., None]).reshape(d, r)
    bp = dirn @ P.T if kw["side"] == "right" else P @ dirn
    upd = kw["gscale"] * bp
    R, C = q.shape
    w = (q.float().reshape(R, C // wb, wb) * ws[..., None]).reshape(R, C)
    if kw["wd"]:
        upd = upd + kw["wd"] * w
    wn = (w - lr * upd).reshape(R, C // wb, wb)
    scale = torch.clamp_min(true_div(wn.abs().amax(dim=-1), 127.0), 1e-12)
    codes = torch.floor(wn / scale[..., None] + u01.reshape(R, C // wb, wb))
    return torch.clamp(codes, -128, 127).reshape(R, C).to(torch.int8), bp


def fused_gate(M, N, args, count, lr, kw) -> dict:
    """The kernel against the plain version on the same inputs: the
    dequantized weight within one INT8 quantum (the plain version's largest
    new scale), codes equal on more than 0.999 of the elements, scales and
    moments within 1e-5 relative."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import fused_update as tfu
    qk, sk, mk, vk = tfu.fused_qgalore_update(*args, count, lr, **kw)
    qp, sp, mp, vp = ref.fused_qgalore_update_ref(*args, count, lr, **kw)
    deq = lambda q_, s_: (q_.float().reshape(M, N // 256, 256)
                          * s_[..., None]).reshape(M, N)
    w_err = (deq(qk, sk) - deq(qp, sp)).abs().max().item()
    quantum = sp.max().item()
    same = (qk == qp).float().mean().item()
    rels = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            .item() for n, a, b in (("scale", sk, sp), ("m", mk, mp),
                                    ("v", vk, vp))}
    ok = (w_err <= quantum + 1e-6 and same > 0.999
          and max(rels.values()) <= 1e-5)
    return {"max_abs_err": w_err, "quantum": quantum, "codes_equal": same,
            "rel_errs": rels, "ok": ok, "plain_codes": qp}


def check_train_kernels(probs_t, probs_f, mult: dict, seed: int) -> dict:
    """Each new kernel against its plain version on the training run's own
    inputs, at every distinct problem it was launched with, then timed at
    those problems (CUDA events, cold L2) beside the plain version, one
    library call where there is one, and the bound. ``mult``: per kernel,
    the launches of each problem in one training step (the sums).

    ``int8_matmul_t`` is held to ``F32_X_TOL`` on both inputs: the run's
    bf16 g (each product of a bf16 value and an INT8 code is exact in f32,
    so only the f32 sums round) and the same g with f32 bits below bf16's
    (``f32_beside``; two passes). For the f32 input the error that its bf16
    rounding alone would leave (``hi_only_rel``) is printed beside it and
    must exceed the bar, so the check can tell a dropped second pass."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.kernels import int8_matmul as ti8
    dev = next(iter(probs_t.values()))[0].device
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {"int8_matmul_t": [], "fused_qgalore_update": []}
    failed = []
    for (M, K, N, dt), (g_run, q, scale) in sorted(probs_t.items(),
                                                   key=lambda kv: kv[0][:3]):
        w_lib = quant.dequantize(quant.QTensor(q, scale, None, 8, 256, N,
                                               "float32"), torch.bfloat16)
        g_lib = g_run.to(torch.bfloat16)
        lib_ms = time_ms(lambda: torch.matmul(g_lib, w_lib.T), flush)
        # the run's own g (the path's dtype), then f32 values beside it
        gs = (g_run,) if dt == torch.float32 else (g_run,
                                                   f32_beside(g_run, gen))
        for g in gs:
            got = ti8.int8_matmul_t(g, q, scale)
            want = ref.int8_matmul_t_ref(g, q, scale, 256)
            abs_err = (got - want).abs().max().item()
            peak = max(want.abs().max().item(), 1e-30)
            rel = abs_err / peak
            hi_only = None
            if g.dtype == torch.float32:
                hi_only = (ref.int8_matmul_t_ref(g.to(torch.bfloat16), q,
                                                 scale, 256)
                           - want).abs().max().item() / peak
            row = {"M": M, "K": K, "N": N,
                   "g": str(g.dtype).replace("torch.", ""),
                   "on_path": g.dtype == dt, "design": mma_design(g.dtype),
                   "ms": time_ms(lambda: ti8.int8_matmul_t(g, q, scale),
                                 flush),
                   "plain_ms": time_ms(
                       lambda: ref.int8_matmul_t_ref(g, q, scale, 256),
                       flush),
                   "library_ms": lib_ms, "max_abs_err": abs_err,
                   "rel_err": rel, "hi_only_rel": hi_only}
            row["bound_ms"], row["bound_by"] = bound_t(M, K, N,
                                                       g.element_size())
            row["tflops"] = 2 * M * K * N / row["ms"] / 1e9
            row["factor"] = row["ms"] / lib_ms
            out["int8_matmul_t"].append(row)
            ok = rel <= F32_X_TOL and (hi_only is None
                                       or hi_only > F32_X_TOL)
            if not ok:
                failed.append(("int8_matmul_t", row))
            log(f"  int8_matmul_t M={M} K={K} N={N} g={row['g']} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={row['bound_ms']:.4f} "
                f"({row['bound_by']}) tflops={row['tflops']:.1f} "
                f"[{row['design']}] factor={row['factor']:.2f} "
                f"rel_err={rel:.2e}"
                + ("" if hi_only is None else f" hi_only_rel={hi_only:.2e}")
                + f" {'ok' if ok else 'FAIL'}")
        del w_lib, g_lib
    for (M, N, R, side), (args, (count, lr), kw) in sorted(probs_f.items()):
        gate = fused_gate(M, N, args, count, lr, kw)
        del gate["plain_codes"]
        row = {"M": M, "N": N, "r": R, "side": side, "lr": lr,
               "on_path": True, "design": FUSED_DESIGN,
               "ms": time_ms(lambda: tfu.fused_qgalore_update(
                   *args, count, lr, **kw), flush),
               "plain_ms": time_ms(lambda: ref.fused_qgalore_update_ref(
                   *args, count, lr, **kw), flush),
               "library_ms": None, **gate}
        row["bound_ms"], row["bound_by"] = bound_fused(args)
        row["tflops"] = 2 * M * N * R / row["ms"] / 1e9
        row["x_bound"] = row["ms"] / row["bound_ms"]
        out["fused_qgalore_update"].append(row)
        if not row["ok"]:
            failed.append(("fused_qgalore_update", row))
        log(f"  fused_qgalore_update M={M} N={N} r={R} {side} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"x_bound={row['x_bound']:.2f} tflops={row['tflops']:.1f} "
            f"[{FUSED_DESIGN}] weight err {row['max_abs_err']:.2e} (quantum "
            f"{row['quantum']:.2e}) codes equal {row['codes_equal']:.6f} "
            f"rel {row['rel_errs']} {'ok' if row['ok'] else 'FAIL'}")
    # a stress step per side on the run's inputs: lr * gscale * max|U| is
    # STRESS_QUANTA quanta of the old scale, so the step sets the new
    # scales and the plain version run on bf16(dir) (one pass: no lo) must
    # fall below 0.99 of equal codes while the kernel holds the gate
    for want_side in ("right", "left"):
        (M, N, R, side), (args, (count, _), kw) = next(
            kv for kv in sorted(probs_f.items()) if kv[0][3] == want_side)
        dirn = plain_direction(args, count, kw)
        _, bp = plain_from_dir(dirn, args, 0.0, kw)
        lr_s = STRESS_QUANTA * args[7].max().item() \
            / (kw["gscale"] * bp.abs().max().item())
        gate = fused_gate(M, N, args, count, lr_s, kw)
        hi_codes, _ = plain_from_dir(dirn.to(torch.bfloat16).float(), args,
                                     lr_s, kw)
        hi_only = (hi_codes == gate.pop("plain_codes")).float().mean().item()
        row = {"M": M, "N": N, "r": R, "side": side, "lr": lr_s,
               "on_path": False, "stress_quanta": STRESS_QUANTA,
               "design": FUSED_DESIGN, "ms": None, "plain_ms": None,
               "library_ms": None, "bound_ms": None, "bound_by": None,
               **gate, "hi_only_codes_equal": hi_only}
        row["ok"] = gate["ok"] and hi_only < 0.99
        out["fused_qgalore_update"].append(row)
        if not row["ok"]:
            failed.append(("fused_qgalore_update stress", row))
        log(f"  fused_qgalore_update stress M={M} N={N} r={R} {side} "
            f"lr={lr_s:.4g} ({STRESS_QUANTA} quanta) weight err "
            f"{row['max_abs_err']:.2e} (quantum {row['quantum']:.2e}) codes "
            f"equal {row['codes_equal']:.6f} rel {row['rel_errs']} "
            f"hi_only_codes_equal={hi_only:.6f} "
            f"{'ok' if row['ok'] else 'FAIL'}")
    if failed:
        raise AssertionError(f"training kernels disagree with their plain "
                             f"versions: {failed}")
    # one training step's calls, summed over the problems (int8_matmul_t:
    # the rows in the path's own g dtype)
    sums = {}
    for name, key in (("int8_matmul_t", lambda r: (r["M"], r["K"], r["N"])),
                      ("fused_qgalore_update",
                       lambda r: (r["M"], r["N"], r["r"], r["side"]))):
        per = mult[name]
        rows_ = [r for r in out[name] if r.get("on_path", True)]
        sums[name] = {f: sum(r[f] * per[key(r)] for r in rows_)
                      for f in ("ms", "plain_ms", "bound_ms")}
        sums[name]["library_ms"] = None if name != "int8_matmul_t" else \
            sum(r["library_ms"] * per[key(r)] for r in rows_)
        sums[name]["launches_per_step"] = sum(per[key(r)] for r in rows_)
    t_rows = [r for r in out["int8_matmul_t"] if r["on_path"]]
    flops = sum(2 * r["M"] * r["K"] * r["N"] * mult["int8_matmul_t"][
        (r["M"], r["K"], r["N"])] for r in t_rows)
    sums["int8_matmul_t"]["tflops"] = flops / sums["int8_matmul_t"]["ms"] \
        / 1e9
    sums["int8_matmul_t"]["factor"] = sums["int8_matmul_t"]["ms"] \
        / sums["int8_matmul_t"]["library_ms"]
    f_rows = [r for r in out["fused_qgalore_update"] if r["on_path"]]
    flops = sum(2 * r["M"] * r["N"] * r["r"] * mult["fused_qgalore_update"][
        (r["M"], r["N"], r["r"], r["side"])] for r in f_rows)
    sums["fused_qgalore_update"]["tflops"] = \
        flops / sums["fused_qgalore_update"]["ms"] / 1e9
    for name, s in sums.items():
        log(f"  one training step's {name} calls: "
            + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else
                       f"{k}={v}" for k, v in s.items() if v is not None))
    return {"train_kernels": out, "train_kernel_step_sums": sums}


FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FLASH_DESIGN = {torch.bfloat16: "mma.sync bf16 x1 (FlashAttention-2)",
                torch.float32: "mma.sync bf16 x3 (split hi/lo, "
                               "FlashAttention-2)"}


def flash_hi_only(q, k, v, causal) -> float:
    """The error one bf16 pass would leave in f32 attention: the plain
    arithmetic on bf16-rounded q, k, v and P (the unnormalised
    probabilities, as the kernel feeds them to P V), relative to
    max|plain|."""
    from repro_torch.kernels import ref
    B, S, H, d = q.shape
    G = H // k.shape[2]
    r = lambda t: t.to(torch.bfloat16).float()
    qb, kb, vb = r(q), r(k.repeat_interleave(G, dim=2)), \
        r(v.repeat_interleave(G, dim=2))
    s = torch.einsum("bqhd,bkhd->bhqk", qb, kb) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    e = torch.exp(s - s.amax(-1, keepdim=True))
    got = torch.einsum("bhqk,bkhd->bqhd", r(e), vb) \
        / e.sum(-1).transpose(1, 2)[..., None]
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    return ((got - want).abs().max() / want.abs().max()).item()


def bound_flash(B, S, H, KH, d, dv, causal, itemsize):
    """Least time (ms) of one attention call: q, k, v read once and o
    written once, against the multiply-adds of the score and value
    products over the (query, key) pairs the mask keeps, S(S+1)/2 a head
    when causal, at the bf16 peak."""
    nbytes = B * S * (H * d + KH * (d + dv) + H * dv) * itemsize
    pairs = S * (S + 1) // 2 if causal else S * S
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * B * H * pairs * (d + dv) / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def flash_flops(B, S, H, d, dv, causal) -> int:
    """Useful multiply-adds x 2 of one call: the score and value products
    over the (query, key) pairs the mask keeps."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 2 * B * H * pairs * (d + dv)


def flash_inputs(B, S, H, KH, d, dv, dtype, gen):
    dev = torch.device("cuda")
    return tuple(torch.randn(sh, generator=gen, device=dev).to(dtype)
                 for sh in ((B, S, H, d), (B, S, KH, d), (B, S, KH, dv)))


def flash_row(B, S, H, KH, d, dv, causal, dtype, gen, flush, timed=True):
    """The kernel against its plain version on fresh inputs of one
    problem; with ``timed``, its time beside the plain version's, the
    library call's and the bound."""
    from repro_torch.kernels import flash_attention as tflash
    from repro_torch.kernels import ref
    q, k, v = flash_inputs(B, S, H, KH, d, dv, dtype, gen)
    got = tflash.flash_attention(q, k, v, causal=causal).float()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    abs_err = (got - want).abs().max().item()
    rel = abs_err / max(want.abs().max().item(), 1e-30)
    del got, want
    row = {"B": B, "S": S, "H": H, "KH": KH, "d": d, "dv": dv,
           "causal": causal, "dtype": str(dtype).replace("torch.", ""),
           "design": FLASH_DESIGN[dtype],
           "max_abs_err": abs_err, "rel_err": rel,
           "ok": rel <= FLASH_TOL[dtype]}
    if dtype == torch.float32:
        # the gate must be able to tell a dropped pass
        row["hi_only_rel"] = flash_hi_only(q, k, v, causal)
        row["ok"] = row["ok"] and row["hi_only_rel"] > FLASH_TOL[dtype]
    if timed:
        row["ms"] = time_ms(lambda: tflash.flash_attention(
            q, k, v, causal=causal), flush)
        row["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal), flush)
        # the yardstick: one library call on (B, H, S, d) views of the same
        # tensors (H == KH here), never on the port's path
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["library_ms"] = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal), flush)
        row["bound_ms"], row["bound_by"] = bound_flash(
            B, S, H, KH, d, dv, causal, q.element_size())
        row["tflops"] = flash_flops(B, S, H, d, dv, causal) / row["ms"] / 1e9
    del q, k, v
    return row


def phase_flash_kernels(seed: int):
    """Phase 6a: the flash kernel against its plain version at llama-1b's
    heads (32, d 64), bf16, timed beside the plain version, one
    ``scaled_dot_product_attention`` call and the bound."""
    log("== phase 6a: flash_attention against flash_attention_ref")
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device="cuda")
    probs = [(B, S, 32, 32, 64, 64, True, torch.bfloat16)
             for B in (1, 8) for S in (48, 128, 512, 2048)]
    probs += [(8, 512, 32, 32, 64, 64, False, torch.bfloat16),
              (8, 2048, 32, 32, 64, 64, False, torch.bfloat16),
              (8, 512, 32, 32, 64, 128, True, torch.bfloat16),
              (8, 512, 32, 32, 64, 64, True, torch.float32)]
    rows, failed = [], []
    for p in probs:
        row = flash_row(*p, gen, flush)
        rows.append(row)
        if not row["ok"]:
            failed.append(row)
        log(f"  B={row['B']} S={row['S']:5d} d={row['d']} dv={row['dv']} "
            f"causal={row['causal']!s:5s} {row['dtype']:8s} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']}) tflops="
            f"{row['tflops']:.1f} [{row['design']}] rel_err="
            f"{row['rel_err']:.2e}"
            + (f" hi_only_rel={row['hi_only_rel']:.2e}"
               if "hi_only_rel" in row else "")
            + f" {'ok' if row['ok'] else 'FAIL'}")
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version: {failed}")
    return rows


def check_flash_shapes(shapes, seed: int) -> dict:
    """The flash kernel against its plain version at every distinct
    problem the serving run launched it with, on fresh seeded inputs."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    rows = [flash_row(B, S, H, KH, d, dv, causal, dt, gen, None,
                      timed=False)
            for B, S, H, KH, d, dv, causal, dt in sorted(
                shapes, key=lambda t: t[:2])]
    torch.cuda.empty_cache()
    worst = max(r["rel_err"] for r in rows)
    log(f"  {len(rows)} distinct flash problems of the run ((B, S) in "
        f"{[(r['B'], r['S']) for r in rows]}) against the plain version: "
        f"max rel err {worst:.2e}")
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain "
                             f"version at serving problems: {bad}")
    return {"flash_checked_problems": len(rows),
            "flash_check_max_abs_err": max(r["max_abs_err"] for r in rows),
            "flash_check_max_rel_err": worst}


def bound_bytes(nbytes: int) -> tuple:
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def bound_int4(M, K, R, block, g_itemsize):
    """g read once, packed P and its f32 scales and zeros read once, the
    f32 output written once, against the multiply-adds at the bf16 peak."""
    nbytes = (M * K * g_itemsize + K * R // 2 + 2 * K * (R // block) * 4
              + M * R * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * M * K * R / PEAK_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_unfused(seed: int):
    """Phase 7: the unfused Q-GaLore update (``ops.unfused_qgalore_update``:
    ``int4_project`` → Adam → back-projection → ``sr_requant_update``) for
    llama-1b's right-side weights at rank 512, each kernel held against its
    plain version on the chain's own inputs and timed; ``sr_requant`` and
    ``blockwise_quant`` at all four weight shapes; and ``quantize_int8`` of
    all 169 llama-1b weights against ``core.quant.quantize_blockwise``."""
    from repro_torch.core import projector, quant
    from repro_torch.kernels import LAUNCHES, ops, ref
    from repro_torch.kernels import blockwise_quant as tbq
    from repro_torch.kernels import int4_matmul as ti4
    from repro_torch.kernels import sr_requant as tsr
    log("== phase 7: the unfused update and the quantizer at llama-1b's "
        "shapes")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    rank, lr, kw = 512, 1e-3, dict(gscale=0.25)
    layers = num_layers()
    probs = {}
    for m, n in ((2048, 2048), (5461, 2048)):
        qt = quant.quantize_blockwise(
            torch.randn((m, n), generator=gen, device=dev) * 0.02, 8,
            symmetric=True)
        P = torch.linalg.qr(torch.randn((n, rank), generator=gen,
                                        device=dev))[0]
        qp = projector.quantize_projection(P, 4, 256)
        grad = torch.randn((m, n), generator=gen, device=dev) * 1e-2
        m32 = torch.randn((m, rank), generator=gen, device=dev) * 1e-3
        v32 = (torch.randn((m, rank), generator=gen, device=dev)
               * 1e-4).abs()
        u01 = torch.rand(qt.q.shape, generator=gen, device=dev)
        probs[m, n] = (qt, qp, grad, m32, v32, u01)

    # the path: one chain per weight, counted; the sr_requant inputs kept
    sr_args, k_sr = {}, tsr.sr_requant

    def rec_sr(q, scale, update, u01, block=256):
        sr_args[tuple(q.shape)] = (q, scale, update.clone(), u01)
        return k_sr(q, scale, update, u01, block)

    tsr.sr_requant = rec_sr
    torch.cuda.synchronize()
    LAUNCHES.clear()
    try:
        for qt, qp, grad, m32, v32, u01 in probs.values():
            new, m_new, v_new = ops.unfused_qgalore_update(
                qt, grad, m32, v32, qp, 1, lr, u01, **kw)
        torch.cuda.synchronize()
    finally:
        tsr.sr_requant = k_sr
    chain_counts = dict(LAUNCHES)
    log(f"  unfused chain at {list(probs)}: launches {chain_counts}")
    want = {"int4_matmul": len(probs), "sr_requant": len(probs)}
    if chain_counts != want:
        raise AssertionError(f"unfused chain launches {chain_counts} != "
                             f"{want}")
    if not (torch.isfinite(m_new).all() and torch.isfinite(v_new).all()
            and torch.isfinite(new.scale).all()):
        raise AssertionError("unfused chain: non-finite outputs")

    failed, i4_rows, chain_rows = [], [], []
    for (m, n), (qt, qp, grad, m32, v32, u01) in probs.items():
        p_deq = projector.maybe_dequantize(qp)
        R = qp.q.shape[1] * 2
        # the chain's own f32 gradient, then the same in bf16; each beside
        # one cuBLAS call in its dtype on a P dequantized beforehand
        for g in (grad, grad.to(torch.bfloat16)):
            got = ti4.int4_matmul(g, qp.q, qp.scale, qp.zero, qp.block)
            want_ = ref.int4_matmul_ref(g, qp.q, qp.scale, qp.zero, qp.block)
            abs_err = (got - want_).abs().max().item()
            rel = abs_err / max(want_.abs().max().item(), 1e-30)
            p_lib = p_deq.to(g.dtype)
            row = {"M": m, "K": n, "R": R,
                   "g": str(g.dtype).replace("torch.", ""),
                   "on_path": g.dtype == grad.dtype,
                   "design": mma_design(g.dtype),
                   "ms": time_ms(lambda: ti4.int4_matmul(
                       g, qp.q, qp.scale, qp.zero, qp.block), flush),
                   "plain_ms": time_ms(lambda: ref.int4_matmul_ref(
                       g, qp.q, qp.scale, qp.zero, qp.block), flush),
                   "library_ms": time_ms(lambda: torch.matmul(g, p_lib),
                                         flush),
                   "max_abs_err": abs_err, "rel_err": rel}
            row["bound_ms"], row["bound_by"] = bound_int4(
                m, n, R, qp.block, g.element_size())
            row["tflops"] = 2 * m * n * R / row["ms"] / 1e9
            row["factor"] = row["ms"] / row["library_ms"]
            i4_rows.append(row)
            ok = rel <= (F32_X_TOL if g.dtype == torch.float32 else TOL)
            if not ok:
                failed.append(("int4_matmul", row))
            log(f"  int4_matmul M={m} K={n} R={R} g={row['g']} "
                f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                f"library_ms={row['library_ms']:.4f} bound_ms="
                f"{row['bound_ms']:.4f} ({row['bound_by']}) tflops="
                f"{row['tflops']:.1f} [{row['design']}] factor="
                f"{row['factor']:.2f} rel_err={rel:.2e} "
                f"{'ok' if ok else 'FAIL'}")
            del p_lib
        # the unfused chain beside the fused path of the same step (the
        # reference's fused-vs-unfused ratio, benchmarks/kernels_bench.py):
        # project through the dequantized P, then the fused kernel
        low = projector.project(grad, p_deq, "right")
        unf = time_ms(lambda: ops.unfused_qgalore_update(
            qt, grad, m32, v32, qp, 1, lr, u01, **kw), flush)
        fused_kernel = time_ms(lambda: ops.fused_qgalore_update(
            qt, low, m32, v32, qp, 1, lr, u01, side="right", gscale=0.25),
            flush)
        fused = time_ms(lambda: ops.fused_qgalore_update(
            qt, projector.project(grad, p_deq, "right"), m32, v32, qp, 1,
            lr, u01, side="right", gscale=0.25), flush)
        chain_rows.append({"M": m, "N": n, "r": rank, "unfused_ms": unf,
                           "fused_ms": fused,
                           "fused_kernel_ms": fused_kernel,
                           "unfused_over_fused": unf / fused})
        log(f"  chain M={m} N={n} r={rank}: unfused {unf:.4f} ms, fused "
            f"(projection + kernel) {fused:.4f} ms, fused kernel alone "
            f"{fused_kernel:.4f} ms; unfused / fused {unf / fused:.2f}")
        del low, p_deq

    # sr_requant: the chain's own inputs, then the other two weight shapes
    sr_rows = []
    shapes = [(2048, 2048), (5461, 2048), (2048, 5461), (2048, 32000)]
    for m, n in shapes:
        qt = probs[m, n][0] if (m, n) in probs else None
        if qt is not None:
            q, scale, update, u01 = sr_args[tuple(qt.q.shape)]
        else:
            qt = quant.quantize_blockwise(
                torch.randn((m, n), generator=gen, device=dev) * 0.02, 8,
                symmetric=True)
            q, scale = qt.q, qt.scale
            update = torch.randn(q.shape, generator=gen, device=dev) * 1e-5
            u01 = torch.rand(q.shape, generator=gen, device=dev)
        qk, sk = tsr.sr_requant(q, scale, update, u01)
        qw, sw = ref.sr_requant_ref(q, scale, update, u01, 256)
        same = torch.equal(qk, qw)
        s_rel = ((sk - sw).abs().max() / sw.abs().max()).item()
        w_err = (qk.float() * sk.repeat_interleave(256, dim=1)
                 - qw.float() * sw.repeat_interleave(256, dim=1)
                 ).abs().max().item()
        row = {"R": q.shape[0], "C": q.shape[1], "n_real": n,
               "on_path": (m, n) in probs,
               "ms": time_ms(lambda: tsr.sr_requant(q, scale, update, u01),
                             flush),
               "plain_ms": time_ms(lambda: ref.sr_requant_ref(
                   q, scale, update, u01, 256), flush),
               "library_ms": None, "codes_equal": same,
               "scale_rel_err": s_rel, "max_abs_err": w_err}
        row["bound_ms"], row["bound_by"] = bound_bytes(
            2 * q.numel() + 2 * scale.numel() * 4 + 2 * q.numel() * 4)
        sr_rows.append(row)
        ok = same and s_rel <= 1e-6
        if not ok:
            failed.append(("sr_requant", row))
        log(f"  sr_requant R={row['R']} C={row['C']} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f}"
            f" codes equal {same} scale rel {s_rel:.2e} "
            f"{'ok' if ok else 'FAIL'}")
    del probs, sr_args
    torch.cuda.empty_cache()

    # quantize_int8 of every llama-1b weight (24 layers x 7 + the head),
    # drawn one at a time, against core.quant.quantize_blockwise
    per_layer = [(2048, 2048)] * 4 + [(2048, 5461)] * 2 + [(5461, 2048)]
    weights = per_layer * layers + [(2048, 32000)]
    torch.cuda.synchronize()
    LAUNCHES.clear()
    mismatched = []
    for i, (K, N) in enumerate(weights):
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        got = ops.quantize_int8(w)
        want_ = quant.quantize_blockwise(w, 8, symmetric=True)
        if not (torch.equal(got.q, want_.q)
                and torch.equal(got.scale, want_.scale)
                and got.orig_last == want_.orig_last):
            mismatched.append((i, K, N))
    torch.cuda.synchronize()
    quant_counts = {n: c for n, c in LAUNCHES.items() if c}
    log(f"  quantize_int8 of {len(weights)} llama-1b weights: launches "
        f"{quant_counts}; {len(mismatched)} differ from quantize_blockwise")
    if mismatched or quant_counts.get("blockwise_quant") != len(weights):
        failed.append(("quantize_int8", {"mismatched": mismatched,
                                         "launches": quant_counts}))
    bq_rows = []
    for K, N in sorted(set(weights)):
        w = torch.randn((K, N), generator=gen, device=dev) * 0.02
        x = torch.nn.functional.pad(w, (0, -N % 256))
        qk, sk = tbq.blockwise_quant(x)
        qw, sw = ref.blockwise_quant_ref(x, 256)
        same = torch.equal(qk, qw) and torch.equal(sk, sw)
        row = {"R": K, "C": x.shape[1], "n_real": N,
               "launches": weights.count((K, N)),
               "ms": time_ms(lambda: tbq.blockwise_quant(x), flush),
               "plain_ms": time_ms(lambda: ref.blockwise_quant_ref(x, 256),
                                   flush),
               "library_ms": None, "bit_exact": same, "max_abs_err": 0.0
               if same else float("nan")}
        row["bound_ms"], row["bound_by"] = bound_bytes(
            x.numel() * 5 + sk.numel() * 4)
        bq_rows.append(row)
        if not same:
            failed.append(("blockwise_quant", row))
        log(f"  blockwise_quant R={K} C={row['C']} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f}"
            f" bit exact {same}")
        del w, x
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"phase 7 kernels disagree with their plain "
                             f"versions: {failed}")
    return {"chain_launches": chain_counts, "quant_launches": quant_counts,
            "int4_matmul": i4_rows, "chain": chain_rows,
            "sr_requant": sr_rows, "blockwise_quant": bq_rows}


def chain_vs_executor(tr, seed: int) -> dict:
    """One more step from ``tr``'s trained state on the same clipped
    low-rank gradients through ``transform.qgalore_transform`` (the fused
    kernel) and ``transform.qgalore_reference_chain`` (plain PyTorch
    stages), with the same uniforms: every tuned INT8 weight within one
    quantum (the executor's largest new scale of the leaf), the reference's
    statement of the two."""
    from repro_torch.core import qgalore, quant, transform
    from repro_torch.kernels import LAUNCHES
    from repro_torch.train import stack
    from repro_torch.train import step as step_lib
    params, opt = tr.state
    specs, rules = tr.specs, tr.rules
    keys = [k for k, _ in qgalore.flatten(params)]
    trees = qgalore.unflatten(keys, opt.proj)
    _, grads = stack.fused_value_and_grad(tr.bundle, params,
                                          tr.batches(tr.tcfg.steps), trees)
    grads, _ = transform.clip_by_global_norm(grads, tr.tcfg.grad_clip,
                                             specs=specs)
    draw = step_lib.generator_uniforms(seed + 99, "cuda")
    uni = lambda leaf, layer, shape: draw(0, leaf, layer, shape)
    lr = tr.tcfg.learning_rate
    LAUNCHES.clear()
    p_ex, _, _ = transform.qgalore_transform(rules, specs).update(
        grads, opt, params, lr=lr, uniforms=uni)
    torch.cuda.synchronize()
    n_ex = dict(LAUNCHES)
    LAUNCHES.clear()
    p_ch, _, _ = transform.qgalore_reference_chain(rules).update(
        grads, transform.chain_state(opt), params, lr=lr, uniforms=uni,
        specs=specs)
    torch.cuda.synchronize()
    n_ch = dict(LAUNCHES)
    n_units = sum(s.nbatch for s in specs if s.galore)
    equal = total = 0
    worst, worst_path = 0.0, None
    ok = n_ex.get("fused_qgalore_update", 0) == n_units and not any(
        n_ch.values())
    for (_, a), (_, b), spec in zip(qgalore.flatten(p_ex),
                                    qgalore.flatten(p_ch), specs):
        if spec.frozen or not isinstance(a, quant.QTensor):
            continue
        equal += int((a.q == b.q).sum())
        total += a.q.numel()
        quantum = a.scale.max().item()
        err = (quant.dequantize(a, torch.float32)
               - quant.dequantize(b, torch.float32)).abs().max().item()
        ok = ok and err <= quantum + 1e-6
        if err / quantum > worst:
            worst, worst_path = err / quantum, spec.path
    out = {"codes_equal": equal / total, "max_quanta": worst,
           "max_quanta_leaf": worst_path, "lr": lr,
           "executor_launches": n_ex, "chain_launches": n_ch, "ok": ok}
    log(f"  one step from the trained state, chain against executor (lr "
        f"{lr:g}): INT8 codes equal {out['codes_equal']:.6f} of {total}; "
        f"largest difference {worst:.4f} quanta ({worst_path}); executor "
        f"launches {n_ex}, chain launches {n_ch} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"fine-tune: chain against executor: {out}")
    return out


def phase_finetune_cli(seed: int) -> dict:
    """Phase 9a: ``launch.finetune.main`` with its default flags (llama-60m
    at its published widths and depth, rank 8, the first layer frozen, 8
    steps of 4 x 32 tokens) on the card; then one step of the chain
    against the executor from the trained state."""
    import contextlib
    import io
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import finetune
    log("== phase 9a: the fine-tune CLI at llama-60m (8 layers, d 512, "
        "rank 8, 1 frozen layer, 8 steps of 4 x 32 tokens)")
    out_dir = Path(__file__).resolve().parent / "build"
    out_dir.mkdir(exist_ok=True)
    out = out_dir / "finetune_memory.json"
    trainers, cls = [], finetune.Trainer

    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            trainers.append(self)

    finetune.Trainer = Recording
    text = io.StringIO()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        with contextlib.redirect_stdout(text):
            rc = finetune.main(["--out", str(out)])
    finally:
        finetune.Trainer = cls
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = dict(LAUNCHES)
    report = json.loads(out.read_text())
    log(f"  {text.getvalue().strip().splitlines()[-1]} ({wall:.2f} s)")
    log(f"  report: groups {report['groups']}, first loss "
        f"{report['first_loss']:.4f}, final loss {report['final_loss']:.4f}"
        f", SVDs {report['svd_used']}; launches {counts}")
    problems = []
    if rc != 0:
        problems.append(f"main returned {rc}")
    if report["qgalore_leq_qlora"] is not True:
        problems.append("qgalore_leq_qlora is not true")
    missing = [n for n in TRAIN_KERNELS if not counts.get(n)]
    plain = {n: counts[n] for n in PLAIN_NAMES if counts.get(n)}
    if missing:
        problems.append(f"kernels not launched: {missing}")
    if plain:
        problems.append(f"plain versions ran on the card: {plain}")
    if problems:
        raise AssertionError("fine-tune CLI: " + "; ".join(problems))
    chain = chain_vs_executor(trainers[0], seed)
    del trainers
    torch.cuda.empty_cache()
    return {"report": report, "wall_s": wall, "launches": counts,
            "chain_vs_executor": chain}


FT_7B_STEPS = 4           # steps 0 and 2 refresh at update_interval 2
FT_7B_RANK = 8


def phase_finetune_7b(seed: int) -> dict:
    """Phase 9b: LLaMA-7B fine-tuning at full width and depth, split after
    the first layer, under ``launch.finetune``'s rule-set at rank 8 (the
    randomized subspace method), 8 x 256 tokens a step, 4 steps. The four
    contracts through ``launch.finetune``'s functions, the steps, memory
    and launches, then every distinct kernel problem against its plain
    version (phase 8's checks)."""
    from repro_torch.config import QGaLoreConfig, TrainConfig
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import finetune
    from repro_torch.models import model_zoo
    from repro_torch.train.trainer import Trainer
    log(f"== phase 9b: LLaMA-7B fine-tuning (32 layers, layer 0 and the "
        f"embedding, final norm and head frozen, rank {FT_7B_RANK}, "
        f"randomized subspace, 8 x 256 tokens)")
    cfg = model_zoo.get_config("llama-7b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16,
                             split_layers=1)
    rules = finetune.build_finetune_rules(
        QGaLoreConfig(rank=FT_7B_RANK, min_dim=128, update_interval=2,
                      subspace_method="randomized"), FT_7B_RANK)
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256,
                       steps=FT_7B_STEPS, learning_rate=1e-3,
                       warmup_steps=max(FT_7B_STEPS // 10, 1), grad_clip=1.0,
                       log_every=0)
    card = nvidia_smi_line()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, rules, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    specs = tr.specs
    frozen = finetune.check_frozen_stateless(specs, tr.state.opt)
    finetune.check_group_ranks(specs, FT_7B_RANK)
    frozen_before = finetune.frozen_weights(tr.state.params, specs)
    n_units = sum(s.nbatch for s in specs if s.galore)
    log(f"  init on the card: {init_s:.2f} s; {len(frozen)} frozen leaves, "
        f"{n_units} tuned GaLore units; device memory before the phase "
        f"{before:.2f} GiB")

    rec = ProblemRecorder()
    peaks = {}

    def at_step(step):
        peaks[step - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        rec.step = step

    LAUNCHES.clear()
    with rec:
        rows = run_counted(tr, tcfg.steps, TRAIN_KERNELS + PLAIN_NAMES,
                           at_step)
    counts = dict(LAUNCHES)
    peaks[tcfg.steps - 1] = torch.cuda.max_memory_allocated() / 2 ** 30
    finetune.check_frozen_unchanged(frozen_before, tr.state.params, specs)
    del frozen_before
    mem = finetune.memory_vs_qlora(tr.state.params, rules, FT_7B_RANK,
                                   specs=specs)
    finetune.check_memory_leq_qlora(mem, FT_7B_RANK)
    refresh = sorted(s for s in rec.sub_s if s >= 0)
    steady = [r for r in rows if r["step"] not in refresh]
    micro = 7 * cfg.num_layers + 1           # dense calls a forward
    want_steady = {"int8_matmul": 2 * micro - 1, "int8_matmul_t": micro,
                   "fused_qgalore_update": n_units}
    if not refresh or refresh[0] != 0 or not steady:
        raise AssertionError(f"fine-tune 7b: refresh steps {refresh}, want "
                             "step 0 and at least one steady step")
    problems = []
    for r in rows:
        want = dict(want_steady, **({"fused_qgalore_update": 0}
                                    if r["step"] in refresh else {}))
        got = {n: r["launches"][n] for n in want}
        if got != want:
            problems.append(f"step {r['step']} launches {got} != {want}")
        plain = {n: r["launches"][n] for n in PLAIN_NAMES
                 if r["launches"][n]}
        if plain:
            problems.append(f"step {r['step']} ran plain versions {plain}")
        if not np.isfinite(r["loss"]):
            problems.append(f"step {r['step']} loss {r['loss']}")
    steady_s = [r["s"] for r in steady]
    tokens = tcfg.global_batch * tcfg.seq_len
    steady_peak = max(peaks[r["step"]] for r in steady)
    result = {
        "steps": tcfg.steps, "rank": FT_7B_RANK, "split_layers": 1,
        "subspace_method": "randomized", "update_interval": 2,
        "tuned_units": n_units, "frozen_leaves": len(frozen),
        "init_s": init_s, "losses": [r["loss"] for r in rows],
        "refresh_steps": refresh,
        "refresh_step_s": {str(r["step"]): r["s"] for r in rows
                           if r["step"] in refresh},
        "refresh_subspace_s": {str(s): rec.sub_s[s] for s in refresh},
        "median_steady_step_ms": statistics.median(steady_s) * 1e3,
        "tokens_per_s": tokens / statistics.median(steady_s),
        "steady_peak_gib": steady_peak, "phase_peak_gib": max(peaks.values()),
        "peak_gib_by_step": {str(k): v for k, v in sorted(peaks.items())},
        "held_before_phase_gib": before, "memory": mem, "card": card,
        "launches": counts,
        "launches_per_steady_step": steady[-1]["launches"]}
    log(f"  losses {[round(x, 4) for x in result['losses']]}; refresh "
        f"steps {refresh}: " + ", ".join(
            f"step {s} {result['refresh_step_s'][str(s)]:.2f} s (subspace "
            f"{rec.sub_s[s]:.2f} s)" for s in refresh)
        + f"; median steady step {result['median_steady_step_ms']:.1f} ms "
        f"-> {result['tokens_per_s']:.1f} tokens/s [{card}]")
    log(f"  measured launches per steady step: "
        f"{result['launches_per_steady_step']} (want {want_steady}) "
        f"[{card}]")
    log("  max_memory_allocated by step (GiB; -1: the init): "
        + ", ".join(f"{s}: {v:.2f}" for s, v in sorted(peaks.items()))
        + f"; steady peak {steady_peak:.2f}, phase peak "
        f"{result['phase_peak_gib']:.2f} [{card}]")
    log(f"  memory_report (GiB): Q-GaLore weights "
        f"{mem['qgalore']['weights_gb']:.4f} + optimizer "
        f"{mem['qgalore']['optimizer_gb']:.4f} = "
        f"{mem['qgalore']['total_gb']:.4f}; QLoRA at rank {FT_7B_RANK}: "
        f"weights {mem['qlora']['weights_gb']:.4f} + adapters and moments "
        f"{mem['qlora']['adapter_plus_opt_gb']:.4f} = "
        f"{mem['qlora']['total_gb']:.4f}; the four contracts hold "
        f"[{card}]")
    if problems:
        raise AssertionError("fine-tune 7b: " + "; ".join(problems))
    del tr
    torch.cuda.empty_cache()
    log(f"  the phase's kernel problems against their plain versions, on "
        f"[{card}]:")
    result.update(rec.check(tcfg.steps, len(steady), seed))
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    # plain versions and library calls in full float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    phase_environment()
    rows, step, step_by, max_abs, max_rel = phase_kernels(args.seed)
    serving = phase_serving(args.seed)
    parity = phase_parity(args.seed)
    training = phase_training(args.seed)
    flash_rows = phase_flash_kernels(args.seed)
    flash_serving = phase_serving(args.seed, flash=True)
    flash_parity = phase_parity(args.seed, flash=True)
    unfused = phase_unfused(args.seed)
    training_7b = phase_training_7b(args.seed)
    finetune = {"cli": phase_finetune_cli(args.seed),
                "llama_7b": phase_finetune_7b(args.seed)}
    log(f"  serving, route off / flash route: tokens/s "
        f"{serving['tokens_per_s']:.1f} / {flash_serving['tokens_per_s']:.1f}"
        f", mean TTFT {serving['mean_ttft_s']:.3f} / "
        f"{flash_serving['mean_ttft_s']:.3f} s, median decode step "
        f"{serving['median_decode_step_ms']:.2f} / "
        f"{flash_serving['median_decode_step_ms']:.2f} ms, the "
        f"{serving['stats']['prefills']} prefills "
        f"{serving['prefill_ms_total']:.1f} / "
        f"{flash_serving['prefill_ms_total']:.1f} ms, launches a prefill "
        f"int8_matmul {7 * num_layers() + 1} / {7 * num_layers() + 1}, "
        f"flash_attention 0 / {num_layers()}")
    log(f"== all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps(kernels_json(rows, step, step_by, max_abs, max_rel,
                                  serving, parity, training, flash_rows,
                                  flash_serving, flash_parity, unfused,
                                  training_7b, finetune)))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_json(rows, step, step_by, max_abs, max_rel, serving, parity,
                 training, flash_rows, flash_serving, flash_parity,
                 unfused, training_7b, finetune) -> dict:
    """The ``kernels`` line: every kernel with its launches on the main
    paths, errors against its plain version, and times beside its bound;
    the three training kernels also carry their LLaMA-7B rows
    (``llama_7b``: per-shape rows and one steady step's sums) and their
    LLaMA-7B fine-tune rows at rank 8 (``llama_7b_finetune``)."""
    layers = num_layers()
    flash_pick, flash_f32 = (
        next(r for r in flash_rows if (r["B"], r["S"], r["dv"], r["causal"],
                                       r["dtype"]) == (8, 512, 64, True, dt))
        for dt in ("bfloat16", "float32"))

    def total(rs, mult, keys=("ms", "plain_ms", "bound_ms", "library_ms")):
        return {k: None if any(r[k] is None for r in rs)
                else sum(r[k] * n for r, n in zip(rs, mult)) for k in keys}

    chain_i4 = [r for r in unfused["int4_matmul"] if r["on_path"]]
    chain_sr = [r for r in unfused["sr_requant"] if r["on_path"]]
    bq = unfused["blockwise_quant"]
    # a training step's int8_matmul calls at M = 8 x 256, bf16 x: the
    # forward (7 a layer and the head) and the recompute (7 a layer)
    pick = {(r["K"], r["n_real"]): r for r in rows
            if r["M"] == 2048 and r["x"] == "bfloat16"}
    fwd = {(2048, 2048): 8 * layers, (2048, 5461): 4 * layers,
           (5461, 2048): 2 * layers, (2048, 32000): 1}
    train_step = {k: sum(pick[s][k] * n for s, n in fwd.items())
                  for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
    tl = training["launches"]
    tk = training["train_kernels"]
    sums = training["train_kernel_step_sums"]
    l7 = training_7b["launches"]
    tk7 = training_7b["train_kernels"]
    sums7 = training_7b["train_kernel_step_sums"]
    i8_7b = training_7b["int8_matmul"]
    ft_cli, ft7 = finetune["cli"], finetune["llama_7b"]
    lc, lf = ft_cli["launches"], ft7["launches"]
    tkf, sumsf, i8f = ft7["train_kernels"], ft7["train_kernel_step_sums"], \
        ft7["int8_matmul"]

    def ft_paths(name):
        return {"finetune_cli": lc.get(name, 0),
                "finetune_7b": lf.get(name, 0)}

    def by(rs):
        return "bytes" if all(r["bound_by"] == "bytes" for r in rs) \
            else "operations"

    kernels = {"kernels": [{
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:85",
        "launches": serving["launches"].get("int8_matmul", 0)
        + tl.get("int8_matmul", 0) + l7.get("int8_matmul", 0)
        + sum(ft_paths("int8_matmul").values()),
        "launches_by_path": {"serving": serving["launches"].get(
            "int8_matmul", 0), "training": tl.get("int8_matmul", 0),
            "training_7b": l7.get("int8_matmul", 0),
            **ft_paths("int8_matmul")},
        "max_abs_err": max([max_abs, serving["check_max_abs_err"]]
                           + [r["max_abs_err"]
                              for r in i8_7b["per_shape"]
                              + i8f["per_shape"]]),
        "max_rel_err": max(max_rel, serving["check_max_rel_err"]),
        "max_rel_err_7b": max(r["rel_err"] for r in i8_7b["per_shape"]
                              + i8f["per_shape"]),
        "llama_7b_finetune": dict(i8f, timed_as=(
            "the int8_matmul calls of one LLaMA-7B fine-tune step at "
            "M = 2048 (8 x 256, accum 1), bf16 x, sum of per-shape medians "
            "x launches")),
        "llama_7b": dict(i8_7b, timed_as=(
            "the int8_matmul calls of one LLaMA-7B steady step at M = 1024 "
            "(4 x 256 a microbatch, accum 2), bf16 x, sum of per-shape "
            "medians x launches")),
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step_by,
        "library_ms": step["library_ms"],
        "timed_as": f"the {7 * layers + 1} matmuls of one decode "
                    "step at 8 slots, bf16 x, sum of per-shape medians "
                    "(each launch after an L2 flush)",
        "decode_step_sequence": dict(step["sequence"], timed_as=(
            f"the {7 * layers + 1} matmuls of one decode step at 8 slots, "
            "bf16 x, each on its own resident weight, back to back between "
            "one pair of events; library: cuBLAS bf16 on the same weights "
            "dequantized")),
        "training_step": dict(
            train_step, factor=train_step["ms"] / train_step["library_ms"],
            design=i8_design(2048, 2048, 2048, torch.bfloat16), timed_as=(
                f"the {14 * layers + 1} matmuls of one training step at "
                "M = 2048, bf16 x, sum of phase 2's per-shape medians")),
        "design": {"M <= 16, both dtypes": i8_design(1, 2048, 2048,
                                                     torch.bfloat16),
                   "M > 16, bf16 x": i8_design(2048, 2048, 2048,
                                               torch.bfloat16),
                   "M > 16, f32 x": i8_design(2048, 2048, 2048,
                                              torch.float32)},
        "serving": {k: serving[k] for k in (
            "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
            "prefill_ms_total", "median_prefill_ms",
            "peak_gib", "launches_per_step", "checked_problems",
            "profile_step_wall_ms", "profile_step_device_ms",
            "device_idle_share", "profile_error") if k in serving},
        "path_parity_rel_err": parity,
        "per_shape": rows}, {
        "name": "int8_matmul_t", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul_t.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:141",
        "launches": tl.get("int8_matmul_t", 0)
        + l7.get("int8_matmul_t", 0)
        + sum(ft_paths("int8_matmul_t").values()),
        "launches_by_path": {"training": tl.get("int8_matmul_t", 0),
                             "training_7b": l7.get("int8_matmul_t", 0),
                             **ft_paths("int8_matmul_t")},
        "max_abs_err": max(r["max_abs_err"] for r in tk["int8_matmul_t"]
                           + tk7["int8_matmul_t"] + tkf["int8_matmul_t"]),
        "max_rel_err": max(r["rel_err"] for r in tk["int8_matmul_t"]
                           + tk7["int8_matmul_t"] + tkf["int8_matmul_t"]),
        "llama_7b_finetune": {"step_sums": sumsf["int8_matmul_t"],
                              "per_shape": tkf["int8_matmul_t"],
                              "timed_as": "the dL/dx calls of one LLaMA-7B "
                                          "fine-tune step at M = 2048, bf16 "
                                          "g, sum of per-shape medians x "
                                          "launches"},
        "llama_7b": {"step_sums": sums7["int8_matmul_t"],
                     "per_shape": tk7["int8_matmul_t"],
                     "timed_as": "the dL/dx calls of one LLaMA-7B step at "
                                 "M = 1024, bf16 g, sum of per-shape "
                                 "medians x launches"},
        **sums["int8_matmul_t"], "bound_by": by(tk["int8_matmul_t"]),
        "design": {"bf16 g": mma_design(torch.bfloat16),
                   "f32 g": mma_design(torch.float32)},
        "library_call": "torch.matmul(g, W.T), bf16, on a weight "
                        "dequantized beforehand",
        "timed_as": f"the {7 * layers + 1} dL/dx calls of one training "
                    "step at M = 2048, bf16 g (as the path hands it over), "
                    "sum of per-shape medians",
        "per_shape": tk["int8_matmul_t"]}, {
        "name": "fused_qgalore_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/fused_update.py:234",
        "launches": tl.get("fused_qgalore_update", 0)
        + l7.get("fused_qgalore_update", 0)
        + sum(ft_paths("fused_qgalore_update").values()),
        "launches_by_path": {"training": tl.get("fused_qgalore_update", 0),
                             "training_7b": l7.get("fused_qgalore_update",
                                                   0),
                             **ft_paths("fused_qgalore_update")},
        "max_abs_err": max(r["max_abs_err"]
                           for r in tk["fused_qgalore_update"]
                           + tk7["fused_qgalore_update"]
                           + tkf["fused_qgalore_update"]
                           if r["on_path"]),
        "llama_7b_finetune": {"step_sums": sumsf["fused_qgalore_update"],
                              "per_shape": tkf["fused_qgalore_update"],
                              "timed_as": "the updates of one LLaMA-7B "
                                          "fine-tune steady step, rank 8, "
                                          "sum of per-shape medians x "
                                          "launches"},
        "chain_vs_executor": ft_cli["chain_vs_executor"],
        "llama_7b": {"step_sums": sums7["fused_qgalore_update"],
                     "per_shape": tk7["fused_qgalore_update"],
                     "timed_as": "the updates of one LLaMA-7B steady step, "
                                 "rank 1024, sum of per-shape medians x "
                                 "launches"},
        **sums["fused_qgalore_update"],
        "bound_by": by([r for r in tk["fused_qgalore_update"]
                        if r["on_path"]]),
        "design": FUSED_DESIGN,
        "stress": [{k: r[k] for k in ("M", "N", "side", "lr", "codes_equal",
                                      "hi_only_codes_equal", "ok")}
                   for r in tk["fused_qgalore_update"] if not r["on_path"]],
        "library_note": "no single PyTorch call computes the fused update",
        "timed_as": f"the {7 * layers + 1} updates of one steady "
                    "training step, rank 512, sum of per-shape medians",
        "per_shape": tk["fused_qgalore_update"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:77",
        "launches": flash_serving["launches"].get("flash_attention", 0),
        "launches_by_path": {"serving_flash_route": flash_serving[
            "launches"].get("flash_attention", 0)},
        "max_abs_err": max([r["max_abs_err"] for r in flash_rows]
                           + [flash_serving["flash_check_max_abs_err"]]),
        "max_rel_err": max([r["rel_err"] for r in flash_rows]
                           + [flash_serving["flash_check_max_rel_err"]]),
        **{k: flash_pick[k] * layers for k in ("ms", "plain_ms",
                                               "bound_ms", "library_ms")},
        "factor": flash_pick["ms"] / flash_pick["library_ms"],
        "bound_by": flash_pick["bound_by"],
        "design": {"bfloat16": FLASH_DESIGN[torch.bfloat16],
                   "float32": FLASH_DESIGN[torch.float32]},
        "float32": {k: flash_f32[k] for k in (
            "B", "S", "H", "d", "dv", "causal", "ms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "tflops", "rel_err",
            "hi_only_rel")},
        "library_call": "torch.nn.functional.scaled_dot_product_attention"
                        "(is_causal=True) on the same bf16 tensors",
        "timed_as": f"the {layers} calls of one prefill at B 8, S 512, "
                    "H 32, d 64, causal bf16: 24 x the per-call median",
        "serving": {k: flash_serving[k] for k in (
            "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
            "prefill_ms_total", "median_prefill_ms", "peak_gib",
            "launches_per_prefill", "flash_checked_problems")},
        "serving_route_off": {k: serving[k] for k in (
            "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
            "prefill_ms_total", "median_prefill_ms")},
        "path_parity_rel_err": flash_parity,
        "per_shape": flash_rows}, {
        "name": "int4_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int4_matmul.cu",
        "replaces": "src/repro/kernels/int4_matmul.py:60",
        "launches": unfused["chain_launches"].get("int4_matmul", 0),
        "launches_by_path": {"unfused_update": unfused[
            "chain_launches"].get("int4_matmul", 0)},
        "max_abs_err": max(r["max_abs_err"] for r in unfused["int4_matmul"]),
        "max_rel_err": max(r["rel_err"] for r in unfused["int4_matmul"]),
        **total(chain_i4, [1] * len(chain_i4)),
        "bound_by": by(chain_i4),
        "tflops": sum(2 * r["M"] * r["K"] * r["R"] for r in chain_i4)
        / sum(r["ms"] for r in chain_i4) / 1e9,
        "factor": sum(r["ms"] for r in chain_i4)
        / sum(r["library_ms"] for r in chain_i4),
        "design": {"bf16 g": mma_design(torch.bfloat16),
                   "f32 g": mma_design(torch.float32)},
        "library_call": "torch.matmul(g, P) on a P dequantized beforehand, "
                        "f32",
        "timed_as": "the projections of one unfused step of the 2048 x 2048 "
                    "and 5461 x 2048 weights at rank 512, f32 g, sum of "
                    "per-shape medians",
        "chain": unfused["chain"],
        "per_shape": unfused["int4_matmul"]}, {
        "name": "sr_requant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sr_requant.cu",
        "replaces": "src/repro/kernels/sr_requant.py:53",
        "launches": unfused["chain_launches"].get("sr_requant", 0),
        "launches_by_path": {"unfused_update": unfused[
            "chain_launches"].get("sr_requant", 0)},
        "max_abs_err": max(r["max_abs_err"] for r in unfused["sr_requant"]),
        "max_scale_rel_err": max(r["scale_rel_err"]
                                 for r in unfused["sr_requant"]),
        "codes_equal": all(r["codes_equal"] for r in unfused["sr_requant"]),
        **total(chain_sr, [1] * len(chain_sr)),
        "bound_by": "bytes",
        "library_note": "no single PyTorch call computes the SR requant",
        "timed_as": "the requantizations of one unfused step of the "
                    "2048 x 2048 and 5461 x 2048 weights, sum of per-shape "
                    "medians",
        "per_shape": unfused["sr_requant"]}, {
        "name": "blockwise_quant", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/blockwise_quant.cu",
        "replaces": "src/repro/kernels/blockwise_quant.py:37",
        "launches": unfused["quant_launches"].get("blockwise_quant", 0),
        "launches_by_path": {"quantize_int8": unfused[
            "quant_launches"].get("blockwise_quant", 0)},
        "max_abs_err": max(r["max_abs_err"] for r in bq),
        "bit_exact": all(r["bit_exact"] for r in bq),
        **total(bq, [r["launches"] for r in bq]),
        "bound_by": "bytes",
        "library_note": "no single PyTorch call computes the block-wise "
                        "quantization",
        "timed_as": f"quantize_int8 of the {sum(r['launches'] for r in bq)}"
                    " llama-1b weights, sum of per-shape medians x launches",
        "per_shape": bq}],
        "training": {k: training[k] for k in (
            "losses", "refresh_step_s", "refresh_svd_s", "svd_calls",
            "svd_units", "median_steady_step_ms", "tokens_per_s",
            "peak_gib", "launches_per_steady_step", "profile_step_wall_ms",
            "profile_step_device_ms", "device_idle_share", "profile_error",
            "profile_top", "checkpoint_save_s", "checkpoint_restore_s",
            "resume_steps", "resume_max_rel_diff") if k in training},
        "training_7b": {k: v for k, v in training_7b.items()
                        if k not in ("int8_matmul", "train_kernels",
                                     "train_kernel_step_sums")},
        "finetune": {"cli": {k: ft_cli[k] for k in (
            "report", "wall_s", "launches", "chain_vs_executor")},
            "llama_7b": {k: v for k, v in ft7.items()
                         if k not in ("int8_matmul", "train_kernels",
                                      "train_kernel_step_sums")}}}
    return kernels


if __name__ == "__main__":
    sys.exit(main())
