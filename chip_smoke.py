#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, is right, serves and
trains.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. Environment: card name and power limit, torch / CUDA / nvcc versions,
   and the build of every kernel source (one ``nvcc`` each, in parallel).
2. Every kernel against its plain PyTorch version on the card, at the
   llama-1b (K, N) problems, M in {1, 4, 8, 64, 2048}, x in f32 and bf16:
   pass if ``max|kernel - plain| / max|plain| <= 2e-2``. Times (CUDA
   events, median of 20 launches, L2 flushed before each), the plain
   version's and one library call's times, and the bound.
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
   run's own inputs (``int8_matmul_t``: 2e-2 of max|plain|; the fused
   update: codes within one INT8 quantum, scales and moments within 1e-5)
   and timed beside it.

The last three lines are the kernels JSON, the ``nvidia-smi`` name and
power limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the repository's ``src/`` beside it, the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core rate
TOL = 2e-2
KN = [(2048, 2048), (2048, 5461), (5461, 2048), (2048, 32000)]
MS = [1, 4, 8, 64, 2048]


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
                row = {"M": M, "K": K, "N": N, "n_real": N0,
                       "x": str(dt).replace("torch.", ""), "ms": ms,
                       "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "rel_err": rel}
                rows.append(row)
                ok = rel <= TOL
                if not ok:
                    failed.append(row)
                log(f"  M={M:5d} K={K:5d} N={N:6d} x={row['x']:8s} "
                    f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
                    f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                    f"rel_err={rel:.2e} {'ok' if ok else 'FAIL'}")
                del x, x_lib
        del qt, w_lib
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"int8_matmul disagrees with its plain version "
                             f"on {len(failed)} problem(s): {failed}")
    log(f"  {len(rows)} problems agree: max rel err {max_rel:.2e} "
        f"<= tolerance {TOL}")
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
    log(f"  decode step (M=8, bf16, {7 * layers + 1} calls): "
        + " ".join(f"{k}={v:.4f}" for k, v in step.items()))
    return rows, step, step_by, max_abs, max_rel


def phase_serving(seed: int):
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.models import model_zoo
    from repro_torch.serve.params import quantize_leaf
    from repro_torch.serve.scheduler import Request, Scheduler
    log("== phase 3: llama-1b serving through the slot scheduler")
    cfg = model_zoo.get_config("llama-1b")
    bundle = model_zoo.build(cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = bundle.init_params(gen, leaf_fn=quantize_leaf)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    t0 = time.monotonic()
    try:
        comps = sched.run(reqs)
        torch.cuda.synchronize()
    finally:
        ti8.int8_matmul = kernel
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
    if counts.get("int8_matmul_ref", 0) or counts.get("deq_matmul", 0):
        problems.append(f"plain versions ran on the main path: {counts}")
    n_tok = sum(len(c.tokens) for c in comps)
    result = {"tokens_per_s": n_tok / wall, "wall_s": wall,
              "tokens": n_tok,
              "mean_ttft_s": float(np.mean([c.ttft for c in comps])),
              "median_decode_step_ms": statistics.median(step_ms),
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "stats": st, "launches": counts,
              "launches_per_step": launched / max(calls, 1)}
    log(f"  {n_req} requests, {slots} slots: {n_tok} tokens in {wall:.2f} s"
        f" -> {result['tokens_per_s']:.1f} tok/s; mean TTFT "
        f"{result['mean_ttft_s']:.3f} s; median decode step "
        f"{result['median_decode_step_ms']:.2f} ms; peak "
        f"{result['peak_gib']:.2f} GiB; stats {st}; launches {counts}")
    if problems:
        raise AssertionError("serving: " + "; ".join(problems))
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
            if rel > TOL:
                failed.append((M, K, N, str(dt), rel))
        del qt
    torch.cuda.empty_cache()
    ms = sorted({s[0] for s in shapes})
    log(f"  {len(shapes)} distinct launch problems of the run (M in "
        f"{ms}) against the plain version: max rel err {max_rel:.2e}, "
        f"tolerance {TOL}")
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


def phase_parity(seed: int):
    from repro_torch.config import replace
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import model_zoo
    from repro_torch.serve import engine
    from repro_torch.serve.params import quantize_leaf
    log("== phase 4: path parity, card (kernel) against CPU (plain)")
    cfg = replace(model_zoo.get_config("llama-1b"), num_layers=2)
    gpu = model_zoo.build(cfg, device="cuda", dtype=torch.float32)
    cpu = model_zoo.build(cfg, device="cpu", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    p_gpu = gpu.init_params(gen, leaf_fn=quantize_leaf)

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
    tcfg = TrainConfig(seed=seed, global_batch=8, seq_len=256, steps=6,
                       learning_rate=1e-3, warmup_steps=2, grad_clip=1.0,
                       log_every=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    tr = Trainer(bundle, tcfg, qcfg)
    torch.cuda.synchronize()
    n_units = sum(s.nbatch for s in tr.specs if s.galore)
    log(f"  init (weights, INT8, random-orthonormal INT4 P for {n_units} "
        f"GaLore units) on the card: {time.monotonic() - t0:.2f} s")

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
    rows, names = [], ("int8_matmul", "int8_matmul_t",
                       "fused_qgalore_update", "int8_matmul_ref",
                       "int8_matmul_t_ref", "fused_qgalore_update_ref",
                       "deq_matmul", "deq_matmul_t")
    LAUNCHES.clear()
    try:
        for s in range(tcfg.steps):
            before = Counter(LAUNCHES)
            torch.cuda.synchronize()
            t = time.perf_counter()
            row = tr.run(s + 1)[-1]
            torch.cuda.synchronize()
            row = {"step": s, "loss": row["loss"],
                   "grad_norm": row["grad_norm"],
                   "s": time.perf_counter() - t,
                   "launches": {n: LAUNCHES[n] - before[n] for n in names}}
            rows.append(row)
            log(f"  step {s}: loss {row['loss']:.4f} grad_norm "
                f"{row['grad_norm']:.4f} {row['s']:.3f} s launches "
                f"{row['launches']}")
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
    result.update(profile_train_step(tr))
    del tr
    torch.cuda.empty_cache()
    # launches of each problem in one step: int8_matmul_t runs at every
    # step, the fused update at the steady ones
    mult = {"int8_matmul_t": {}, "fused_qgalore_update": {}}
    for (kind, key), n in calls.items():
        if kind == "t":
            mult["int8_matmul_t"][key[:3]] = n // tcfg.steps
        else:
            mult["fused_qgalore_update"][key] = n // (tcfg.steps - 1)
    result.update(check_train_kernels(probs_t, probs_f, mult))
    return result


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


def check_train_kernels(probs_t, probs_f, mult: dict) -> dict:
    """Each new kernel against its plain version on the training run's own
    inputs, at every distinct problem it was launched with, then timed at
    those problems (CUDA events, cold L2) beside the plain version, one
    library call where there is one, and the bound. ``mult``: per kernel,
    the launches of each problem in one training step (the sums)."""
    from repro_torch.core import quant
    from repro_torch.kernels import ref
    from repro_torch.kernels import fused_update as tfu
    from repro_torch.kernels import int8_matmul as ti8
    dev = next(iter(probs_t.values()))[0].device
    flush = torch.empty(128 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {"int8_matmul_t": [], "fused_qgalore_update": []}
    failed = []
    for (M, K, N, dt), (g, q, scale) in sorted(probs_t.items(),
                                               key=lambda kv: kv[0][:3]):
        got = ti8.int8_matmul_t(g, q, scale)
        want = ref.int8_matmul_t_ref(g, q, scale, 256)
        abs_err = (got - want).abs().max().item()
        rel = abs_err / max(want.abs().max().item(), 1e-30)
        w_lib = quant.dequantize(quant.QTensor(q, scale, None, 8, 256, N,
                                               "float32"), torch.bfloat16)
        g_lib = g.to(torch.bfloat16)
        row = {"M": M, "K": K, "N": N, "g": str(dt).replace("torch.", ""),
               "ms": time_ms(lambda: ti8.int8_matmul_t(g, q, scale), flush),
               "plain_ms": time_ms(
                   lambda: ref.int8_matmul_t_ref(g, q, scale, 256), flush),
               "library_ms": time_ms(lambda: torch.matmul(g_lib, w_lib.T),
                                     flush),
               "max_abs_err": abs_err, "rel_err": rel}
        row["bound_ms"], row["bound_by"] = bound_t(M, K, N, g.element_size())
        out["int8_matmul_t"].append(row)
        ok = rel <= TOL
        if not ok:
            failed.append(("int8_matmul_t", row))
        log(f"  int8_matmul_t M={M} K={K} N={N} g={row['g']} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} bound_ms="
            f"{row['bound_ms']:.4f} ({row['bound_by']}) rel_err={rel:.2e} "
            f"{'ok' if ok else 'FAIL'}")
        del w_lib, g_lib
    for (M, N, R, side), (args, (count, lr), kw) in sorted(probs_f.items()):
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
        row = {"M": M, "N": N, "r": R, "side": side,
               "ms": time_ms(lambda: tfu.fused_qgalore_update(
                   *args, count, lr, **kw), flush),
               "plain_ms": time_ms(lambda: ref.fused_qgalore_update_ref(
                   *args, count, lr, **kw), flush),
               "library_ms": None, "max_abs_err": w_err,
               "quantum": quantum, "codes_equal": same, "rel_errs": rels}
        row["bound_ms"], row["bound_by"] = bound_fused(args)
        out["fused_qgalore_update"].append(row)
        ok = (w_err <= quantum + 1e-6 and same > 0.999
              and max(rels.values()) <= 1e-5)
        if not ok:
            failed.append(("fused_qgalore_update", row))
        log(f"  fused_qgalore_update M={M} N={N} r={R} {side} "
            f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"weight err {w_err:.2e} (quantum {quantum:.2e}) codes equal "
            f"{same:.6f} rel {rels} {'ok' if ok else 'FAIL'}")
    if failed:
        raise AssertionError(f"training kernels disagree with their plain "
                             f"versions: {failed}")
    # one training step's calls, summed over the problems
    sums = {}
    for name, key in (("int8_matmul_t", lambda r: (r["M"], r["K"], r["N"])),
                      ("fused_qgalore_update",
                       lambda r: (r["M"], r["N"], r["r"], r["side"]))):
        per = mult[name]
        sums[name] = {f: sum(r[f] * per[key(r)] for r in out[name])
                      for f in ("ms", "plain_ms", "bound_ms")}
        sums[name]["library_ms"] = None if name != "int8_matmul_t" else \
            sum(r["library_ms"] * per[key(r)] for r in out[name])
        sums[name]["launches_per_step"] = sum(per[key(r)] for r in out[name])
    for name, s in sums.items():
        log(f"  one training step's {name} calls: "
            + " ".join(f"{k}={v:.3f}" for k, v in s.items()
                       if v is not None))
    return {"train_kernels": out, "train_kernel_step_sums": sums}


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
    log(f"== all phases passed in {time.monotonic() - t0:.1f} s")
    print(json.dumps(kernels_json(rows, step, step_by, max_abs, max_rel,
                                  serving, parity, training)))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_json(rows, step, step_by, max_abs, max_rel, serving, parity,
                 training) -> dict:
    """The ``kernels`` line: every kernel with its launches on the main
    paths, errors against its plain version, and times beside its bound."""
    layers = num_layers()
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

    def by(rs):
        return "bytes" if all(r["bound_by"] == "bytes" for r in rs) \
            else "operations"

    kernels = {"kernels": [{
        "name": "int8_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:85",
        "launches": serving["launches"].get("int8_matmul", 0)
        + tl.get("int8_matmul", 0),
        "launches_by_path": {"serving": serving["launches"].get(
            "int8_matmul", 0), "training": tl.get("int8_matmul", 0)},
        "max_abs_err": max(max_abs, serving["check_max_abs_err"]),
        "max_rel_err": max(max_rel, serving["check_max_rel_err"]),
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step_by,
        "library_ms": step["library_ms"],
        "timed_as": f"the {7 * layers + 1} matmuls of one decode "
                    "step at 8 slots, bf16 x, sum of per-shape medians",
        "training_step": dict(train_step, timed_as=(
            f"the {14 * layers + 1} matmuls of one training step at "
            "M = 2048, bf16 x, sum of phase 2's per-shape medians")),
        "serving": {k: serving[k] for k in (
            "tokens_per_s", "mean_ttft_s", "median_decode_step_ms",
            "peak_gib", "launches_per_step", "checked_problems",
            "profile_step_wall_ms", "profile_step_device_ms",
            "device_idle_share", "profile_error") if k in serving},
        "path_parity_rel_err": parity,
        "per_shape": rows}, {
        "name": "int8_matmul_t", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul_t.cu",
        "replaces": "src/repro/kernels/int8_matmul.py:141",
        "launches": tl.get("int8_matmul_t", 0),
        "max_abs_err": max(r["max_abs_err"] for r in tk["int8_matmul_t"]),
        "max_rel_err": max(r["rel_err"] for r in tk["int8_matmul_t"]),
        **sums["int8_matmul_t"], "bound_by": by(tk["int8_matmul_t"]),
        "timed_as": f"the {7 * layers + 1} dL/dx calls of one training "
                    "step at M = 2048, f32 g, sum of per-shape medians",
        "per_shape": tk["int8_matmul_t"]}, {
        "name": "fused_qgalore_update", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_update.cu",
        "replaces": "src/repro/kernels/fused_update.py:234",
        "launches": tl.get("fused_qgalore_update", 0),
        "max_abs_err": max(r["max_abs_err"]
                           for r in tk["fused_qgalore_update"]),
        **sums["fused_qgalore_update"],
        "bound_by": by(tk["fused_qgalore_update"]),
        "library_note": "no single PyTorch call computes the fused update",
        "timed_as": f"the {7 * layers + 1} updates of one steady "
                    "training step, rank 512, sum of per-shape medians",
        "per_shape": tk["fused_qgalore_update"]}],
        "training": {k: training[k] for k in (
            "losses", "refresh_step_s", "refresh_svd_s", "svd_calls",
            "svd_units", "median_steady_step_ms", "tokens_per_s",
            "peak_gib", "launches_per_steady_step", "profile_step_wall_ms",
            "profile_step_device_ms", "device_idle_share", "profile_error",
            "profile_top") if k in training}}
    return kernels


if __name__ == "__main__":
    sys.exit(main())
