#!/usr/bin/env python3
"""Probe of the port's decode-step matmuls on one NVIDIA GPU.

    PYTHONPATH=<tree>/src python3 tools/decode_probe.py [--timeline]

Times one llama-1b decode step's 169 ``int8_matmul`` calls (M 8, bf16 x)
back to back on resident weights, beside cuBLAS bf16 on the same weights
dequantized (``chip_smoke.decode_sequence``), through the ``repro_torch``
that ``PYTHONPATH`` names: point it at a checkout of another commit (with
its own ``build/``) to compare two versions of the kernel in one run.

``--timeline`` also builds an instrumented copy of that tree's
``csrc/int8_matmul.cu`` into its ``build/`` (a ``%globaltimer`` stamp at
each phase of the small-M kernel, by the first thread of each block) and
prints, for the last call of a run of calls at each llama-1b shape, when
each phase of its blocks ended, in microseconds from the first block's
start. The phases are those of the cluster design: the codes and scales
issued, x * s staged, the ring consumed, the cluster barrier passed, the
partials pushed, the block's share received, the output written.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (its helpers import repro_torch from PYTHONPATH)

# (text in the kernel, phase, stamp before the text rather than after it)
MARKS = [
    ("  const int split = blockIdx.x;                 // the block's rank in its cluster\n", 0, True),
    ("  cluster_arrive();                // every block's mbarrier", 1, True),
    ("  if (tid < 8) zero[tid] = __float2bfloat16_rn(0.f);\n", 2, False),
    ("  __syncthreads();                 // the ring is free for the partials\n", 3, False),
    ("  cluster_wait();\n", 4, False),
    ("  // every block's share has arrived: sum it in rank order\n", 5, True),
    ("  cluster_mbar_wait(bar);\n", 6, False),
]
END = ("    *reinterpret_cast<float4*>(out + static_cast<size_t>(m) * N + n0 + c) = sum;\n"
       "  }\n}\n")
PHASES = ["start", "issued", "x*s staged", "ring consumed", "cluster barrier",
          "pushed", "share received", "written"]


def instrumented_library():
    """The tree's int8_matmul.cu with a globaltimer stamp a phase, built
    into its build/ with the same flags; None if the source lacks the
    phases (another design)."""
    from repro_torch.kernels import build
    src = (build.CSRC / "int8_matmul.cu").read_text()
    stamp = ("__device__ unsigned long long g_stamp[8 * 8192];\nnamespace {\n"
             "__device__ __forceinline__ void stamp(int p) { if (threadIdx.x == 0) { "
             "unsigned long long t; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
             "g_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + p] = t; } }\n")
    if any(text not in src for text, _, _ in MARKS) or END not in src:
        return None
    src = src.replace("namespace {\n", stamp, 1)
    for text, p, before in MARKS:
        src = src.replace(text, f"  stamp({p});\n" + text if before else text + f"  stamp({p});\n", 1)
    src = src.replace(END, END[:-2] + "  stamp(7);\n}\n", 1)
    src += ('\nextern "C" int qgl_probe_stamps(void* dst, int n) '
            '{ return (int)cudaMemcpyFromSymbol(dst, g_stamp, n * 8); }\n')
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "int8_matmul_probe.cu"
    cu.write_text(src)
    lib = build.BUILD_DIR / "libint8_matmul_probe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib),
                    str(cu)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def timeline(lib, K: int, N: int, calls: int) -> dict:
    """Phase ends of the last of ``calls`` back-to-back calls at (8, K) x
    (K, N), each on its own weight: min, median and max over its blocks."""
    from repro_torch.kernels import int8_matmul as ti8
    fn = lib.qgl_int8_matmul
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    fn.restype = i
    lib.qgl_probe_stamps.argtypes = [vp, i]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(K + N)
    weights = [(torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8),
                torch.rand((K, N // 256), generator=gen, device=dev) * 2e-4 + 1e-4)
               for _ in range(calls)]
    x = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((8, N), device=dev)
    p = ti8.plan(8, K, N)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        torch.cuda._sleep(50_000_000)
        for q, s in weights:
            err = fn(x.data_ptr(), 1, q.data_ptr(), s.data_ptr(), out.data_ptr(),
                     out.data_ptr(), 8, K, N, p.path, p.m_tile, p.kc, p.splits, stream)
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")
        torch.cuda.synchronize()
    blocks = p.splits * (N // ti8.SMALL_N)
    buf = (ctypes.c_ulonglong * (8 * blocks))()
    lib.qgl_probe_stamps(buf, 8 * blocks)
    t = [[buf[b * 8 + j] for j in range(8)] for b in range(blocks)]
    t0 = min(r[0] for r in t)
    rows = {}
    for j, name in enumerate(PHASES):
        v = sorted((r[j] - t0) / 1e3 for r in t)
        rows[name] = {"min_us": v[0], "median_us": v[len(v) // 2], "max_us": v[-1]}
    return {"K": K, "N": N, "calls": calls, "blocks": blocks, "plan": p._asdict(),
            "phase_end": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timeline", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_probe: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card:", chip_smoke.nvidia_smi_line())
    print("repro_torch:", Path(repro_torch.__file__).resolve().parent)
    result = {"decode_sequence": chip_smoke.decode_sequence(args.seed)}
    if args.timeline:
        lib = instrumented_library()
        if lib is None:
            print("timeline: this tree's kernel has no cluster phases")
        else:
            result["timeline"] = [timeline(lib, K, N, calls) for K, N, calls in (
                (2048, 2048, 96), (2048, 5632, 48), (5461, 2048, 24), (2048, 32000, 1))]
            for r in result["timeline"]:
                print(f"  K={r['K']} N={r['N']} blocks={r['blocks']}: " + "; ".join(
                    f"{k} {v['median_us']:.2f} (max {v['max_us']:.2f})"
                    for k, v in r["phase_end"].items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
