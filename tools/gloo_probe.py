"""Which collectives gloo runs on CUDA tensors, and how fast: two ranks on
``cuda:0`` (NCCL refuses two ranks a card), each collective the port's
``distributed/comm.py`` uses tried on CUDA tensors (the all-to-all of
expert parallelism among them, in float32 and bfloat16, and the max and
min all-reduce and bfloat16 sum of the vocab-parallel loss and the
tensor-parallel layers), then a 16 MB float32 all-reduce and all-to-all
timed on CUDA and on host tensors (five calls after one warm-up). Prints the Python, torch and CUDA versions, one JSON object by
rank, and the card's name and power limit.

    python3 tools/gloo_probe.py
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def worker(rank, world, path, q):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=world, rank=rank)
    res = {}
    dev = "cuda:0"

    def attempt(name, fn):
        try:
            r = fn()
            torch.cuda.synchronize()
            res[name] = "ok " + str(r)
        except Exception as e:   # noqa: BLE001 — the probe's finding
            res[name] = f"ERR {type(e).__name__}: {str(e)[:200]}"

    x = torch.full((4, 3), float(rank + 1), device=dev)
    attempt("all_reduce", lambda: (dist.all_reduce(x), x[0, 0].item())[1])

    def rs():
        out = torch.empty(2, 3, device=dev)
        dist.reduce_scatter_tensor(
            out, torch.full((4, 3), float(rank + 1), device=dev))
        return out[0, 0].item()
    attempt("reduce_scatter_tensor", rs)

    def ag():
        out = torch.empty(8, 3, device=dev)
        dist.all_gather_into_tensor(
            out, torch.full((4, 3), float(rank + 1), device=dev))
        return out[:, 0].tolist()
    attempt("all_gather_into_tensor", ag)

    def a2a(dtype):
        def run():
            src = torch.arange(4, device=dev, dtype=dtype).repeat(3, 1).T \
                + 10 * rank
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src.contiguous())
            return out[:, 0].tolist()
        return run
    attempt("all_to_all_single", a2a(torch.float32))
    attempt("all_to_all_single_bf16", a2a(torch.bfloat16))
    for op in ("MAX", "MIN"):
        y = torch.full((3,), float(rank + 1), device=dev)
        attempt(f"all_reduce_{op.lower()}", lambda y=y, op=op: (
            dist.all_reduce(y, op=getattr(dist.ReduceOp, op)),
            y[0].item())[1])
    z = torch.full((3,), float(rank + 1), device=dev, dtype=torch.bfloat16)
    attempt("all_reduce_bf16", lambda: (dist.all_reduce(z), z[0].item())[1])
    attempt("barrier", lambda: dist.barrier())
    for kind, fn in (("allreduce", lambda t: dist.all_reduce(t)),
                     ("all_to_all", lambda t: dist.all_to_all_single(
                         torch.empty_like(t), t))):
        for where, t in (("cuda", torch.ones(4 * 2**20, device=dev)),
                         ("host", torch.ones(4 * 2**20))):
            fn(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                fn(t)
            torch.cuda.synchronize()
            res[f"{kind}_16MB_{where}_ms"] = \
                (time.perf_counter() - t0) / 5 * 1e3
    q.put((rank, res))
    dist.destroy_process_group()


def main() -> int:
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    path = os.path.join(tempfile.mkdtemp(), "store")
    procs = [ctx.Process(target=worker, args=(r, 2, path, q))
             for r in range(2)]
    for p in procs:
        p.start()
    out = dict(q.get(timeout=300) for _ in procs)
    for p in procs:
        p.join()
    print(json.dumps(out, indent=1))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if all(p.exitcode == 0 for p in procs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
