"""Per-op counters of the port's kernel wrappers: the counterpart of
``repro/kernels/profile.py``.

Inside ``with recording():`` every wrapper of ``kernels/ops.py`` counts
each call it makes under an op name, with the HBM bytes and FLOPs one
such call moves and does. Where the reference records a site, the port
keeps its name and its count: ``int8_matmul``, ``quantized_dense/fwd``,
``quantized_dense/dx``, ``int4_project`` and ``fused_qgalore_update``.
The other sites count what ``chip_smoke.py``'s bounds count:
``quantized_dense_batched/fwd`` and ``/dx``, ``flash_attention``,
``sr_requant_update`` and ``quantize_int8``.

There is no environment switch. Outside ``recording()`` nothing is
counted and a wrapper pays one flag test. The eager port sees every call
(the reference sees one trace), so a row holds:

* ``calls``;
* ``bytes_per_call``, ``flops_per_call`` and ``meta`` of the last call;
* ``bytes`` and ``flops`` summed over the calls;
* ``kernel``: the ``kernels.LAUNCHES`` name of what the call ran (the
  kernel on a CUDA tensor, its plain version on a CPU one);
* ``peak``: the work type whose rate bounds its operations
  (``analysis.roofline.PEAKS``);
* ``wall_us`` and ``wall_calls`` from :func:`timed`.

The counts are functions here (``*_cost``, ``*_bytes``), so that a record
and a bound computed from a problem's shapes use one formula. Two of the
reference's counts are kept as it takes them, for parity, though they are
not what the kernel moves or does: ``quantized_dense/dx`` counts g as
(M, K) and the output as (M, N), the forward's roles (``repro/kernels/
ops.py:212``), where :func:`int8_matmul_t_cost` counts g (M, N) and the
output (M, K); and ``fused_qgalore_update`` counts ``4 m n r`` FLOPs,
where the kernel's back-projection does ``2 m n r``.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, Optional, Tuple

from repro_torch.kernels.int8_matmul import GROUP

# the device functions each kernel launches, as the profiler names them;
# ``splitk::reduce`` is the ordered second pass of int8_matmul's (and
# int4_matmul's) split contraction
DEVICE_FUNCTIONS = {
    "int8_matmul": ("i8mm_small", "i8mm_mma", "splitk::reduce"),
    "int8_matmul_t": ("i8mm_t_mma",),
    "fused_qgalore_update": ("qgl_adam_right", "qgl_adam_left",
                             "qgl_update"),
    "flash_attention": ("flash_mma", "flash_f32"),
    "int4_matmul": ("i4mm_mma",),
    "sr_requant": ("sr_requant_kernel",),
    "blockwise_quant": ("blockwise_quant_kernel",),
}

_ACTIVE = 0


def _new_row() -> Dict[str, Any]:
    return {"calls": 0, "bytes_per_call": 0, "flops_per_call": 0,
            "bytes": 0, "flops": 0, "kernel": None, "peak": None,
            "wall_us": 0.0, "wall_calls": 0}


_COUNTS: Dict[str, Dict[str, Any]] = defaultdict(_new_row)


def enabled() -> bool:
    """Whether a :func:`recording` is open."""
    return _ACTIVE > 0


@contextlib.contextmanager
def recording():
    """Count the wrappers' calls made inside the block (nests)."""
    global _ACTIVE
    _ACTIVE += 1
    try:
        yield
    finally:
        _ACTIVE -= 1


def record(op: str, *, nbytes: int = 0, flops: int = 0,
           kernel: Optional[str] = None, peak: Optional[str] = "bf16",
           meta: Optional[Dict[str, Any]] = None) -> None:
    """Count one call of ``op`` that moves ``nbytes`` and does ``flops``
    and ran ``kernel``. A no-op outside :func:`recording`."""
    if not _ACTIVE:
        return
    row = _COUNTS[op]
    row["calls"] += 1
    row["bytes_per_call"] = int(nbytes)
    row["flops_per_call"] = int(flops)
    row["bytes"] += int(nbytes)
    row["flops"] += int(flops)
    row["kernel"] = kernel
    row["peak"] = peak if flops else None
    if meta:
        row["meta"] = dict(meta)


@contextlib.contextmanager
def timed(name: str):
    """Wall-clock accumulator for a host-side region, inside a
    :func:`recording`."""
    if not _ACTIVE:
        yield
        return
    t0 = time.monotonic()
    try:
        yield
    finally:
        row = _COUNTS[name]
        row["wall_us"] += (time.monotonic() - t0) * 1e6
        row["wall_calls"] += 1


def reset() -> None:
    _COUNTS.clear()


def snapshot() -> Dict[str, Dict[str, Any]]:
    return {op: dict(row) for op, row in sorted(_COUNTS.items())}


def dump(path: str) -> None:
    with open(path, "w") as f:
        json.dump({"enabled": enabled(), "ops": snapshot()}, f, indent=2)


def maybe_attach(report: Dict[str, Any]) -> None:
    """Attach the snapshot to a report dict (in place) when anything was
    recorded since the last :func:`reset`; no key is added otherwise."""
    if _COUNTS:
        report["profile"] = snapshot()


def launches_by_kernel(snap: Dict[str, Dict[str, Any]]) -> Dict[str, int]:
    """The rows' calls summed by the kernel they ran: what
    ``kernels.LAUNCHES`` counted over the recording."""
    out: Dict[str, int] = defaultdict(int)
    for row in snap.values():
        if row["kernel"] is not None:
            out[row["kernel"]] += row["calls"]
    return dict(out)


def device_ms(rows: Iterable[Tuple[str, float, int]]) -> Dict[str, float]:
    """Device milliseconds by kernel from the profiler's ``(device
    function name, device us, calls)`` rows (``DEVICE_FUNCTIONS``); the
    expert-batched launches run the same device functions, so they fall
    under the 2-D kernel's name."""
    out: Dict[str, float] = defaultdict(float)
    for name, us, _ in rows:
        for kernel, funcs in DEVICE_FUNCTIONS.items():
            if any(f in name for f in funcs):
                out[kernel] += us / 1e3
                break
    return dict(out)


# ---------------------------------------------------------------------------
# Counts: (FLOPs, HBM bytes) of one call, in ``roofline.kernel_bound``'s
# order; each input read once and each output written once; 1 multiply-add
# = 2 FLOPs
# ---------------------------------------------------------------------------

def int8_matmul_cost(M: int, K: int, N: int, x_itemsize: int,
                     block: int = GROUP) -> Tuple[int, int]:
    """``x (M, K) @ deq(q (K, N))``: x, the codes and their f32 scales
    read, the f32 (M, N) output written (``repro/kernels/ops.py:129``
    ``_i8_bytes``)."""
    return (2 * M * K * N,
            M * K * x_itemsize + K * N + K * (N // block) * 4 + M * N * 4)


def int8_matmul_t_cost(M: int, K: int, N: int, g_itemsize: int,
                       block: int = GROUP) -> Tuple[int, int]:
    """``g (M, N) @ deq(q (K, N))^T``: g, the codes and scales read, the
    f32 (M, K) output written."""
    return (2 * M * K * N,
            M * N * g_itemsize + K * N + K * (N // block) * 4 + M * K * 4)


def batched_cost(E: int, M: int, K: int, N: int, itemsize: int,
                 transposed: bool = False, block: int = GROUP
                 ) -> Tuple[int, int]:
    """E problems of :func:`int8_matmul_cost` (or, ``transposed``, of
    :func:`int8_matmul_t_cost`) in one launch."""
    one = (int8_matmul_t_cost if transposed else int8_matmul_cost)(
        M, K, N, itemsize, block)
    return E * one[0], E * one[1]


def fused_update_bytes(low: int, pq: int, ps: int, q: int, ws: int,
                       u01: int) -> int:
    """One fused update from element counts: the low-rank triple (f32
    ``low``, m, v), packed P (``pq`` bytes) with its f32 scales and zeros
    (``ps`` each), the codes and scales, the f32 uniforms read; codes,
    scales, m' and v' written (``repro/kernels/ops.py:558``)."""
    return (3 * low * 4 + pq + 2 * ps * 4 + 2 * (q + ws * 4) + u01 * 4
            + 2 * low * 4)


def flash_cost(B: int, S: int, H: int, KH: int, d: int, dv: int,
               causal: bool, itemsize: int) -> Tuple[int, int]:
    """One attention call: q, k, v read and o written once; the score and
    value products over the (query, key) pairs the mask keeps, S(S+1)/2 a
    head when causal."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return (2 * B * H * pairs * (d + dv),
            B * S * (H * d + KH * (d + dv) + H * dv) * itemsize)


def int4_matmul_cost(M: int, K: int, R: int, block: int, g_itemsize: int,
                     r_out: Optional[int] = None) -> Tuple[int, int]:
    """``g (M, K) @ deq_int4(P (K, R))`` → ``(M, r_out)`` f32 (``r_out``:
    the real rank, R the packed one): g, packed P and its f32 scales and
    zeros read, the output written (``repro/kernels/ops.py:415``)."""
    r_out = R if r_out is None else r_out
    return (2 * M * K * r_out, M * K * g_itemsize + K * R // 2
            + 2 * K * (R // block) * 4 + M * r_out * 4)


def sr_requant_bytes(R: int, C: int, block: int = GROUP) -> int:
    """``SR_quant(deq(W) + u)`` of an (R, C) weight: the codes and scales
    read and written, the f32 update and uniforms read."""
    return 2 * R * C + 2 * R * (C // block) * 4 + 2 * R * C * 4


def blockwise_quant_bytes(R: int, C: int, block: int = GROUP) -> int:
    """INT8 blocks of an (R, C) f32 tensor: x read, codes and f32 scales
    written."""
    return R * C * 5 + R * (C // block) * 4
