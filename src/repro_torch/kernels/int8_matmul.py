"""Wrappers of the CUDA ``int8_matmul`` and ``int8_matmul_t`` kernels
(``csrc/int8_matmul.cu``, ``csrc/int8_matmul_t.cu``).

``x (M, K) @ deq(q (K, N) int8, scale (K, N/256) f32) → (M, N) f32`` and
its transpose ``g (M, N) @ deq(q)^T → (M, K)`` over the same stored
blocks: the ports of ``repro/kernels/int8_matmul.py``. For a CUDA tensor a
wrapper launches its kernel; for a CPU tensor it runs the plain version
(``ref.int8_matmul_ref``, ``ref.int8_matmul_t_ref``). Neither falls back
from a failed build or launch.

``int8_matmul`` runs on the tensor cores (``mma.sync`` m16n8k16 bf16 →
f32) in two launch designs, chosen by :func:`plan` from M and K. Both
fold the group's scale into the activation, stage ``x * s`` as bf16 and
the raw codes (exact in bf16), and take f32 sums:

* M <= 16 (decode; K up to 8 x 2048): bound by the weight bytes. M is
  padded to one m16 tile and both dtypes take two passes (``hi = bf16(x
  * s)``, ``lo = bf16(x * s - hi)``), which keeps decode within ~2^-16
  of the f32 product at no cost in time. A block owns 128 columns and
  one split of K; the splits of a column tile form one thread-block
  cluster (at most 8) and are summed through distributed shared memory
  in a fixed order, so a call is one launch and writes no partials.
* M > 16 (prefill, training), and larger K: a BM x 128 tile (BM 64 or
  128). bf16 x takes one pass, the rounding of ``x * s`` to bf16 that the
  TPU's MXU makes at default precision; f32 x takes two. What bounds it
  now is ``mma.sync`` issue and the A staging, not the bytes. Its K split
  follows K alone (at most ``TILED_KC`` rows a split), so the order in
  which a row's sums are taken, and so its output bit for bit, does not
  depend on how many rows share the call.

:func:`plan` chooses the launch (path, row tile, K split) from the shapes
alone, in Python, so the CPU tests reach it. On either path a row's output
is the same at every M the path takes (M <= 16, or M > 16); the two paths
round differently.

``int8_matmul_t`` has one design: ``mma.sync`` on 128 x 128 output tiles,
the whole contraction in one block, the group scale an epilogue on each
group's f32 sums (one pass for bf16 g, two for f32 g).

:func:`int8_matmul_batched` and :func:`int8_matmul_t_batched` take an MoE
layer's expert stacks, ``x (E, M, K)`` against ``q (E, K, N)``: the
reference's ``vmap`` of the 2-D op, which in JAX is the same kernel with
one more grid axis. Here too: one launch covers the E problems, the
expert on a grid axis of the same kernels, so each expert's rows are the
2-D kernel's output on that expert's problem at the same plan. For a CPU
tensor they run ``ref.int8_matmul_batched_ref`` and
``ref.int8_matmul_t_batched_ref``; they never loop over the experts.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import LAUNCHES, build, ref

GROUP = 256          # the kernel's quant block along N
SMALL_M = 16         # largest M the small-M path takes (one m16 tile)
SMALL_N = 128        # small path: columns a block
SMALL_K = 64         # small path k tile (a split's rows are a multiple)
MAX_CLUSTER = 8      # small path: most K splits (blocks of one cluster)
SMALL_KC_MAX = 2048  # small path: most K rows a split (its x * s is staged
                     # whole in shared memory); larger K takes the tiled path
TILE_N = 128         # tiled path output tile columns
TILE_K = 32          # tiled path k tile (a split's rows are a multiple)
TILED_KC = 4096      # tiled path: most K rows a split
TILE_M_T = 128       # int8_matmul_t's output rows a block
H100_SMS = 132


class Plan(NamedTuple):
    path: int        # 0: small-M, 1: tiled
    m_tile: int      # rows a block: 16 on the small path, 64 or 128 tiled
    kc: int          # K rows per split
    splits: int      # K splits: on the small path the blocks of one cluster,
                     # summed in distributed shared memory; on the tiled path
                     # (> 1) float32 partials and an ordered second kernel


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(M: int, K: int, N: int, sms: int = H100_SMS, E: int = 1) -> Plan:
    """Launch plan for ``E`` (M, K) x (K, N) problems in one launch (E = 1:
    one problem).

    The small path has E x N/128 column tiles; K is split until about four
    blocks per SM are in flight, into at most ``MAX_CLUSTER`` splits of
    whole 64-row k tiles, all of one cluster; K beyond ``MAX_CLUSTER *
    SMALL_KC_MAX`` rows goes to the tiled path at any M. The tiled path
    takes 128-row tiles unless 64-row tiles pad M by fewer rows (M =
    17-64, or 300 in 5 tiles of 64 rather than 3 of 128; the row tile
    does not change a row's sums), and splits K by K alone: into
    ``ceil(K / TILED_KC)`` splits (at most 16), each a multiple of the
    32-row k tile. A split count chosen from M would fill the card at
    short prefills, but would also change each row's summation order
    with the number of rows in the call.
    """
    if M <= SMALL_M and K <= MAX_CLUSTER * SMALL_KC_MAX:
        want = _cdiv(4 * sms, E * (N // SMALL_N))
        splits = max(1, min(want, MAX_CLUSTER, _cdiv(K, SMALL_K)))
        kc = _cdiv(_cdiv(K, splits), SMALL_K) * SMALL_K
        splits = _cdiv(K, kc)
        return Plan(0, SMALL_M, kc, splits)
    bm = 128 if 2 * _cdiv(M, 128) == _cdiv(M, 64) else 64
    splits = min(_cdiv(K, TILED_KC), 16)
    kc = _cdiv(_cdiv(K, splits), TILE_K) * TILE_K
    return Plan(1, bm, kc, _cdiv(K, kc))


def _check(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
           block: int, axis: int = 0, batched: bool = False) -> None:
    """``x``'s last axis must match axis ``axis`` of ``q``'s (K, N): K for
    :func:`int8_matmul`, the padded N for :func:`int8_matmul_t`. With
    ``batched`` every operand leads with the same expert axis E."""
    nd = 3 if batched else 2
    if x.ndim != nd or q.ndim != nd or scale.ndim != nd:
        raise ValueError(f"need {nd}-D x, q, scale; got {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(scale.shape)}")
    if batched and not x.shape[0] == q.shape[0] == scale.shape[0]:
        raise ValueError(f"expert axes differ: {tuple(x.shape)}, "
                         f"{tuple(q.shape)}, {tuple(scale.shape)}")
    K, N = q.shape[-2:]
    if x.shape[-1] != (K, N)[axis]:
        raise ValueError(f"x has {'KN'[axis]}={x.shape[-1]}, q has shape "
                         f"{tuple(q.shape)}")
    if block != GROUP or N % GROUP:
        raise ValueError(f"need quant block {GROUP} and N % {GROUP} == 0, "
                         f"got block={block}, N={N}")
    if tuple(scale.shape[-2:]) != (K, N // block):
        raise ValueError(f"scale shape {tuple(scale.shape)} != "
                         f"{(K, N // block)}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"need int8 codes and float32 scales, got "
                        f"{q.dtype}, {scale.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not (x.device == q.device == scale.device):
        raise ValueError(f"x, q, scale on different devices: {x.device}, "
                         f"{q.device}, {scale.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.device.type == "cuda":
        for name, t in (("x", x), ("q", q), ("scale", scale)):
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                block: int = GROUP, p: Plan = None) -> torch.Tensor:
    """``x (M, K) @ deq(q, scale)`` → ``(M, N)`` float32, N the padded
    width of ``q``. ``p`` replaces :func:`plan`'s launch plan (a test
    holds :func:`int8_matmul_batched`'s rows against this kernel at the
    batched call's plan)."""
    _check(x, q, scale, block)
    if x.device.type == "cpu":
        return ref.int8_matmul_ref(x, q, scale, block)
    return _launch("int8_matmul", x[None], q[None], scale[None], p)[0]


def int8_matmul_batched(x: torch.Tensor, q: torch.Tensor,
                        scale: torch.Tensor, block: int = GROUP
                        ) -> torch.Tensor:
    """``x (E, M, K) @ deq(q (E, K, N), scale (E, K, N/256))`` → ``(E, M,
    N)`` float32: E experts' problems in one launch, the expert a grid axis
    of the ``int8_matmul`` kernel (:func:`plan` with ``E``)."""
    _check(x, q, scale, block, batched=True)
    if x.device.type == "cpu":
        return ref.int8_matmul_batched_ref(x, q, scale, block)
    return _launch("int8_matmul_batched", x, q, scale, None)


def _launch(name: str, x, q, scale, p) -> torch.Tensor:
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    E, M, K = x.shape
    N = q.shape[2]
    if p is None:
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        p = plan(M, K, N, sms, E)
    out = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    ws = (torch.empty((p.splits, E, M, N), dtype=torch.float32,
                      device=x.device) if p.path == 1 and p.splits > 1
          else out)
    fn = _entry()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    LAUNCHES[name] += 1
    err = fn(x.data_ptr(), int(x.dtype == torch.bfloat16), q.data_ptr(),
             scale.data_ptr(), out.data_ptr(), ws.data_ptr(), E, M, K, N,
             p.path, p.m_tile, p.kc, p.splits, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {err} "
                           f"(E={E}, M={M}, K={K}, N={N}, {p})")
    return out


def _entry():
    lib = build.load("int8_matmul")
    fn = lib.qgl_int8_matmul_batched
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, vp, i, i, i, i, i, i, i, i, vp]
        fn.restype = i
    return fn


def int8_matmul_t(g: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                  block: int = GROUP) -> torch.Tensor:
    """``g (M, N) @ deq(q (K, N), scale)^T`` → ``(M, K)`` float32, N the
    padded width of ``q`` (the port of ``repro/kernels/int8_matmul.py::
    int8_matmul_t``, kernel ``csrc/int8_matmul_t.cu``). For a CUDA tensor
    it launches the kernel; for a CPU tensor it runs
    ``ref.int8_matmul_t_ref``."""
    _check(g, q, scale, block, axis=1)
    if g.device.type == "cpu":
        return ref.int8_matmul_t_ref(g, q, scale, block)
    return _launch_t("int8_matmul_t", g[None], q[None], scale[None])[0]


def int8_matmul_t_batched(g: torch.Tensor, q: torch.Tensor,
                          scale: torch.Tensor, block: int = GROUP
                          ) -> torch.Tensor:
    """``g (E, M, N) @ deq(q (E, K, N), scale)^T`` → ``(E, M, K)`` float32:
    E experts' problems in one launch, the expert a grid axis of the
    ``int8_matmul_t`` kernel."""
    _check(g, q, scale, block, axis=1, batched=True)
    if g.device.type == "cpu":
        return ref.int8_matmul_t_batched_ref(g, q, scale, block)
    return _launch_t("int8_matmul_t_batched", g, q, scale)


def _launch_t(name: str, g, q, scale) -> torch.Tensor:
    if q.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("g and q must be 16-byte aligned")
    E, M, N = g.shape
    K = q.shape[1]
    if _cdiv(M, TILE_M_T) > 65535 or E > 65535:
        raise ValueError(f"too many rows or experts for one launch: "
                         f"E={E}, M={M}")
    out = torch.empty((E, M, K), dtype=torch.float32, device=g.device)
    fn = _entry_t()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    LAUNCHES[name] += 1
    err = fn(g.data_ptr(), int(g.dtype == torch.bfloat16), q.data_ptr(),
             scale.data_ptr(), out.data_ptr(), E, M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul_t launch failed: CUDA error {err} "
                           f"(E={E}, M={M}, K={K}, N={N})")
    return out


def _entry_t():
    lib = build.load("int8_matmul_t")
    fn = lib.qgl_int8_matmul_t_batched
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, i, vp, vp, vp, i, i, i, i, vp]
        fn.restype = i
    return fn
