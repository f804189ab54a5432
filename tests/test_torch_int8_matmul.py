"""The port's int8_matmul against the JAX package: the plain version
against repro.kernels.ref and the Pallas kernel (interpret mode), the CPU
model path against repro.kernels.ops.quantized_dense (ref backend), and
the CUDA wrapper's launch planning and argument checks, which run here
without a card or nvcc."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.int8_matmul import int8_matmul as pallas_int8_matmul
from repro_torch.core import quant as tq
from repro_torch.kernels import LAUNCHES, build, ops, ref
from repro_torch.kernels import int8_matmul as ti8
from torch_one_thread import one_thread  # noqa: F401


def _problem(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jt = jq.quantize_blockwise(jnp.asarray(w), 8, symmetric=True)
    return x, jt, tq.from_numpy((np.asarray(jt.q), np.asarray(jt.scale),
                                 None, 8, 256, N, "float32"))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() \
        / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("M,K,N", [(1, 64, 256), (5, 300, 512),
                                   (64, 256, 768)])
def test_ref_matches_jax_ref(M, K, N):
    x, jt, tt = _problem(M, K, N)
    want = jref.int8_matmul_ref(jnp.asarray(x), jt.q, jt.scale, 256)
    got = ref.int8_matmul_ref(torch.from_numpy(x), tt.q, tt.scale, 256)
    # 1e-5 relative to max|ref|: the same products, summed in another order
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("M,K,N", [(128, 512, 256), (8, 256, 768)])
def test_ref_matches_pallas_interpret(M, K, N):
    """Kernel parity tolerance: 2e-2 relative to max|ref|
    (docs/kernels.md, tests/test_kernels.py)."""
    x, jt, tt = _problem(M, K, N, seed=1)
    want = pallas_int8_matmul(jnp.asarray(x), jt.q, jt.scale, block=256,
                              bm=min(128, M), interpret=True)
    got = ref.int8_matmul_ref(torch.from_numpy(x), tt.q, tt.scale, 256)
    assert _rel(got.numpy(), want) <= 2e-2


@pytest.mark.parametrize("lead,K,N", [((1,), 64, 128), ((2, 3), 300, 300),
                                      ((7,), 5461 // 43, 2048 // 8)])
def test_quantized_dense_cpu_matches_jax_ref_backend(lead, K, N):
    """M=1, ragged K and N not a multiple of 256: the CPU model path is
    the JAX ref branch (dequantize, then one f32 matmul)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    jt = jq.quantize_blockwise(jnp.asarray(w), 8, symmetric=True)
    tt = tq.quantize_blockwise(torch.from_numpy(w), 8, symmetric=True)
    want = jops.quantized_dense(jnp.asarray(x), jt, dtype=jnp.float32,
                                backend="ref")
    LAUNCHES.clear()
    got = ops.quantized_dense(torch.from_numpy(x), tt, dtype=torch.float32)
    assert tuple(got.shape) == lead + (N,)
    assert _rel(got.numpy(), want) <= 1e-5
    assert LAUNCHES["deq_matmul"] == 1 and LAUNCHES["int8_matmul"] == 0


def test_wrapper_on_cpu_runs_plain_version():
    x, _, tt = _problem(3, 300, 512, seed=3)
    LAUNCHES.clear()
    got = ti8.int8_matmul(torch.from_numpy(x), tt.q, tt.scale)
    want = ref.int8_matmul_ref(torch.from_numpy(x), tt.q, tt.scale, 256)
    assert torch.equal(got, want)
    assert LAUNCHES["int8_matmul"] == 0
    assert LAUNCHES["int8_matmul_ref"] == 2


def test_wrapper_rejects_bad_arguments():
    x, _, tt = _problem(2, 256, 256, seed=4)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="K="):
        ti8.int8_matmul(xt[:, :128], tt.q, tt.scale)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ti8.int8_matmul(xt.double(), tt.q, tt.scale)
    with pytest.raises(TypeError, match="int8 codes"):
        ti8.int8_matmul(xt, tt.q.to(torch.int16), tt.scale)
    with pytest.raises(ValueError, match="quant block"):
        ti8.int8_matmul(xt, tt.q, tt.scale, block=128)


LLAMA_1B_KN = [(2048, 2048), (2048, 5632), (5461, 2048), (2048, 32000)]


@pytest.mark.parametrize("K,N", LLAMA_1B_KN)
@pytest.mark.parametrize("M", [1, 4, 8, 16, 17, 64, 65, 300, 512, 2048,
                               4096])
def test_plan_covers_k_and_bounds_partials(M, K, N):
    p = ti8.plan(M, K, N)
    assert p.splits >= 1 and p.kc >= 1
    assert (p.splits - 1) * p.kc < K <= p.splits * p.kc   # no empty split
    if M <= ti8.SMALL_M:
        # one m16 row tile; whole 64-row k tiles; every K row in exactly
        # one split; the splits are one cluster, of at most 8 blocks, along
        # the first axis of the grid (splits, N/128), which it divides
        assert p.path == 0 and p.m_tile == 16
        assert p.kc % ti8.SMALL_K == 0
        rows = [k for z in range(p.splits)
                for k in range(z * p.kc, min(K, (z + 1) * p.kc))]
        assert rows == list(range(K))
        assert p.splits <= ti8.MAX_CLUSTER and N % ti8.SMALL_N == 0
    else:
        assert p.path == 1 and p.kc % ti8.TILE_K == 0
        assert p.splits <= 16
        # 128-row tiles unless 64-row tiles pad M by fewer rows
        assert p.m_tile in (64, 128)
        pad = {bm: -(-M // bm) * bm - M for bm in (64, 128)}
        assert pad[p.m_tile] == min(pad.values())
        assert p.m_tile == 128 or pad[64] < pad[128]


@pytest.mark.parametrize("M", [1, 16])
def test_plan_small_m_beyond_its_k_takes_the_tiled_path(M):
    """The small path stages a split's x * s whole in shared memory, so K
    past MAX_CLUSTER * SMALL_KC_MAX rows takes the tiled path."""
    k_max = ti8.MAX_CLUSTER * ti8.SMALL_KC_MAX
    assert ti8.plan(M, k_max, 2048).path == 0
    assert ti8.plan(M, k_max, 2048).kc <= ti8.SMALL_KC_MAX
    p = ti8.plan(M, k_max + 1, 2048)
    assert p.path == 1 and p.m_tile == 64


@pytest.mark.parametrize("M", [17, 33, 48, 63, 64])
@pytest.mark.parametrize("K,N", LLAMA_1B_KN)
def test_plan_short_prefill_takes_64_row_tiles(M, K, N):
    """17 <= M <= 64: one 64-row tile a column block, not half of a 128-row
    one; the K split is the one every M > 16 takes (K alone)."""
    p = ti8.plan(M, K, N)
    assert p.path == 1 and p.m_tile == 64
    assert p.splits == min(-(-K // ti8.TILED_KC), 16)
    assert (p.kc, p.splits) == ti8.plan(4096, K, N)[2:]


@pytest.mark.parametrize("K,N", LLAMA_1B_KN + [(25600, 5120),
                                               (256000, 3072)])
def test_plan_k_order_does_not_depend_on_m(K, N):
    """Each path's K split is a function of the shapes without M, so a
    row's summation order is the same whatever rows share the call."""
    tiled = {ti8.plan(M, K, N)[2:] for M in (17, 64, 65, 128, 300, 512,
                                             2048, 4096, 16384)}
    assert len(tiled) == 1
    small = {ti8.plan(M, K, N) for M in range(1, ti8.SMALL_M + 1)}
    assert len(small) == 1


def test_kernel_module_imports_without_nvcc():
    """Importing the wrapper builds nothing; sources are found and the
    library name follows the source hash into build/."""
    assert "int8_matmul" in build.sources()
    path = build.lib_path("int8_matmul")
    assert path.parent == build.BUILD_DIR and path.suffix == ".so"
    assert path == build.lib_path("int8_matmul")
    assert "int8_matmul" not in build._LOADED


# ---------------------------------------------------------------------------
# The small-M kernel's arithmetic (csrc/int8_matmul.cu, i8mm_small)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _llama_weight(K, N):
    """Codes and scales of a (K, N) weight, drawn directly."""
    rng = np.random.default_rng(K + N)
    q = rng.integers(-127, 128, size=(K, N), dtype=np.int8)
    s = rng.uniform(1e-4, 3e-4, size=(K, N // 256)).astype(np.float32)
    return q, s


K_WARPS = 2   # the small-M kernel's k warps: alternate 16-row steps a tile


def _emulate_small(x, q, scale, passes):
    """float32 emulation of the small-M kernel: hi = bf16(x * s) and lo =
    bf16(x * s - hi) of each (k, group), times the exact codes, summed in
    f32 in the kernel's order: in each K split, k warp w takes the 16-row
    steps 16w, 16w + 32 of every 64-row k tile and keeps the hi and the lo
    products in sums of their own, added at the end; a block adds its k
    warps in order, and the cluster adds the blocks by split."""
    M, K = x.shape
    N = q.shape[1]
    G = N // 256
    p = ti8.plan(M, K, N)
    assert p.path == 0
    total = torch.zeros((M, N))
    for z in range(p.splits):
        k0, k1 = z * p.kc, min(K, (z + 1) * p.kc)
        block = torch.zeros((M, G, 256))
        for wk in range(K_WARPS):
            part = [torch.zeros((M, G, 256)) for _ in range(passes)]
            for kk in range(k0 + 16 * wk, k1, 16 * K_WARPS):
                ks = slice(kk, min(kk + 16, k1))
                xs = x[:, ks, None].float() * scale[None, ks, :]
                hi = xs.to(torch.bfloat16).float()
                q3 = q[ks].float().reshape(-1, G, 256)
                part[0] = part[0] + torch.einsum("mkg,kgb->mgb", hi, q3)
                if passes == 2:
                    lo = (xs - hi).to(torch.bfloat16).float()
                    part[1] = part[1] + torch.einsum("mkg,kgb->mgb", lo, q3)
            block = block + (part[0] + part[1] if passes == 2 else part[0])
        total = total + block.reshape(M, N)
    return total


@pytest.mark.parametrize("K,N", LLAMA_1B_KN)
@pytest.mark.parametrize("M", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_small_m_kernel_arithmetic_matches_plain(K, N, M, dtype):
    """The small-M kernel's two passes at llama-1b's four (K, N) within
    1e-4 of max|plain| (``ref.int8_matmul_ref``) and of the JAX package's
    ``int8_matmul_ref``; one pass (hi only) must miss that bar, so a check
    at 1e-4 can tell one pass from two."""
    q, s = _llama_weight(K, N)
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)) \
        .to(dtype)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    want = ref.int8_matmul_ref(x, qt, st, 256)
    jwant = jref.int8_matmul_ref(jnp.asarray(x.float().numpy()),
                                 jnp.asarray(q), jnp.asarray(s), 256)
    two = _emulate_small(x, qt, st, passes=2)
    assert _rel(two.numpy(), want.numpy()) <= 1e-4
    assert _rel(two.numpy(), jwant) <= 1e-4
    one = _emulate_small(x, qt, st, passes=1)
    assert _rel(one.numpy(), want.numpy()) > 1e-4
