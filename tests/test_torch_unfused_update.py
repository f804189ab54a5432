"""The unfused Q-GaLore update's kernels against the JAX package: the plain
``sr_requant`` and ``blockwise_quant`` (codes bit for bit), ``int4_matmul``
(2e-2, the reference's tolerance) and their ``ops`` entry points with the
padding and cropping of ``repro/kernels/ops.py``, each against the JAX
``ref`` and ``pallas-interpret`` backends; then the whole unfused chain of
``benchmarks/kernels_bench.py`` at a small right-side shape, with the
reference's own SR uniforms. Inputs come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projector as jproj
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.blockwise_quant import blockwise_quant as pallas_bq
from repro.kernels.int4_matmul import int4_matmul as pallas_i4
from repro.kernels.sr_requant import sr_requant as pallas_sr
from repro_torch.core import quant as tq
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.kernels import blockwise_quant as tbq
from repro_torch.kernels import int4_matmul as ti4
from repro_torch.kernels import sr_requant as tsr


def _t(jt) -> tq.QTensor:
    """A JAX QTensor as the port's, the same codes."""
    return tq.from_numpy((np.asarray(jt.q), np.asarray(jt.scale),
                          None if jt.zero is None else np.asarray(jt.zero),
                          jt.bits, jt.block, jt.orig_last, jt.dtype))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() \
        / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# sr_requant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,C", [(128, 512), (128, 768), (8, 256),
                                 (33, 1024)])
def test_sr_requant_plain_bit_exact_with_jax(R, C):
    """The same uniforms: codes equal bit for bit, scales within 1e-6
    (``tests/test_kernels.py:76-81``), against the JAX oracle and the
    Pallas kernel in interpret mode."""
    jt = jq.quantize_blockwise(jnp.asarray(_normal((R, C), R + C)), 8,
                               symmetric=True)
    upd = _normal((R, C), C, 0.01)
    u01 = np.random.default_rng(R).random((R, C), dtype=np.float32)
    want_q, want_s = jref.sr_requant_ref(jt.q, jt.scale, jnp.asarray(upd),
                                         jnp.asarray(u01), 256)
    pal_q, pal_s = pallas_sr(jt.q, jt.scale, jnp.asarray(upd),
                             jnp.asarray(u01), block=256,
                             br=min(128, R), bc=256, interpret=True)
    tt = _t(jt)
    LAUNCHES.clear()
    q, s = tsr.sr_requant(tt.q, tt.scale, torch.from_numpy(upd),
                          torch.from_numpy(u01))
    assert LAUNCHES["sr_requant_ref"] == 1 and LAUNCHES["sr_requant"] == 0
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    for wq, ws in ((want_q, want_s), (pal_q, pal_s)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)


@pytest.mark.parametrize("R,C0", [(128, 768), (64, 700), (2, 300)])
def test_sr_requant_update_matches_jax_ops(R, C0):
    """``ops.sr_requant_update`` pads the update to the codes' padded
    width; the reference's own uniforms (``jax.random.uniform`` of its
    key, ``repro/kernels/ops.py:443``) handed over: codes equal."""
    jt = jq.quantize_blockwise(jnp.asarray(_normal((R, C0), C0, 0.02)), 8,
                               symmetric=True)
    upd = _normal((R, C0), R, 1e-3)
    key = jax.random.PRNGKey(R + C0)
    u01 = np.array(jax.random.uniform(key, jt.q.shape, jnp.float32))
    got = ops.sr_requant_update(_t(jt), torch.from_numpy(upd),
                                torch.from_numpy(u01))
    assert got.orig_last == C0 and tuple(got.q.shape) == jt.q.shape
    for kw in ({"backend": "ref"}, {"interpret": True}):
        want = jops.sr_requant_update(jt, jnp.asarray(upd), key, **kw)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=1e-6)


def test_sr_requant_rejects_bad_block():
    q = torch.zeros((4, 256), dtype=torch.int8)
    s = torch.ones((4, 2))
    with pytest.raises(ValueError, match="block"):
        tsr.sr_requant(q, s, torch.zeros((4, 256)), torch.zeros((4, 256)),
                       block=128)


# ---------------------------------------------------------------------------
# blockwise_quant and quantize_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,C", [(128, 512), (64, 256), (256, 1024),
                                 (32, 768)])
def test_blockwise_quant_plain_bit_exact_with_jax(R, C):
    """Codes equal, scales within 1e-6 (``tests/test_kernels.py:110-120``)
    against the oracle and the Pallas kernel in interpret mode."""
    x = _normal((R, C), R * C, 3.0)
    want_q, want_s = jref.blockwise_quant_ref(jnp.asarray(x), 256)
    pal_q, pal_s = pallas_bq(jnp.asarray(x), block=256, br=min(128, R),
                             bc=256, interpret=True)
    LAUNCHES.clear()
    q, s = tbq.blockwise_quant(torch.from_numpy(x))
    assert LAUNCHES["blockwise_quant_ref"] == 1
    assert LAUNCHES["blockwise_quant"] == 0
    for wq, ws in ((want_q, want_s), (pal_q, pal_s)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-6)


@pytest.mark.parametrize("shape", [(3, 5, 300), (64, 256), (7, 1000)])
def test_quantize_int8_matches_jax_ops(shape):
    """Ragged C is zero-padded to the block and kept as ``orig_last``; the
    codes and scales equal the JAX op's and the port's own
    ``core.quant.quantize_blockwise``."""
    x = _normal(shape, sum(shape), 2.0)
    got = ops.quantize_int8(torch.from_numpy(x))
    assert got.orig_last == shape[-1] and got.bits == 8 and got.zero is None
    mine = tq.quantize_blockwise(torch.from_numpy(x), 8, symmetric=True)
    np.testing.assert_array_equal(got.q.numpy(), mine.q.numpy())
    np.testing.assert_array_equal(got.scale.numpy(), mine.scale.numpy())
    for kw in ({"backend": "ref"}, {"interpret": True}):
        want = jops.quantize_int8(jnp.asarray(x), **kw)
        assert want.orig_last == got.orig_last
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# int4_matmul and int4_project
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,R", [(128, 512, 128), (256, 1024, 64),
                                   (37, 300, 64)])
def test_int4_matmul_plain_matches_jax(M, K, R):
    """2e-2 (``tests/test_kernels.py:53-62``) against the oracle and the
    Pallas kernel in interpret mode; the last case has ragged M and K."""
    g = _normal((M, K), M)
    jt = jq.quantize_blockwise(jnp.asarray(_normal((K, R), K, 0.1)), 4,
                               block=min(128, R), symmetric=False)
    want = jref.int4_matmul_ref(jnp.asarray(g), jt.q, jt.scale, jt.zero,
                                jt.block)
    pal = pallas_i4(jnp.asarray(g), jt.q, jt.scale, jt.zero, block=jt.block,
                    interpret=True)
    tt = _t(jt)
    LAUNCHES.clear()
    got = ti4.int4_matmul(torch.from_numpy(g), tt.q, tt.scale, tt.zero,
                          tt.block)
    assert LAUNCHES["int4_matmul_ref"] == 1 and LAUNCHES["int4_matmul"] == 0
    assert got.shape == (M, R) and got.dtype == torch.float32
    for w in (want, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-2,
                                   atol=2e-2)
    assert _rel(got.numpy(), want) <= 1e-5      # the same f32 products


@pytest.mark.parametrize("M,K,R,block", [
    (2048, 2048, 512, 256), (5461, 2048, 512, 256),   # phase 7's problems
    (1, 64, 32, 32), (37, 300, 64, 64), (130, 1000, 100, 100),
    (257, 2048, 512, 256), (600, 512, 64, 64), (21, 256, 100, 100),
    (4096, 4096, 1024, 256), (300, 24, 24, 24), (70000, 256, 256, 128)])
def test_int4_plan_covers_k_and_keeps_tiles_inside_blocks(M, K, R, block):
    """Every k row in exactly one split of whole 32-row steps, no empty
    split, at most 16 splits of at least 256 rows each, and an output tile
    that never straddles a block of R (so A = g * s has one scale a row)."""
    p = ti4.plan(M, K, R, block)
    assert p.kc % ti4.TILE_K == 0 and 1 <= p.splits <= 16
    assert (p.splits - 1) * p.kc < max(K, 1) <= p.splits * p.kc
    assert p.splits == 1 or p.kc >= 256 - ti4.TILE_K
    # a block of R takes whole 128-column tiles, the last one masked
    cols = (R // block) * -(-block // ti4.TILE_N)
    assert cols * ti4.TILE_N >= R
    tiles = cols * -(-M // ti4.TILE_M)
    assert p.splits == 1 or tiles * (p.splits - 1) < ti4.H100_SMS
    # a split exactly where the tiles alone leave SMs idle and K has rows
    # for two splits of 256
    assert (p.splits > 1) == (tiles < ti4.H100_SMS and K >= 512)


def test_int4_plan_phase7_shapes():
    """llama-1b's right-side weights at rank 512 (P blocks of 256): at
    M = 2048 the 128 tiles of 64 x 128 take a 2-way K split to fill the
    card, at M = 5461 the 344 tiles fill it alone."""
    assert ti4.plan(2048, 2048, 512, 256) == ti4.Plan(1024, 2)
    assert ti4.plan(5461, 2048, 512, 256) == ti4.Plan(2048, 1)


@pytest.mark.parametrize("lead,K,r", [((3, 7), 512, 128), ((21,), 256, 100),
                                      ((5,), 640, 96)])
def test_int4_project_matches_jax_ops(lead, K, r):
    """``ops.int4_project`` with ragged M (the reference pads M to its row
    tile; the CUDA kernel masks it) and a projection from
    ``projector.quantize_projection``; the rank is cropped to the real r."""
    g = _normal(lead + (K,), K)
    P = np.linalg.qr(_normal((K, r), r))[0].astype(np.float32)
    jt = jproj.quantize_projection(jnp.asarray(P), 4, 256)
    got = ops.int4_project(torch.from_numpy(g), _t(jt))
    assert got.shape == lead + (r,)
    for kw in ({"backend": "ref"}, {"interpret": True}):
        want = jops.int4_project(jnp.asarray(g), jt, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                                   atol=2e-2)
    # close to the float projection (the reference's Fig. 3 claim)
    flt = g.reshape(-1, K) @ P
    cos = (got.numpy().reshape(-1, r) * flt).sum() / (
        np.linalg.norm(got.numpy()) * np.linalg.norm(flt))
    assert cos > 0.99


def test_int4_project_rejects_int8():
    qt = tq.quantize_blockwise(torch.randn(64, 256), 8, symmetric=True)
    with pytest.raises(TypeError, match="INT4"):
        ops.int4_project(torch.randn(4, 64), qt)


# ---------------------------------------------------------------------------
# The unfused chain
# ---------------------------------------------------------------------------

def _jax_chain(qt, qp, grad, m32, v32, key, lr, backend):
    """``benchmarks/kernels_bench.py``'s unfused update (count 1)."""
    b1, b2, eps, gscale = 0.9, 0.999, 1e-8, 0.25
    low = jops.int4_project(grad, qp, backend=backend)
    m_new = b1 * m32 + (1 - b1) * low
    v_new = b2 * v32 + (1 - b2) * low * low
    dirn = (m_new / (1 - b1)) / (jnp.sqrt(v_new / (1 - b2)) + eps)
    upd = gscale * jproj.project_back(
        dirn, jproj.maybe_dequantize(qp), "right")
    new_qt = jops.sr_requant_update(qt, -lr * upd, key, backend=backend)
    return new_qt, m_new, v_new


@pytest.mark.parametrize("m,n,r", [(256, 128, 32), (300, 256, 64)])
@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
def test_unfused_chain_matches_reference_chain(m, n, r, backend):
    """The port's ``ops.unfused_qgalore_update`` against the reference
    chain with the reference's uniforms: moments within 1e-6 of their
    largest value, weights within one INT8 quantum."""
    W = _normal((m, n), m, 0.02)
    jt = jq.quantize_blockwise(jnp.asarray(W), 8, symmetric=True)
    P = np.linalg.qr(_normal((n, r), n))[0].astype(np.float32)
    jp = jproj.quantize_projection(jnp.asarray(P), 4, 256)
    grad = _normal((m, n), n)
    m32 = _normal((m, r), r, 0.1)
    v32 = np.abs(_normal((m, r), r + 1, 0.01))
    key, lr = jax.random.PRNGKey(m + n), 1e-2
    want_qt, want_m, want_v = _jax_chain(
        jt, jp, jnp.asarray(grad), jnp.asarray(m32), jnp.asarray(v32), key,
        lr, backend)
    u01 = np.array(jax.random.uniform(key, jt.q.shape, jnp.float32))
    LAUNCHES.clear()
    got_qt, got_m, got_v = ops.unfused_qgalore_update(
        _t(jt), torch.from_numpy(grad), torch.from_numpy(m32),
        torch.from_numpy(v32), _t(jp), 1, lr, torch.from_numpy(u01),
        gscale=0.25)
    assert LAUNCHES["int4_matmul_ref"] == 1
    assert LAUNCHES["sr_requant_ref"] == 1
    assert _rel(got_m.numpy(), want_m) <= 1e-6
    assert _rel(got_v.numpy(), want_v) <= 1e-6
    got_w = tq.dequantize(got_qt, torch.float32).numpy()
    want_w = np.asarray(jq.dequantize(want_qt, jnp.float32))
    quantum = float(np.asarray(want_qt.scale).max())
    assert np.abs(got_w - want_w).max() <= quantum * (1 + 1e-5)
    assert (got_qt.q.numpy() == np.asarray(want_qt.q)).mean() > 0.99
