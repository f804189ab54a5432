"""The training slice's kernels against the JAX package: the plain
``int8_matmul_t`` against the JAX ref branch, the fused Q-GaLore update
(plain version, through the port's padding wrapper) against the JAX op on
its ``ref`` and ``pallas-interpret`` backends with the reference's own SR
uniforms, and the gradients of ``quantized_dense`` and ``embed_lookup``
against ``jax.vjp`` through a ``QVirtual``. Inputs come from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projector as jproj
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels.int8_matmul import int8_matmul_t as pallas_int8_matmul_t
from repro.models import layers as jlayers
from repro_torch.core import quant as tq
from repro_torch.kernels import LAUNCHES, build, ops, ref
from repro_torch.kernels import fused_update as tfu
from repro_torch.kernels import int8_matmul as ti8
from repro_torch.models import layers as tlayers


def _t(jt) -> tq.QTensor:
    """A JAX QTensor as the port's, the same codes."""
    return tq.from_numpy((np.asarray(jt.q), np.asarray(jt.scale),
                          None if jt.zero is None else np.asarray(jt.zero),
                          jt.bits, jt.block, jt.orig_last, jt.dtype))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() \
        / max(np.abs(want).max(), 1e-30)


def _weight(K, N, seed, scale=1.0):
    w = np.random.default_rng(seed).standard_normal((K, N)) * scale
    return jq.quantize_blockwise(jnp.asarray(w, jnp.float32), 8,
                                 symmetric=True)


# ---------------------------------------------------------------------------
# int8_matmul_t
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 7, 17, 129, 300])
@pytest.mark.parametrize("K,N", [
    (64, 256),             # one quant group
    (300, 512),            # ragged K (the output width)
    (127, 300),            # ragged K and N padded to 512
    (5461 // 43, 700),     # llama-1b's d_ff factor, N padded
    (5461, 512),           # llama-1b's d_ff as the output width
    (128, 32000),          # the head's 125 groups in one contraction
])
def test_int8_matmul_t_plain_matches_jax_ref(K, N, M, dtype):
    """1e-5 of max|ref|: the same products, summed in another order; g in
    f32 or bf16 (the training path's), rows ragged against the kernel's
    128-row tiles."""
    jt = _weight(K, N, seed=M + K)
    g = torch.from_numpy(np.random.default_rng(N).standard_normal(
        (M, N)).astype(np.float32)).to(dtype)
    want = jops._i8t_call("ref", jnp.asarray(g.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32), jt.q,
        jt.scale, 256)
    tt = _t(jt)
    LAUNCHES.clear()
    got = ops._dx(g, tt)                            # the CPU model path
    assert got.shape == (M, K) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    # the wrapper on a CPU tensor: the plain version over zero-padded g
    g_pad = torch.nn.functional.pad(g, (0, tt.q.shape[1] - N))
    got_t = ti8.int8_matmul_t(g_pad, tt.q, tt.scale)
    assert _rel(got_t.numpy(), want) <= 1e-5
    assert LAUNCHES["int8_matmul_t"] == 0
    assert LAUNCHES["int8_matmul_t_ref"] == 1
    assert LAUNCHES["deq_matmul_t"] == 1


def test_int8_matmul_t_plain_matches_pallas_interpret():
    """The TPU kernel in interpret mode: 2e-2 of max|ref|, the kernel
    tolerance of docs/kernels.md."""
    M, K, N = 128, 256, 512
    jt = _weight(K, N, seed=3)
    g = np.random.default_rng(4).standard_normal((M, N)).astype(np.float32)
    want = pallas_int8_matmul_t(jnp.asarray(g), jt.q, jt.scale, block=256,
                                bm=128, bn=256, bk=128, interpret=True)
    tt = _t(jt)
    got = ref.int8_matmul_t_ref(torch.from_numpy(g), tt.q, tt.scale, 256)
    assert _rel(got.numpy(), want) <= 2e-2


def test_int8_matmul_t_wrapper_rejects_bad_arguments():
    tt = _t(_weight(300, 300, seed=5))             # q (300, 512)
    g = torch.zeros((4, 512))
    with pytest.raises(ValueError, match="N="):
        ti8.int8_matmul_t(g[:, :300], tt.q, tt.scale)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ti8.int8_matmul_t(g.double(), tt.q, tt.scale)
    with pytest.raises(ValueError, match="quant block"):
        ti8.int8_matmul_t(g, tt.q, tt.scale, block=128)


# ---------------------------------------------------------------------------
# fused_qgalore_update
# ---------------------------------------------------------------------------

B1, B2, EPS = 0.9, 0.999, 1e-8


def _fused_setup(m, n, r, side, seed=0, P=None):
    rng = np.random.default_rng(seed)
    qt = jq.quantize_blockwise(
        jnp.asarray(rng.standard_normal((m, n)) * 0.02, jnp.float32), 8,
        symmetric=True)
    d = n if side == "right" else m
    if P is None:
        P = np.linalg.qr(rng.standard_normal((d, r)))[0]
    qp = jproj.quantize_projection(jnp.asarray(P, jnp.float32), 4, 256)
    low_shape = (m, r) if side == "right" else (r, n)
    low = rng.standard_normal(low_shape).astype(np.float32)
    m32 = (rng.standard_normal(low_shape) * 0.1).astype(np.float32)
    v32 = np.abs(rng.standard_normal(low_shape) * 0.01).astype(np.float32)
    return qt, qp, low, m32, v32


def _check_fused(qt, qp, low, m32, v32, count, lr, side, backend, wd=0.0):
    """The port (plain version, padded and cropped by ops) against the JAX
    op on the same inputs and the same uniforms: codes within one INT8
    quantum and nearly all equal, scales 1e-5 relative, moments 1e-6."""
    key = jax.random.PRNGKey(42 + count)
    want, m_ref, v_ref = jops.fused_qgalore_update(
        qt, jnp.asarray(low), jnp.asarray(m32), jnp.asarray(v32), qp,
        jnp.float32(count), lr, key, side=side, gscale=0.25,
        weight_decay=wd, backend=backend)
    u01 = torch.from_numpy(np.array(jax.random.uniform(key, qt.q.shape,
                                                         jnp.float32)))
    LAUNCHES.clear()
    got, m_got, v_got = ops.fused_qgalore_update(
        _t(qt), torch.from_numpy(low), torch.from_numpy(m32),
        torch.from_numpy(v32), _t(qp), count, lr, u01, side=side,
        gscale=0.25, weight_decay=wd)
    assert LAUNCHES["fused_qgalore_update_ref"] == 1
    assert LAUNCHES["fused_qgalore_update"] == 0
    assert got.q.shape == qt.q.shape and got.orig_last == qt.orig_last
    n = qt.orig_last
    dq_w = np.asarray(jq.dequantize(want, jnp.float32))
    dq_g = tq.dequantize(got, torch.float32).numpy()
    quantum = float(np.asarray(want.scale).max())
    assert np.isfinite(dq_g).all()
    assert float(np.abs(dq_w - dq_g).max()) <= quantum + 1e-6
    assert (got.q.numpy() == np.asarray(want.q))[:, :n].mean() > 0.999
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(m_got.numpy(), np.asarray(m_ref), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_ref), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("backend", ["ref", "pallas-interpret"])
@pytest.mark.parametrize("m,n,r,side", [
    (512, 256, 32, "right"),
    (256, 512, 32, "left"),
    (300, 200, 24, "right"),    # rows and columns off the block multiples
    (200, 300, 24, "left"),
])
def test_fused_update_matches_jax(m, n, r, side, backend):
    qt, qp, low, m32, v32 = _fused_setup(m, n, r, side)
    _check_fused(qt, qp, low, m32, v32, 3, 1e-2, side, backend)


@pytest.mark.parametrize("which", ["zeros", "constant", "half"])
def test_fused_update_int4_zero_point_edges(which):
    """Constant and all-zero projection blocks: the eps-clamped scale and
    the zero point of the INT4 dequantization."""
    m, n, r = 128, 256, 16
    P = {"zeros": np.zeros((n, r)), "constant": np.full((n, r), 0.37),
         "half": np.concatenate([np.zeros((n, r // 2)),
                                 np.ones((n, r // 2))], axis=1)}[which]
    qt, qp, low, m32, v32 = _fused_setup(m, n, r, "right", seed=1, P=P)
    _check_fused(qt, qp, low, m32, v32, 1, 1e-2, "right", "ref")


@pytest.mark.parametrize("side", ["right", "left"])
def test_fused_update_weight_decay(side):
    m, n = (256, 128) if side == "right" else (128, 300)
    qt, qp, low, m32, v32 = _fused_setup(m, n, 16, side, seed=2)
    _check_fused(qt, qp, low, m32, v32, 1, 1e-2, side, "ref", wd=0.1)


def test_fused_wrapper_checks_and_counts():
    qt, qp, low, m32, v32 = _fused_setup(64, 256, 8, "right", seed=3)
    t_qt, t_qp = _t(qt), _t(qp)
    # the kernel-level wrapper takes the padded layout only
    g = torch.zeros((64, 16))
    pq = torch.zeros((256, 8), dtype=torch.uint8)
    ps = torch.zeros((256, 1))
    u01 = torch.full((64, 256), 0.5)
    args = (g, g, g, pq, ps, ps, t_qt.q, t_qt.scale, u01)
    out = tfu.fused_qgalore_update(*args, 1, 1e-2, side="right", pblock=16)
    assert [tuple(o.shape) for o in out] == [(64, 256), (64, 1), (64, 16),
                                             (64, 16)]
    with pytest.raises(ValueError, match="side"):
        tfu.fused_qgalore_update(*args, 1, 1e-2, side="up", pblock=16)
    with pytest.raises(ValueError, match="u01"):
        tfu.fused_qgalore_update(*args[:-1], u01[:, :128], 1, 1e-2,
                                 side="right", pblock=16)
    with pytest.raises(ValueError, match="p_packed"):
        tfu.fused_qgalore_update(g, g, g, pq.to(torch.int8), *args[4:], 1,
                                 1e-2, side="right", pblock=16)
    with pytest.raises(TypeError, match="INT4"):
        ops.fused_qgalore_update(t_qt, torch.from_numpy(low),
                                 torch.from_numpy(m32), torch.from_numpy(v32),
                                 t_qt, 1, 1e-2, u01, side="right",
                                 gscale=0.25)


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic for the rank product, emulated in float32
# ---------------------------------------------------------------------------

def _direction(g, m, v, count):
    m_new = B1 * m + (1 - B1) * g
    v_new = B2 * v + (1 - B2) * (g * g)
    return (m_new / (1 - B1 ** count)) / (torch.sqrt(v_new / (1 - B2 ** count))
                                          + EPS)


def _u_prime(p_packed):
    """INT4 codes as u' = nibble - 8, (d, r), exact."""
    u = torch.stack([p_packed & 0xF, (p_packed >> 4) & 0xF], dim=-1)
    return u.reshape(p_packed.shape[0], -1).to(torch.float32) - 8.0


def _emulate_fused(g, m, v, p_packed, p_scale, p_zero, q, wscale, u01, count,
                   lr, *, side, pblock, wd=0.0, passes=2):
    """The kernel's decomposition of ``fused_qgalore_update`` in float32:
    dir = hi + lo with hi = bf16(dir), lo = bf16(dir - hi) (``passes=1``
    drops lo); P enters as the exact u'; per block b of the rank,
    ``part = sum_k dir * u'`` and ``U += s_b * (part - z_b * S_b)`` with
    ``S_b = sum_{k in b} dir``; then the reference's step and SR requant.
    Returns the codes and the new scales."""
    d = _direction(g, m, v, count)
    hi = d.to(torch.bfloat16).float()
    lo = (d - hi).to(torch.bfloat16).float()
    u = _u_prime(p_packed)
    U = torch.zeros(q.shape)
    for b in range(u.shape[1] // pblock):
        k = slice(b * pblock, (b + 1) * pblock)
        if side == "right":
            part = hi[:, k] @ u[:, k].T + (lo[:, k] @ u[:, k].T if passes == 2
                                           else 0.0)
            S = d[:, k].sum(dim=1, keepdim=True)
            U += p_scale[:, b][None] * (part - p_zero[:, b][None] * S)
        else:
            part = u[:, k] @ hi[k] + (u[:, k] @ lo[k] if passes == 2 else 0.0)
            S = d[k].sum(dim=0, keepdim=True)
            U += p_scale[:, b][:, None] * (part - p_zero[:, b][:, None] * S)
    M, N = q.shape
    w = (q.float().reshape(M, N // 256, 256) * wscale[..., None]).reshape(M, N)
    wn = (w - lr * (0.25 * U + wd * w)).reshape(M, N // 256, 256)
    scale = torch.clamp_min(tq.true_div(wn.abs().amax(dim=-1), 127.0), 1e-12)
    codes = torch.floor(wn / scale[..., None] + u01.reshape(M, N // 256, 256))
    return torch.clamp(codes, -128, 127).reshape(M, N).to(torch.int8), scale


def _rank512_problem(M, N, side, seed):
    """Kernel-level inputs at rank 512 (pblock 256): a ragged row count, a
    random INT4 P and Adam moments from numpy."""
    rng = np.random.default_rng(seed)
    r = 512
    qt = tq.quantize_blockwise(torch.from_numpy(
        (rng.standard_normal((M, N)) * 0.02).astype(np.float32)), 8,
        symmetric=True)
    d = N if side == "right" else M
    qp = tq.quantize_blockwise(torch.from_numpy(
        (rng.standard_normal((d, r)) / np.sqrt(d)).astype(np.float32)), 4,
        block=256)
    low = (M, r) if side == "right" else (r, N)
    g, m, v = (torch.from_numpy(x.astype(np.float32)) for x in (
        rng.standard_normal(low), rng.standard_normal(low) * 0.1,
        np.abs(rng.standard_normal(low) * 0.01)))
    u01 = torch.from_numpy(rng.random((M, N), dtype=np.float32))
    return (g, m, v, qp.q, qp.scale, qp.zero, qt.q, qt.scale, u01), qp.block


STRESS_QUANTA = 256


def _stress_lr(args, count, side, pblock):
    """The lr at which lr * gscale * max|U| is STRESS_QUANTA quanta of the
    old scale (the largest): the step then sets the new scales, and a
    direction rounded to bf16 moves codes by more than the 0.999 bar."""
    g, m, v, pq, ps, pz, q, wscale, _ = args
    d = _direction(g, m, v, count)
    u = _u_prime(pq)
    P = ((u.reshape(u.shape[0], -1, pblock) - pz[..., None])
         * ps[..., None]).reshape(u.shape)
    U = d @ P.T if side == "right" else P @ d
    return STRESS_QUANTA * wscale.max().item() / (0.25 * U.abs().max().item())


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("step", ["run", "stress"])
@pytest.mark.parametrize("side,M,N", [("right", 5461 // 43, 512),
                                      ("left", 5461 // 43, 512)])
def test_fused_kernel_arithmetic_matches_plain(side, M, N, step, wd):
    """The CUDA kernel's decomposition (hi/lo bf16 passes on dir, exact u',
    the per-block scale and zero-point epilogue) against the plain version
    at rank 512, pblock 256, 127 rows (ragged against the kernel's 64-row
    tiles): the dequantized weight within one INT8 quantum, codes equal
    on more than 0.999 of the elements, scales within 1e-5 relative. At the
    run's lr (1e-3) and at a stress step, where one pass (hi only) must
    fail the code bar, so that the gate can tell one pass from two."""
    args, pblock = _rank512_problem(M, N, side, seed=N + (side == "left"))
    assert pblock == 256
    count = 3
    lr = 1e-3 if step == "run" else _stress_lr(args, count, side, pblock)
    qw, sw, _, _ = ref.fused_qgalore_update_ref(
        *args, count, lr, side=side, pblock=pblock, wblock=256, wd=wd)
    deq = lambda c, s: (c.float().reshape(M, N // 256, 256) * s[..., None])
    same = {}
    for passes in (2, 1):
        qe, se = _emulate_fused(*args, count, lr, side=side, pblock=pblock,
                                wd=wd, passes=passes)
        same[passes] = (qe == qw).float().mean().item()
        if passes == 2:
            quantum = sw.max().item()
            assert (deq(qe, se) - deq(qw, sw)).abs().max().item() \
                <= quantum + 1e-6
            assert _rel(se.numpy(), sw.numpy()) <= 1e-5
    assert same[2] > 0.999
    if step == "stress":
        assert same[1] < 0.999, same


# ---------------------------------------------------------------------------
# gradients through QVirtual
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lead,K,N", [((2, 17), 96, 300), ((40,), 300, 256)])
def test_quantized_dense_grads_match_jax_vjp(lead, K, N):
    """dL/dx (int8_matmul_t's plain version) and dL/dW (on the shadow)
    against jax.vjp through a QVirtual: 1e-5 of max|ref|."""
    rng = np.random.default_rng(K)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    g_out = rng.standard_normal(lead + (N,)).astype(np.float32)
    jt = _weight(K, N, seed=N, scale=0.1)

    def f(shadow, xx):
        return jops.quantized_dense(xx, jq.QVirtual(jt, shadow),
                                    dtype=jnp.float32, backend="ref")

    _, vjp = jax.vjp(f, jq.virtualize(jt).shadow, jnp.asarray(x))
    dw_ref, dx_ref = vjp(jnp.asarray(g_out))

    qv = tq.virtualize(_t(jt))
    xt = torch.from_numpy(x).requires_grad_(True)
    LAUNCHES.clear()
    out = ops.quantized_dense(xt, qv, dtype=torch.float32)
    assert tuple(out.shape) == lead + (N,)
    dw, dx = torch.autograd.grad(out, [qv.shadow, xt],
                                 torch.from_numpy(g_out))
    assert tuple(dw.shape) == (K, N) and tuple(dx.shape) == lead + (K,)
    assert _rel(dw.numpy(), dw_ref) <= 1e-5
    assert _rel(dx.numpy(), dx_ref) <= 1e-5
    assert LAUNCHES["deq_matmul"] == 1 and LAUNCHES["deq_matmul_t"] == 1


@pytest.mark.parametrize("lead,K,N", [((2, 17), 96, 300), ((40,), 300, 256)])
def test_quantized_dense_hands_dx_the_activation_dtype(lead, K, N,
                                                        monkeypatch):
    """The output cast sits inside the autograd Function: a bf16 call hands
    ``_dx`` (and so ``int8_matmul_t`` on the card) g in bf16, an f32 call
    in f32; dx and dW still match jax.vjp of the same bf16 op within 1e-5
    of max|ref| (the cast's cotangent carries the same values)."""
    rng = np.random.default_rng(K + 1)
    x = rng.standard_normal(lead + (K,)).astype(np.float32)
    g_out = np.asarray(jnp.asarray(rng.standard_normal(lead + (N,)),
                                   jnp.bfloat16))
    jt = _weight(K, N, seed=N + 1, scale=0.1)

    def f(shadow, xx):
        return jops.quantized_dense(xx, jq.QVirtual(jt, shadow),
                                    dtype=jnp.bfloat16, backend="ref")

    _, vjp = jax.vjp(f, jq.virtualize(jt).shadow, jnp.asarray(x))
    dw_ref, dx_ref = vjp(jnp.asarray(g_out))

    seen, real = [], ops._dx

    def rec(g2, qt):
        seen.append(g2.dtype)
        return real(g2, qt)

    monkeypatch.setattr(ops, "_dx", rec)
    qv = tq.virtualize(_t(jt))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = ops.quantized_dense(xt, qv, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == lead + (N,)
    dw, dx = torch.autograd.grad(
        out, [qv.shadow, xt],
        torch.from_numpy(g_out.astype(np.float32)).to(torch.bfloat16))
    assert seen == [torch.bfloat16]
    assert dx.dtype == torch.float32 and dw.dtype == torch.float32
    assert _rel(dw.numpy(), dw_ref) <= 1e-5
    assert _rel(dx.numpy(), dx_ref) <= 1e-5
    # an f32 call hands g over in f32
    out = ops.quantized_dense(xt, qv, dtype=torch.float32)
    torch.autograd.grad(out.sum(), [xt])
    assert seen == [torch.bfloat16, torch.float32]


def test_quantized_dense_plain_qtensor_dx_only():
    """A plain QTensor weight (serving) has no shadow; dL/dx still flows
    when x requires grad, and without grad the forward keeps no graph."""
    jt = _weight(64, 128, seed=7)
    tt = _t(jt)
    x = torch.randn((3, 64), requires_grad=True)
    out = ops.quantized_dense(x, tt, dtype=torch.float32)
    (dx,) = torch.autograd.grad(out.sum(), [x])
    want = tq.dequantize(tt, torch.float32).sum(dim=1)
    torch.testing.assert_close(dx, want.expand(3, -1), rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert ops.quantized_dense(x, tt).grad_fn is None


def test_embed_lookup_grad_is_row_scatter_add():
    """The embedding gradient reaches the shadow as a row scatter-add
    (tests/test_quantized_dense.py's embed_lookup case): 1e-6."""
    rng = np.random.default_rng(14)
    jt = _weight(96, 300, seed=14, scale=0.1)
    tok = rng.integers(0, 96, size=(2, 9)).astype(np.int32)

    def f(shadow):
        out = jlayers.embed_lookup(jq.QVirtual(jt, shadow), jnp.asarray(tok),
                                   jnp.float32)
        return jnp.sum(out ** 2)

    want = jax.grad(f)(jq.virtualize(jt).shadow)
    qv = tq.virtualize(_t(jt))
    out = tlayers.embed_lookup(qv, torch.from_numpy(tok), torch.float32)
    (got,) = torch.autograd.grad((out ** 2).sum(), [qv.shadow])
    assert _rel(got.numpy(), want) <= 1e-6


def test_new_kernel_sources_build_nothing_on_import():
    assert {"int8_matmul", "int8_matmul_t", "fused_update"} <= set(
        build.sources())
    assert "int8_matmul_t" not in build._LOADED
    assert "fused_update" not in build._LOADED
