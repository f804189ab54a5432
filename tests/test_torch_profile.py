"""The port's per-op counters (``repro_torch.kernels.profile``) against
the JAX package's (``repro.kernels.profile``): at the five sites both
record, the same numpy inputs give the same per-call bytes, FLOPs and
shape; a llama-60m smoke training step's rows count what ``LAUNCHES``
counts; nothing is recorded outside ``recording()``; and recording
changes no output and no launch count."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import projector as jproj
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.kernels import profile as jprofile
from repro_torch.config import QGaLoreConfig, TrainConfig
from repro_torch.core import projector as tproj
from repro_torch.core import quant as tq
from repro_torch.core.optimizers import preset
from repro_torch.kernels import LAUNCHES, ops, profile
from repro_torch.models import model_zoo
from repro_torch.train.trainer import Trainer
from torch_one_thread import one_thread  # noqa: F401


def _t(jt) -> tq.QTensor:
    """A JAX QTensor as the port's, the same codes."""
    return tq.from_numpy((np.asarray(jt.q), np.asarray(jt.scale),
                          None if jt.zero is None else np.asarray(jt.zero),
                          jt.bits, jt.block, jt.orig_last, jt.dtype))


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture
def ref_profile(monkeypatch):
    """The reference's counters on, from empty (its switch is read at
    call time)."""
    monkeypatch.setenv("REPRO_PROFILE", "1")
    jprofile.reset()
    profile.reset()
    yield
    jprofile.reset()
    profile.reset()


def _both(op, run_ref, run_port):
    run_ref()
    with profile.recording():
        run_port()
    want, got = jprofile.snapshot()[op], profile.snapshot()[op]
    assert (got["bytes_per_call"], got["flops_per_call"]) == \
        (want["bytes_per_call"], want["flops_per_call"]), op
    assert got["meta"]["shape"] == want["meta"]["shape"], op
    assert got["calls"] == 1 and got["bytes"] == got["bytes_per_call"]
    return got


DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("M,K,N", [(5, 96, 300)])
def test_int8_sites_match_reference(ref_profile, jdt, tdt, M, K, N):
    """``int8_matmul``, ``quantized_dense/fwd`` and ``quantized_dense/dx``
    (the reference's count, the forward's roles), K != N and N padded."""
    w = _normal((K, N), 1, 0.05)
    jt = jq.quantize_blockwise(jnp.asarray(w), 8, symmetric=True)
    qt = _t(jt)
    x, g = _normal((M, K), 2), _normal((M, N), 3)
    jx, jg = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    tx, tg = torch.from_numpy(x).to(tdt), torch.from_numpy(g).to(tdt)
    got = _both("int8_matmul", lambda: jops.int8_matmul(jx, jt,
                                                         backend="ref"),
                lambda: ops.int8_matmul(tx, qt))
    assert got["kernel"] == "deq_matmul" and got["peak"] == "bf16"
    _both("quantized_dense/fwd",
          lambda: jops._i8_call("ref", jx, jt.q, jt.scale, jt.block,
                                jt.orig_last),
          lambda: ops._fwd(tx, qt))
    got = _both("quantized_dense/dx",
                lambda: jops._i8t_call("ref", jg, jt.q, jt.scale, jt.block),
                lambda: ops._dx(tg, qt))
    assert got["kernel"] == "deq_matmul_t"


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("M,K,r,block", [(33, 200, 12, 8)])
def test_int4_project_matches_reference(ref_profile, jdt, tdt, M, K, r,
                                        block):
    """``int4_project``, the packed rank padded past the real one (12 →
    16)."""
    P = _normal((K, r), 4)
    jp = jproj.quantize_projection(jnp.asarray(P), 4, block)
    g = _normal((M, K), 5)
    got = _both("int4_project",
                lambda: jops.int4_project(jnp.asarray(g, jdt), jp,
                                          backend="ref"),
                lambda: ops.int4_project(torch.from_numpy(g).to(tdt),
                                         _t(jp)))
    assert got["kernel"] == "int4_matmul_ref"


@pytest.mark.parametrize("m,n,r,block", [(300, 48, 8, 8), (48, 300, 12, 8)])
def test_fused_update_matches_reference(ref_profile, m, n, r, block):
    """``fused_qgalore_update`` on both sides, n padded to the block and
    the rank padded to the projection's block (the reference's count:
    the triple padded on the rank alone, P unpadded)."""
    side = "right" if m >= n else "left"
    d = n if side == "right" else m
    w = _normal((m, n), 6, 0.05)
    jw = jq.quantize_blockwise(jnp.asarray(w), 8, symmetric=True)
    P = np.linalg.qr(_normal((d, r), 7))[0].astype(np.float32)
    jp = jproj.quantize_projection(jnp.asarray(P), 4, block)
    tp = tproj.quantize_projection(torch.from_numpy(P), 4, block)
    low_shape = (m, r) if side == "right" else (r, n)
    low = _normal(low_shape, 8, 1e-2)
    m32 = _normal(low_shape, 9, 1e-3)
    v32 = np.abs(_normal(low_shape, 10, 1e-4))
    u01 = np.random.default_rng(11).random(jw.q.shape, dtype=np.float32)
    kw = dict(side=side, gscale=0.25)
    got = _both(
        "fused_qgalore_update",
        lambda: jops.fused_qgalore_update(
            jw, jnp.asarray(low), jnp.asarray(m32), jnp.asarray(v32), jp, 1,
            1e-3, jax.random.PRNGKey(0), backend="ref", **kw),
        lambda: ops.fused_qgalore_update(
            _t(jw), torch.from_numpy(low), torch.from_numpy(m32),
            torch.from_numpy(v32), tp, 1, 1e-3, torch.from_numpy(u01),
            **kw))
    assert got["kernel"] == "fused_qgalore_update_ref"
    assert got["meta"]["rank"] == jprofile.snapshot()[
        "fused_qgalore_update"]["meta"]["rank"]


def test_port_only_sites_use_the_kernel_counts():
    """The sites the reference does not record count as
    ``profile.*_cost`` and ``*_bytes`` say, per call and summed."""
    profile.reset()
    gen = torch.Generator().manual_seed(0)
    w = tq.quantize_blockwise(torch.randn((3, 64, 300), generator=gen), 8,
                              symmetric=True)
    x = torch.randn((3, 5, 64), generator=gen)
    q = torch.randn((2, 20, 4, 16), generator=gen)
    kv = torch.randn((2, 20, 2, 16), generator=gen)
    w2 = tq.quantize_blockwise(torch.randn((40, 300), generator=gen), 8,
                               symmetric=True)
    with profile.recording():
        ops.quantized_dense_batched(x, w, dtype=torch.float32)
        ops.quantized_dense_batched(x, w, dtype=torch.float32)
        ops.flash_attention(q, kv, kv)
        ops.sr_requant_update(w2, torch.zeros((40, 300)),
                              torch.rand(w2.q.shape, generator=gen))
        ops.quantize_int8(torch.randn((40, 300), generator=gen))
    snap = profile.snapshot()
    fwd = snap["quantized_dense_batched/fwd"]
    assert fwd["calls"] == 2 and fwd["kernel"] == "deq_matmul_batched"
    assert (fwd["flops_per_call"], fwd["bytes_per_call"]) == \
        profile.batched_cost(3, 5, 64, 512, 4)
    assert (fwd["bytes"], fwd["flops"]) == (2 * fwd["bytes_per_call"],
                                            2 * fwd["flops_per_call"])
    fl = snap["flash_attention"]
    assert (fl["flops_per_call"], fl["bytes_per_call"]) == \
        profile.flash_cost(2, 20, 4, 2, 16, 16, True, 4)
    assert fl["kernel"] == "flash_attention_ref"
    assert snap["sr_requant_update"]["bytes"] == \
        profile.sr_requant_bytes(40, 512)
    assert snap["sr_requant_update"]["peak"] is None
    assert snap["quantize_int8"]["bytes"] == \
        profile.blockwise_quant_bytes(40, 512)
    assert snap["quantize_int8"]["kernel"] == "blockwise_quant_ref"
    out = {}
    profile.maybe_attach(out)
    assert out["profile"] == snap
    profile.reset()
    out = {}
    profile.maybe_attach(out)
    assert out == {}


def _trainer():
    qcfg = preset("qgalore", QGaLoreConfig(rank=8, min_dim=32,
                                           update_interval=4))
    tcfg = TrainConfig(seed=0, global_batch=4, seq_len=32, steps=2,
                       learning_rate=1e-2, warmup_steps=1, log_every=0)
    bundle = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                  dtype=torch.float32)
    return Trainer(bundle, tcfg, qcfg)


def _flat(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _flat(t[k])]
    if isinstance(t, tq.QTensor):
        return [t.q, t.scale] + ([] if t.zero is None else [t.zero])
    return [t] if isinstance(t, torch.Tensor) else []


@pytest.fixture(scope="module")
def two_runs():
    """The same two-step llama-60m smoke run twice: the steady step 1
    without, then with, a recording (step 0, the refresh, outside)."""
    profile.reset()
    runs = []
    for rec in (False, True):
        tr = _trainer()
        tr.run(1)
        LAUNCHES.clear()
        profile.reset()
        if rec:
            with profile.recording():
                hist = tr.run(2)
        else:
            hist = tr.run(2)
        runs.append({"loss": hist[-1]["loss"], "launches": dict(LAUNCHES),
                     "snapshot": profile.snapshot(),
                     "params": _flat(tr.state.params)})
    profile.reset()
    return runs


def test_training_step_rows_count_the_launches(two_runs):
    """Every launch of a steady step goes through a recorded site, and
    the rows' calls summed by kernel are ``LAUNCHES``."""
    rec = two_runs[1]
    counts = {k: v for k, v in rec["launches"].items() if v}
    assert profile.launches_by_kernel(rec["snapshot"]) == counts
    assert set(counts) == {"deq_matmul", "deq_matmul_t",
                           "fused_qgalore_update_ref"}
    snap = rec["snapshot"]
    assert snap["quantized_dense/fwd"]["calls"] == counts["deq_matmul"]
    assert snap["fused_qgalore_update"]["calls"] == \
        counts["fused_qgalore_update_ref"]


def test_nothing_recorded_outside_recording(two_runs):
    assert two_runs[0]["snapshot"] == {}
    x = torch.randn((4, 64))
    qt = tq.quantize_blockwise(torch.randn((64, 256)), 8, symmetric=True)
    profile.reset()
    ops.quantized_dense(x, qt)
    assert profile.snapshot() == {} and not profile.enabled()
    with profile.recording():
        with profile.recording():
            assert profile.enabled()
        assert profile.enabled()
        with profile.timed("host"):
            ops.quantized_dense(x, qt)
    assert not profile.enabled()
    snap = profile.snapshot()
    assert snap["host"]["wall_calls"] == 1 and snap["host"]["wall_us"] > 0
    assert snap["quantized_dense/fwd"]["calls"] == 1
    profile.reset()


def test_recording_changes_no_output_or_launch(two_runs):
    plain, rec = two_runs
    assert rec["loss"] == plain["loss"]
    assert rec["launches"] == plain["launches"]
    assert len(rec["params"]) == len(plain["params"])
    for a, b in zip(rec["params"], plain["params"]):
        assert torch.equal(a, b)
