"""xLSTM (xlstm-125m) against the live JAX package at its smoke config (4
layers: 2 groups of one mLSTM and one sLSTM block, d 64, 2 heads, chunk
16), f32: the chunkwise mLSTM (padded, from an initial state) and the
sLSTM scan, the model's loss, the fused per-layer gradient against the
reference's ``jax.grad``, prefill then decode against the full forward,
the INT8 params' train-and-serve case, the recurrent-state pool (float32
whatever the pool's dtype, written in place), the slot scheduler, the
refusals, the parameter count and the GaLore leaf specs. Both packages
compute on the same INT8 codes (``from_jax_params``) and the reference's
batch; the reference's forward and gradient are each jitted once."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.core import qgalore as jqgalore
from repro.models import base as jbase
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.models import xlstm as jx
from repro.train import stack as jstack
from repro.train import step as jstep
from repro_torch.config import QGaLoreConfig, XLSTMConfig, replace
from repro_torch.core import qgalore
from repro_torch.kernels import LAUNCHES
from repro_torch.models import base, model_zoo, xlstm
from repro_torch.serve import engine
from repro_torch.serve.paged import PagedScheduler
from repro_torch.serve.params import from_jax_params, quantize_leaf
from repro_torch.serve.scheduler import Request, Scheduler, init_pool, \
    insert_requests, make_scheduler
from repro_torch.train import stack

from test_models_smoke import make_batch
from test_torch_serve import _to_numpy
from torch_one_thread import one_thread  # noqa: F401

ARCH = "xlstm-125m"
# 20 tokens: two chunks of 16, the second padded by 12
CELL = JShapeCell("t", seq_len=20, global_batch=2, kind="train")
OP_TOL = 1e-5       # one op at f32
FWD_TOL = 1e-4      # the model's logits and loss
GRAD_TOL = 5e-3     # the reference's per-leaf bar (tests/test_stack.py)


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.fixture(scope="module")
def models():
    """Both packages' smoke bundles at f32, the port's float draw
    quantized by the reference's ``prepare_params`` and carried across,
    and the reference's batch."""
    jb = jzoo.build_arch(ARCH, smoke=True, dtype=jnp.float32)
    tb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32)
    flt = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()),
        tb.init_params(torch.Generator().manual_seed(1)))
    jp = jax.jit(lambda p: jstep.prepare_params(p, JQGaLoreConfig(),
                                                jnp.float32))(flt)
    jbatch = make_batch(jb, CELL)
    tp = from_jax_params(_to_numpy(jp), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jb, jp, jbatch, tb, tp, tbatch


@pytest.fixture(scope="module")
def ref_forward(models):
    """The reference's loss, metrics and logits at every position (one
    jitted forward; the recurrence is causal, so position t's logits are
    those of the first t + 1 tokens), and its ``jax.grad`` (one jit)."""
    jb, jp, jbatch, _, _, _ = models

    def fwd(p, b):
        carry, ctx = jb.embed(p, b)
        carry = jbase.run_segments(jb, p, carry, ctx)
        loss, metrics = jb.head_loss(p, carry, b)
        h = jlayers.rmsnorm(carry["h"], p["final_norm"], jb.cfg.rmsnorm_eps)
        return loss, metrics, jlayers.dense(h, p["head"], jnp.float32)

    loss, metrics, logits = jax.jit(fwd)(jp, jbatch)
    grads = jax.jit(lambda p, b: jstack.simple_value_and_grad(jb, p, b))(
        jp, jbatch)
    return loss, metrics, np.asarray(logits), grads


# ---------------------------------------------------------------------------
# the recurrent cores
# ---------------------------------------------------------------------------

def _mlstm_inputs(rng, B=2, S=21, H=2, d=8):
    q, k, v = (rng.standard_normal((B, S, H, d)).astype(np.float32)
               for _ in range(3))
    logi = rng.standard_normal((B, S, H)).astype(np.float32)
    logf = np.log(1 / (1 + np.exp(-rng.standard_normal((B, S, H))
                                  - 2.0))).astype(np.float32)
    init = (rng.standard_normal((B, H, d, d)).astype(np.float32),
            rng.standard_normal((B, H, d)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))
    return (q, k, v, logi, logf), init


@pytest.mark.parametrize("initial", [False, True])
def test_mlstm_chunked_matches_reference(initial):
    """``mlstm_chunked`` at S 21 and chunk 8 (three chunks, the last padded
    by 3), from the empty state or a given one: h and the final (C, n, m)
    against the reference's chunked form and against both sequential
    oracles (``mlstm_reference``, ``mlstm_step``), within 1e-5 of
    max|ref|."""
    rng = np.random.default_rng(11)
    args, init = _mlstm_inputs(rng)
    jinit = jx.MLSTMState(*map(jnp.asarray, init)) if initial else None
    tinit = xlstm.MLSTMState(*map(torch.from_numpy, init)) if initial \
        else None
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    want_h, want_st = jax.jit(lambda *a: jx.mlstm_chunked(
        *a, chunk=8, initial=jinit))(*jargs)
    got_h, got_st = xlstm.mlstm_chunked(*targs, chunk=8, initial=tinit)
    oracle_h, oracle_st = xlstm.mlstm_reference(*targs, initial=tinit)
    joracle_h, _ = jx.mlstm_reference(*jargs, initial=jinit)
    assert tuple(got_h.shape) == tuple(want_h.shape) == (2, 21, 2, 8)
    assert _maxerr(got_h.numpy(), want_h) < OP_TOL
    assert _maxerr(oracle_h.numpy(), joracle_h) < OP_TOL
    assert _maxerr(got_h.numpy(), oracle_h.numpy()) < OP_TOL
    # the stabilizer differs between the forms, the state it scales not
    for g, w, o in zip(got_st, want_st, oracle_st):
        assert _maxerr(g.numpy(), w) < OP_TOL
    scale = torch.exp(got_st.m - oracle_st.m)
    assert _maxerr((got_st.C * scale[..., None, None]).numpy(),
                   oracle_st.C.numpy()) < OP_TOL
    assert _maxerr((got_st.n * scale[..., None]).numpy(),
                   oracle_st.n.numpy()) < OP_TOL


def test_slstm_scan_matches_reference():
    """``slstm_scan`` over 9 steps from a given state (and from
    ``slstm_init_state``) against the reference's, 1e-5 of max|ref|."""
    rng = np.random.default_rng(12)
    B, S, H, dh = 2, 9, 2, 8
    D = H * dh
    gx = rng.standard_normal((B, S, 4 * D)).astype(np.float32)
    R = (rng.standard_normal((4, H, dh, dh)) / math.sqrt(dh)) \
        .astype(np.float32)
    st = [rng.standard_normal((B, D)).astype(np.float32) for _ in range(4)]
    st[1] = np.abs(st[1]) + 0.5
    for given in (True, False):
        jst = jx.SLSTMState(*map(jnp.asarray, st)) if given \
            else jx.slstm_init_state(B, D)
        tst = xlstm.SLSTMState(*map(torch.from_numpy, st)) if given \
            else xlstm.slstm_init_state(B, D)
        want_h, want_f = jax.jit(lambda g, r, s: jx.slstm_scan(g, r, s, H))(
            jnp.asarray(gx), jnp.asarray(R), jst)
        got_h, got_f = xlstm.slstm_scan(torch.from_numpy(gx),
                                        torch.from_numpy(R), tst, H)
        assert _maxerr(got_h.numpy(), want_h) < OP_TOL
        for g, w in zip(got_f, want_f):
            assert _maxerr(g.numpy(), w) < OP_TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_forward_loss_matches(models, ref_forward):
    """``test_models_smoke.py``'s forward case: the loss at random init
    near log(vocab), and equal to the reference's (1e-4), as are the last
    logits."""
    _, _, _, tb, tp, tbatch = models
    jl, jm, logits, _ = ref_forward
    with torch.no_grad():
        loss, metrics = base.loss_fn(tb, tp, tbatch)
        c, ctx = tb.embed(tp, tbatch)
        got = tb.head_logits(tp, base.run_segments(tb, tp, c, ctx))
    expect = np.log(tb.cfg.vocab_size)
    assert 0.2 * expect < float(loss) < 3.0 * expect + 1.0
    assert float(loss) == pytest.approx(float(jl), rel=FWD_TOL)
    assert float(metrics["accuracy"]) <= 1.0
    assert _maxerr(got.numpy(), logits[:, -1:]) < FWD_TOL
    assert [s.name for s in tb.segments] == ["xlstm"]
    assert tb.segments[0].n_layers == 2


def test_fused_grad_matches_jax_grad(models, ref_forward):
    """``test_stack.py::test_fused_matches_simple_fullrank`` and the
    gradient half of ``test_models_smoke.py``: the port's per-layer
    recompute backward (one group, an mLSTM and an sLSTM block, a layer)
    against the reference's ``jax.grad`` leaf by leaf (5e-3), every
    gradient finite, the norm positive."""
    _, _, _, tb, tp, tbatch = models
    (jl, _), jg = ref_forward[3]
    (tl, _), tg = stack.fused_value_and_grad(tb, tp, tbatch, {})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    flat = qgalore.flatten(tg)
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(flat) == len(leaves) > 3
    for (keys, g), want in zip(flat, leaves):
        assert torch.isfinite(g).all(), keys
        assert tuple(g.shape) == tuple(want.shape), keys
        assert _maxerr(g.numpy(), want) <= GRAD_TOL, keys
    assert sum(float((g ** 2).sum()) for _, g in flat) > 0


def test_prefill_then_decode_matches_full_forward(models, ref_forward):
    """``test_serve.py::test_decode_matches_full_forward``: a prefill of 8
    tokens (its states as they are, no time axis grown), then teacher-
    forced decode to 20 tokens, against the reference's full-sequence
    logits at each length (2e-3 after the prefill, 5e-3 a step)."""
    _, _, jbatch, tb, tp, _ = models
    toks = np.array(jbatch["tokens"])
    B, S = toks.shape
    prompt = 8
    logits, state = engine.build_prefill(tb, S + 4)(
        tp, {"tokens": torch.from_numpy(toks[:, :prompt])})
    shapes = tb.segments[0].cache_shapes(B, S + 4)
    got = state.caches["seg0_xlstm"]
    assert [tuple(c.shape) for c in got] == [(2,) + s for s, _ in shapes]
    assert all(c.dtype == torch.float32 for c in got)
    assert _maxerr(logits[:, -1].numpy(), ref_forward[2][:, prompt - 1]) \
        < 2e-3
    decode = engine.build_decode(tb)
    for t in range(prompt, S):
        logits, state = decode(tp, state, torch.from_numpy(toks[:, t: t + 1]))
        assert _maxerr(logits[:, -1].numpy(), ref_forward[2][:, t]) < 5e-3, t


def test_quantized_params_train_and_serve(models):
    """``tests/test_quantized_dense.py``'s families case for xLSTM: the
    INT8 params (stacked norms, ``r_gates`` and the sLSTM ``gate_bias``
    quantized; the mLSTM ``w_gates`` and ``gate_bias`` float) train and
    serve with finite numbers, every matmul through the INT8 op."""
    _, _, _, tb, tp, tbatch = models
    grp = tp["seg0_xlstm"]
    assert type(grp["slstm"]["r_gates"]).__name__ == "QTensor"
    assert type(grp["mlstm"]["norm"]).__name__ == "QTensor"
    assert type(grp["slstm"]["gate_bias"]).__name__ == "QTensor"
    assert isinstance(grp["mlstm"]["w_gates"], torch.Tensor)
    (loss, _), grads = stack.fused_value_and_grad(tb, tp, tbatch, {})
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for _, g in qgalore.flatten(grads))
    toks = tbatch["tokens"]
    prompt = toks.shape[1] // 2
    logits, state = engine.build_prefill(tb, toks.shape[1] + 2)(
        tp, {"tokens": toks[:, :prompt]})
    assert torch.isfinite(logits).all()
    LAUNCHES.clear()
    logits, _ = engine.build_decode(tb)(tp, state,
                                        toks[:, prompt: prompt + 1])
    assert torch.isfinite(logits).all()
    # a group streams w_up, wq, wk, wv, w_down (mLSTM) and w_gates and the
    # FFN's three (sLSTM); then the head
    assert dict(LAUNCHES) == {"deq_matmul": 2 * (5 + 4) + 1}


def test_pool_keeps_states_float32_and_decode_writes_in_place(models):
    """A bf16 slot pool holds the seven state leaves in float32 (trap: a
    pool of one dtype would round the state every step); a prefill's rows
    go in unrounded; two decode steps write the pool's own tensors."""
    _, _, jbatch, tb, tp, _ = models
    bf = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.bfloat16)
    pool = init_pool(bf, 3, 16, torch.bfloat16, "cpu")
    leaves = pool.caches["seg0_xlstm"]
    assert len(leaves) == 7
    assert all(c.dtype == torch.float32 for c in leaves)
    cfg = tb.cfg
    dh = int(cfg.xlstm.proj_factor * cfg.d_model) // cfg.num_heads
    assert tuple(leaves[0].shape) == (2, 3, 1, cfg.num_heads, dh, dh)
    assert tuple(leaves[3].shape) == (2, 3, cfg.d_model)

    toks = torch.from_numpy(np.array(jbatch["tokens"]))
    pool = init_pool(tb, 3, 16, torch.float32, "cpu")
    _, rows = engine.build_prefill(tb, 16)(tp, {"tokens": toks[:, :6]})
    insert_requests(pool, [2, 0], rows)
    for p, r in zip(pool.caches["seg0_xlstm"], rows.caches["seg0_xlstm"]):
        assert torch.equal(p[:, [2, 0]], r)
        assert not p[:, 1].any()
    decode = engine.build_decode(tb)
    ids = [id(c) for c in pool.caches["seg0_xlstm"]]
    before = [c.clone() for c in pool.caches["seg0_xlstm"]]
    tok = torch.zeros((3, 1), dtype=torch.int32)
    tok[2], tok[0] = toks[0, 6], toks[1, 6]
    for step in range(2):
        _, pool = decode(tp, pool, tok)
        assert [id(c) for c in pool.caches["seg0_xlstm"]] == ids
        now = pool.caches["seg0_xlstm"]
        assert all(not torch.equal(a[:, [2, 0]], b[:, [2, 0]])
                   for a, b in zip(now, before)), step
        before = [c.clone() for c in now]


def test_prefill_refuses_pad_id(models):
    """``test_scheduler.py::test_prefill_rejects_pad_id_on_unsafe_bundle``."""
    tb = models[3]
    assert not tb.ragged_prefill_ok
    with pytest.raises(ValueError, match="ragged_prefill_ok"):
        engine.build_prefill(tb, max_len=16, pad_id=0)


def test_scheduler_unpadded_admission_matches_generate(models):
    """``test_scheduler.py::test_scheduler_recurrent_family_unpadded_
    admission``: the slot scheduler (one unpadded request a prefill) emits
    per-request ``generate``'s tokens."""
    _, _, _, tb, tp, _ = models
    rng = np.random.default_rng(6)
    reqs = [Request(rid=r, tokens=rng.integers(
        1, tb.cfg.vocab_size, size=int(rng.integers(3, 10))).astype(
            np.int32), max_new_tokens=int(rng.integers(2, 5)))
        for r in range(3)]
    sched = Scheduler(tb, tp, num_slots=2, max_len=16, dtype=torch.float32,
                      prompt_bucket=8, device="cpu")
    comps = {c.rid: c for c in sched.run(reqs)}
    assert sched.stats["prefills"] == 3
    for r in reqs:
        out, _ = engine.generate(
            tb, tp, {"tokens": torch.from_numpy(r.tokens)[None]},
            steps=r.max_new_tokens - 1, max_len=16, device="cpu")
        assert comps[r.rid].tokens == out[0].tolist(), f"rid {r.rid}"


def test_append_and_paged_refused(models):
    """``test_paged.py::test_append_rejected_for_non_append_bundles``: no
    chunk-append, the paged scheduler refuses the bundle, and
    ``make_scheduler("auto")`` gives the slot scheduler."""
    _, _, _, tb, tp, _ = models
    assert not engine.append_ok(tb)
    with pytest.raises(ValueError, match="chunk-append"):
        engine.build_append(tb, 32)
    with pytest.raises(ValueError, match="paged serving"):
        PagedScheduler(tb, None, num_slots=2, max_len=32, device="cpu")
    sched = make_scheduler(tb, tp, backend="auto", num_slots=2, max_len=32,
                           dtype=torch.float32, device="cpu")
    assert type(sched) is Scheduler


def test_refusals_by_name():
    """``split_layers`` (the reference's message), ``flash_attention`` (no
    attention to route) and a nonzero ``mlstm_head_dim`` (the reference
    ignores it) are refused by name."""
    cfg = model_zoo.get_config(ARCH, smoke=True)
    with pytest.raises(ValueError,
                       match="split_layers unsupported for family xlstm"):
        model_zoo.build(cfg, device="cpu", split_layers=1)
    with pytest.raises(ValueError, match="flash_attention"):
        model_zoo.build(cfg, device="cpu", flash_attention=True)
    bad = replace(cfg, xlstm=XLSTMConfig(slstm_every=2, mlstm_head_dim=32,
                                         chunk_size=16))
    with pytest.raises(NotImplementedError, match="mlstm_head_dim 32"):
        model_zoo.build(bad, device="cpu")


def test_param_count_and_by_layer_draw():
    """``test_models_smoke.py``'s counts: the smoke model's is positive,
    and the full config's, drawn on the meta device, equals the
    reference's ``count_params_analytic`` and lies in 0.1-0.2 G. A
    by-layer draw gives the default draw's tree, each group mapped as the
    whole stack would be."""
    cfg = model_zoo.get_config(ARCH)
    got = model_zoo.count_params(cfg)
    assert got == jzoo.count_params_analytic(jzoo.get_config(ARCH))
    assert 0.1e9 <= got <= 0.2e9
    smoke = model_zoo.get_config(ARCH, smoke=True)
    assert model_zoo.count_params(smoke) > 1000
    tb = model_zoo.build(smoke, device="cpu", dtype=torch.float32)
    flt = tb.init_params(torch.Generator().manual_seed(4), by_layer=True)
    q = tb.init_params(torch.Generator().manual_seed(4),
                       leaf_fn=lambda _, t: quantize_leaf(t), by_layer=True)
    whole = tb.init_params(torch.Generator().manual_seed(4))
    fl, ql, wl = (qgalore.flatten(t) for t in (flt, q, whole))
    assert [k for k, _ in fl] == [k for k, _ in ql] == [k for k, _ in wl]
    for (keys, f), (_, qt), (_, w) in zip(fl, ql, wl):
        assert tuple(f.shape) == tuple(w.shape), keys
        want = quantize_leaf(f)
        if want is f:
            assert torch.equal(qt, f), keys
        else:
            assert torch.equal(qt.q, want.q), keys
            assert torch.equal(qt.scale, want.scale), keys


def test_leaf_specs_match_reference(models):
    """The GaLore decisions on the nested group tree (leaves ``(n_groups,
    n_m, K, N)``, the 5-D ``r_gates``, the float ``w_gates``) are the
    reference's: the same projected leaves, sides, ranks and batch axes,
    by its ``min_dim`` rule and no special case."""
    _, jp, _, _, tp, _ = models
    qcfg = dict(rank=8, min_dim=32)
    tspecs = qgalore.leaf_specs(tp, QGaLoreConfig(**qcfg))
    jspecs = jqgalore.leaf_specs(jp, JQGaLoreConfig(**qcfg))
    got = [(s.path, s.galore, s.side, s.rank, tuple(s.batch))
           for s in tspecs]
    want = [(s.path, s.galore, s.side, s.rank, tuple(s.batch))
            for s in jspecs]
    assert got == want
    proj = {p for p, g, *_ in got if g}
    assert "['seg0_xlstm']['slstm']['r_gates']" in proj
    assert "['seg0_xlstm']['mlstm']['wq']" in proj
    assert "['seg0_xlstm']['mlstm']['w_gates']" not in proj
