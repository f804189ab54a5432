"""The port's Q-GaLore training path against the JAX package on llama-60m
smoke, both packages in one process and starting from the same state
(the JAX init, carried across by ``from_jax_state``): the optimizer's
pieces, the fused per-layer backward, one optimizer step (refresh and
steady) with the reference's own SR uniforms, the subspace controller, and
a live 16-step trajectory.

Two things cannot be shared and are handed across instead: the
``jax.random`` draws (stochastic rounding, batches), which the tests feed
to the port, and the column signs of LAPACK's singular vectors, which the
trajectory and refresh tests align to the reference's through the port's
test-only ``qgalore.SUBSPACE_HOOK`` before INT4 quantization."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.config import TrainConfig as JTrainConfig
from repro.core import adam8bit as jadam
from repro.core import adaptive as jadaptive
from repro.core import optimizers as jopt
from repro.core import projector as jproj
from repro.core import qgalore as jqg
from repro.core import quant as jq
from repro.core import transform as jtransform
from repro.data import synthetic as jsyn
from repro.models import model_zoo as jzoo
from repro.train import stack as jstack
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
from repro_torch.core import adam8bit, adaptive, optimizers, projector
from repro_torch.core import qgalore, quant
from repro_torch.core.rules import ParamGroup, ParamRules
from repro_torch.data import synthetic
from repro_torch.kernels import LAUNCHES
from repro_torch.models import base, model_zoo
from repro_torch.serve.params import from_jax_state
from repro_torch.train import stack, step
from repro_torch.train.trainer import Trainer
from torch_one_thread import one_thread  # noqa: F401

# the configuration of tests/test_golden.py
QCFG_KW = dict(rank=8, min_dim=32, update_interval=4, adaptive_k=1,
               cos_threshold=0.3)
TCFG_KW = dict(seed=0, global_batch=4, seq_len=32, learning_rate=1e-2,
               warmup_steps=2, grad_clip=1.0, log_every=0)


def _jcfg():
    return jopt.preset("qgalore", JQGaLoreConfig(**QCFG_KW))


def _tcfg():
    return optimizers.preset("qgalore", QGaLoreConfig(**QCFG_KW))


# ---------------------------------------------------------------------------
# hand-over helpers
# ---------------------------------------------------------------------------

def _is_q(x):
    return isinstance(x, jq.QTensor)


def _np_leaf(x):
    if _is_q(x):
        return (np.asarray(x.q), np.asarray(x.scale),
                None if x.zero is None else np.asarray(x.zero), x.bits,
                x.block, x.orig_last, x.dtype)
    return np.asarray(x)


def jax_state_np(state) -> dict:
    """A JAX TrainState as the numpy trees ``from_jax_state`` takes."""
    return {
        "params": jax.tree_util.tree_map(_np_leaf, state.params,
                                         is_leaf=_is_q),
        "inner": jax.tree_util.tree_map(
            lambda a: (_np_leaf(a.m), _np_leaf(a.v)), state.opt.inner,
            is_leaf=lambda x: isinstance(x, jadam.Adam8bitState)),
        "proj": jax.tree_util.tree_map(
            lambda p: None if p is None else _np_leaf(p), state.opt.proj,
            is_leaf=lambda x: x is None or _is_q(x)),
        "count": int(state.opt.count)}


def jax_uniforms(seed: int):
    """The reference's SR draws: ``fold_in(fold_in(fold_in(PRNGKey(seed +
    17), step), leaf_idx), layer)`` (trainer.py, qgalore.py), uniform over
    the codes' shape."""
    base_key = jax.random.PRNGKey(seed + 17)

    def draw(step_idx, leaf_idx, layer, shape):
        k = jax.random.fold_in(jax.random.fold_in(base_key, step_idx),
                               leaf_idx)
        if layer is not None:
            k = jax.random.fold_in(k, layer)
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, jnp.float32)))
    return draw


def jax_batches(jbundle, cell, seed):
    def batch(s):
        b = jsyn.batch_for_bundle(jbundle, cell, s, seed)
        return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    return batch


def align_signs_to_jax(path, g, P_new, units=None):
    """Flip each fresh singular vector to the sign the JAX package's SVD
    gives for the same gradient (test-only ``SUBSPACE_HOOK``)."""
    side = projector.galore_side(tuple(g.shape))
    out = P_new.clone()
    for i in range(g.shape[0]):
        want = np.asarray(jproj.compute_subspace(
            jnp.asarray(g[i].numpy()), P_new.shape[-1], side))
        s = np.sign((out[i].numpy() * want).sum(axis=0))
        s[s == 0] = 1.0
        out[i] *= torch.from_numpy(s.astype(np.float32))
    return out


@pytest.fixture
def aligned_svd(monkeypatch):
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", align_signs_to_jax)


def _deq(x):
    if isinstance(x, quant.QTensor):
        return quant.dequantize(x, torch.float32).numpy()
    if _is_q(x):
        return np.asarray(jq.dequantize(x, jnp.float32))
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() \
        / max(np.abs(want).max(), 1e-30)


def _leaves(tree):
    return [l for _, l in qgalore.flatten(tree)]


def _jleaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=_is_q)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                              dtype=torch.float32)
    return jb, tb


@pytest.fixture(scope="module")
def init(models):
    """The JAX init (params, optimizer state with random-orthonormal P),
    carried across to the port, and the batch of step 0 in both forms."""
    jb, tb = models
    jstate = jstep.init_state(jb, _jcfg(), jax.random.PRNGKey(0),
                              jnp.float32)
    tstate = from_jax_state(jax_state_np(jstate), device="cpu")
    cell = JShapeCell("golden", 32, 4, "train")
    jbatch = jsyn.batch_for_bundle(jb, cell, 0, 0)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jstate, tstate, jbatch, tbatch


def _jax_proj_trees(jb, opt):
    """The projection trees of a JAX steady step (train/step.py)."""
    seg_keys = [jb.seg_key(i) for i in range(len(jb.segments))]
    out = {}
    for k, sub in opt.proj.items():
        leaves = jax.tree_util.tree_leaves(
            sub, is_leaf=lambda x: x is None or _is_q(x))
        if k in seg_keys or any(l is not None for l in leaves):
            out[k] = sub
    return out


def _port_proj_trees(tstate):
    return qgalore.unflatten([k for k, _ in qgalore.flatten(
        tstate.params)], tstate.opt.proj)


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------

def test_from_jax_state_carries_every_leaf(init):
    jstate, tstate, _, _ = init
    j_inner = jax.tree_util.tree_leaves(
        jstate.opt.inner, is_leaf=lambda x: isinstance(x, jadam.Adam8bitState))
    assert len(tstate.opt.inner) == len(j_inner) == len(tstate.opt.proj)
    for (_, tp), jp in zip(qgalore.flatten(tstate.params),
                           _jleaves(jstate.params)):
        if _is_q(jp):
            np.testing.assert_array_equal(tp.q.numpy(), np.asarray(jp.q))
        else:
            np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    j_proj = jax.tree_util.tree_leaves(
        jstate.opt.proj, is_leaf=lambda x: x is None or _is_q(x))
    for tp, jp in zip(tstate.opt.proj, j_proj):
        assert (tp is None) == (jp is None)
        if jp is not None:
            assert tp.bits == 4 and tp.zero is not None
            np.testing.assert_array_equal(tp.q.numpy(), np.asarray(jp.q))
    assert tstate.opt.count == 0


def test_leaf_specs_match(init):
    jstate, tstate, _, _ = init
    want = jqg.leaf_specs(jstate.params, _jcfg())
    got = qgalore.leaf_specs(tstate.params, _tcfg())
    assert [(s.path, s.shape, s.galore, s.side, s.rank, s.batch)
            for s in got] == [(s.path, s.shape, s.galore, s.side, s.rank,
                               s.batch) for s in want]
    # the head is a GaLore leaf, the embedding is not
    galore = {s.path for s in got if s.galore}
    assert "['head']" in galore and "['embedding']" not in galore


def test_prepare_params_and_init_shapes_match(models):
    """The port's own init path: the same structure, INT8 where the JAX
    package quantizes, a random-orthonormal INT4 P per GaLore leaf."""
    jb, tb = models
    jstate = jstep.init_state(jb, _jcfg(), jax.random.PRNGKey(0),
                              jnp.float32)
    tstate = step.init_state(tb, _tcfg(), seed=0)
    for (_, tp), jp in zip(qgalore.flatten(tstate.params),
                           _jleaves(jstate.params)):
        assert isinstance(tp, quant.QTensor) == _is_q(jp)
        assert tuple(tp.shape) == tuple(jp.shape)
    specs = qgalore.leaf_specs(tstate.params, _tcfg())
    for P, spec in zip(tstate.opt.proj, specs):
        if spec.galore:
            Pd = torch.from_numpy(_deq(P)).reshape(
                (spec.nbatch,) + tuple(spec.proj_shape[-2:]))
            eye = Pd.transpose(-1, -2) @ Pd
            assert torch.allclose(eye, torch.eye(spec.rank).expand_as(eye),
                                  atol=0.3)


def test_schedule_and_presets_match():
    t, j = TrainConfig(**TCFG_KW, steps=40), JTrainConfig(**TCFG_KW,
                                                          steps=40)
    for sched in ("cosine", "linear", "constant"):
        tt = TrainConfig(**{**TCFG_KW, "steps": 40, "lr_schedule": sched})
        jj = JTrainConfig(**{**TCFG_KW, "steps": 40, "lr_schedule": sched})
        got = [optimizers.lr_at(s, tt) for s in range(45)]
        want = [jopt.lr_at(s, jj) for s in range(45)]
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert t.steps == j.steps
    for name in jopt.PRESET_OVERRIDES:
        got = optimizers.preset(name, QGaLoreConfig(**QCFG_KW))
        want = jopt.preset(name, JQGaLoreConfig(**QCFG_KW))
        for f in ("enabled", "adam_bits", "weight_bits", "proj_bits",
                  "stochastic_rounding", "adaptive", "rank"):
            assert getattr(got, f) == getattr(want, f), (name, f)
    with pytest.raises(ValueError, match="unknown"):
        optimizers.preset("sgd")


def test_synthetic_lm_shares_the_successor_table():
    cfg = synthetic.DataConfig(vocab_size=512, seq_len=16, global_batch=3,
                               seed=5)
    lm = synthetic.SyntheticLM(cfg)
    jlm = jsyn.SyntheticLM(jsyn.DataConfig(vocab_size=512, seq_len=16,
                                           global_batch=3, seed=5))
    np.testing.assert_array_equal(lm._succ.numpy(), jlm._succ)
    a, b = lm.batch_at(7), lm.batch_at(7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (3, 16) and a["tokens"].dtype == torch.int32
    assert not torch.equal(a["tokens"], lm.batch_at(8)["tokens"])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 512


@pytest.mark.parametrize("shape,symmetric", [((2, 64), True),
                                             ((40, 300), True),
                                             ((3, 5, 256), False)])
def test_requantize_sr_matches_jax(shape, symmetric):
    """The reference's own uniforms, drawn over the codes' shape, drive
    the port's stochastic rounding: the same codes."""
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    upd = rng.standard_normal(shape).astype(np.float32) * 1e-3
    jt = jq.quantize_blockwise(jnp.asarray(w), 8, symmetric=symmetric)
    key = jax.random.PRNGKey(3)
    want = jq.requantize_sr(jt, jnp.asarray(upd), key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, jt.q.shape,
                                                     jnp.float32)))
    tt = quant.from_numpy(_np_leaf(jt))
    got = quant.requantize_sr(tt, torch.from_numpy(upd), u)
    assert (got.q.numpy() == np.asarray(want.q)).mean() > 0.999
    assert np.abs(_deq(got) - _deq(want)).max() <= \
        float(np.asarray(want.scale).max()) + 1e-7


@pytest.mark.parametrize("bits", [8, 32])
def test_adam8bit_update_matches_jax(bits):
    rng = np.random.default_rng(bits)
    shape = (6, 300)
    hj = jadam.AdamHyper(bits=bits)
    ht = adam8bit.AdamHyper(bits=bits)
    sj = jadam.init_state(shape, hj)
    st = adam8bit.init_state(shape, ht)
    for count in (1, 2, 3):
        g = rng.standard_normal(shape).astype(np.float32)
        dj, sj = jadam.update(jnp.asarray(g), sj, jnp.int32(count), hj)
        dt, st = adam8bit.update(torch.from_numpy(g), st, count, ht)
        assert _rel(dt.numpy(), dj) <= 1e-5
        for a, b in ((st.m, sj.m), (st.v, sj.v)):
            np.testing.assert_allclose(_deq(a), _deq(b), rtol=0, atol=1e-6)


def test_projector_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((48, 32), (32, 80)):
        G = rng.standard_normal(shape).astype(np.float32)
        side = projector.galore_side(shape)
        assert side == jproj.galore_side(shape)
        assert projector.lowrank_shape(shape, 8) == \
            jproj.lowrank_shape(shape, 8)
        Pt = projector.compute_subspace(torch.from_numpy(G), 8, side)
        Pj = np.array(jproj.compute_subspace(jnp.asarray(G), 8, side))
        # the same subspace, whatever the column signs
        assert float(projector.subspace_similarity(
            Pt, torch.from_numpy(Pj))) == pytest.approx(1.0, abs=1e-5)
        low = projector.project(torch.from_numpy(G), torch.from_numpy(Pj),
                                side)
        assert _rel(low.numpy(), jproj.project(jnp.asarray(G),
                                               jnp.asarray(Pj), side)) < 1e-5
        back = projector.project_back(low, torch.from_numpy(Pj), side)
        assert _rel(back.numpy(), jproj.project_back(
            jproj.project(jnp.asarray(G), jnp.asarray(Pj), side),
            jnp.asarray(Pj), side)) < 1e-5
        qt = projector.quantize_projection(torch.from_numpy(Pj), 4, 256)
        qj = jproj.quantize_projection(jnp.asarray(Pj), 4, 256)
        np.testing.assert_array_equal(qt.q.numpy(), np.asarray(qj.q))
        # the randomized method on the reference's own Gaussian draw
        key = jax.random.PRNGKey(7)
        k, p = projector.omega_shape(shape, 8, side)
        omega = np.array(jax.random.normal(key, (k, p), jnp.float32))
        Pr = projector.compute_subspace(torch.from_numpy(G), 8, side,
                                        "randomized",
                                        torch.from_numpy(omega))
        Pjr = np.array(jproj.compute_subspace(jnp.asarray(G), 8, side,
                                              "randomized", key))
        assert float(projector.subspace_similarity(
            Pr, torch.from_numpy(Pjr))) >= 1 - 1e-5
    with pytest.raises(ValueError, match="omega"):
        projector.compute_subspace(torch.zeros((8, 8)), 2, None,
                                   "randomized")


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    for max_norm in (0.0, 0.5, 100.0):
        want, wn = jtransform.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
        # the port scales the tree in place: hand it copies
        got, gn = qgalore.clip_by_global_norm(
            {"a": torch.from_numpy(tree["a"].copy()),
             "b": {"c": torch.from_numpy(tree["b"]["c"].copy())}}, max_norm)
        assert float(gn) == pytest.approx(float(wn), rel=1e-6)
        assert _rel(got["a"].numpy(), want["a"]) < 1e-6
        assert _rel(got["b"]["c"].numpy(), want["b"]["c"]) < 1e-6


# ---------------------------------------------------------------------------
# the fused backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lowrank", [False, True])
def test_fused_value_and_grad_matches_jax(models, init, lowrank):
    """Loss and every gradient leaf (full-rank at a refresh step, low-rank
    for GaLore leaves at a steady step): 1e-4 of max|ref| a leaf."""
    jb, tb = models
    jstate, tstate, jbatch, tbatch = init
    jtrees = _jax_proj_trees(jb, jstate.opt) if lowrank else {}
    ttrees = _port_proj_trees(tstate) if lowrank else {}
    (jl, _), jg = jstack.fused_value_and_grad(jb, jstate.params, jbatch,
                                              jtrees)
    LAUNCHES.clear()
    (tl, metrics), tg = stack.fused_value_and_grad(tb, tstate.params,
                                                   tbatch, ttrees)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert "accuracy" in metrics
    specs = qgalore.leaf_specs(tstate.params, _tcfg())
    for (keys, g), want, spec in zip(qgalore.flatten(tg),
                                     jax.tree_util.tree_leaves(jg), specs):
        assert tuple(g.shape) == tuple(want.shape), spec.path
        if lowrank and spec.galore:
            assert tuple(g.shape) == spec.low_shape
        assert _rel(g.numpy(), want) <= 1e-4, spec.path
    # 7 dense layers a block + the head: forward, recompute (no head), dx
    n = 7 * tb.cfg.num_layers
    assert LAUNCHES["deq_matmul"] == 2 * n + 1
    assert LAUNCHES["deq_matmul_t"] == n + 1


def test_fused_backward_matches_whole_graph_autograd(models, init):
    """The per-layer recompute backward against autograd over the whole
    graph (base.loss_fn) in the port itself."""
    _, tb = models
    _, tstate, _, tbatch = init
    (loss, _), grads = stack.fused_value_and_grad(tb, tstate.params, tbatch,
                                                  {})
    virt = stack._virt(tstate.params)
    with torch.enable_grad():
        loss2, _ = base.loss_fn(tb, virt, tbatch)
        want = torch.autograd.grad(loss2, stack._diff(virt))
    assert float(loss) == pytest.approx(float(loss2.detach()), rel=1e-6)
    for g, w in zip(_leaves(grads), want):
        assert _rel(g.numpy(), w.numpy()) <= 1e-5


# ---------------------------------------------------------------------------
# one optimizer step
# ---------------------------------------------------------------------------

def _check_state(tparams, topt, jparams, jopt_state):
    """Codes within one INT8 quantum (nearly all equal), moments within
    one quantum of their 8-bit storage, projections within one INT4
    quantum."""
    for tp, jp in zip(_leaves(tparams), _jleaves(jparams)):
        if _is_q(jp):
            quantum = float(np.asarray(jp.scale).max())
            assert np.abs(_deq(tp) - _deq(jp)).max() <= quantum + 1e-6
            assert (tp.q.numpy() == np.asarray(jp.q)).mean() > 0.99
        else:
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                       rtol=1e-5, atol=1e-6)
    j_inner = jax.tree_util.tree_leaves(
        jopt_state.inner,
        is_leaf=lambda x: isinstance(x, jadam.Adam8bitState))
    for ti, ji in zip(topt.inner, j_inner):
        for a, b in ((ti.m, ji.m), (ti.v, ji.v)):
            quantum = float(np.asarray(b.scale).max())
            assert np.abs(_deq(a) - _deq(b)).max() <= quantum + 1e-6
    j_proj = jax.tree_util.tree_leaves(
        jopt_state.proj, is_leaf=lambda x: x is None or _is_q(x))
    for tp, jp in zip(topt.proj, j_proj):
        if jp is not None:
            quantum = float(np.asarray(jp.scale).max())
            assert np.abs(_deq(tp) - _deq(jp)).max() <= quantum + 1e-6
    assert topt.count == int(jopt_state.count)


@pytest.mark.parametrize("refresh", [True, False])
def test_apply_updates_matches_jax(models, init, aligned_svd, refresh):
    """One optimizer step on the same clipped gradients with the
    reference's uniforms: a refresh step (every GaLore layer recomputes P
    by SVD, unfused update) and a steady step (low-rank gradients through
    the fused update). Sims 1e-4."""
    jb, tb = models
    jstate, tstate, jbatch, _ = init
    qj, qt = _jcfg(), _tcfg()
    jspecs = jqg.leaf_specs(jstate.params, qj)
    tspecs = qgalore.leaf_specs(tstate.params, qt)
    jtrees = {} if refresh else _jax_proj_trees(jb, jstate.opt)
    _, jg = jstack.fused_value_and_grad(jb, jstate.params, jbatch, jtrees)
    jg, _ = jtransform.clip_by_global_norm(jg, 1.0, specs=jspecs)
    tg = qgalore.unflatten([k for k, _ in qgalore.flatten(tstate.params)],
                           [torch.from_numpy(np.array(g))
                            for g in jax.tree_util.tree_leaves(jg)])
    step_idx, lr = 0, 5e-3
    jmasks = tmasks = None
    if refresh:
        jmasks = {i: jnp.ones((s.nbatch,), bool)
                  for i, s in enumerate(jspecs) if s.galore}
        tmasks = {i: np.ones((s.nbatch,), bool)
                  for i, s in enumerate(tspecs) if s.galore}
    rng = jax.random.fold_in(jax.random.PRNGKey(17), step_idx)
    jp, jo, jm = jqg.apply_updates(jstate.params, jg, jstate.opt, qj, lr,
                                   rng, refresh_masks=jmasks,
                                   refresh=refresh, specs=jspecs)
    draw = jax_uniforms(0)
    LAUNCHES.clear()
    tp, to, tm = qgalore.apply_updates(
        tstate.params, tg, tstate.opt, qt, lr,
        lambda leaf, layer, shape: draw(step_idx, leaf, layer, shape),
        refresh_masks=tmasks, refresh=refresh, specs=tspecs)
    _check_state(tp, to, jp, jo)
    n_galore = sum(s.nbatch for s in tspecs if s.galore)
    if refresh:
        assert set(tm["sims"]) == set(jm["sims"])
        for path, sims in tm["sims"].items():
            np.testing.assert_allclose(sims, np.asarray(jm["sims"][path]),
                                       rtol=0, atol=1e-4)
        assert LAUNCHES["fused_qgalore_update_ref"] == 0
    else:
        assert tm["sims"] == {}
        # one fused update per GaLore layer
        assert LAUNCHES["fused_qgalore_update_ref"] == n_galore


@pytest.mark.parametrize("name", ["galore", "galore8bit", "adam8bit",
                                  "qgalore_nosr"])
def test_preset_steps_match_jax(models, aligned_svd, name):
    """The paper's baselines through the same optimizer: float weights
    and a float P (galore), float32 or 8-bit moments, no GaLore at all
    (adam8bit), INT8 weights requantized to nearest (qgalore_nosr). A
    refresh step, then a steady step, on the reference's full-rank
    gradients."""
    jb, tb = models
    qj = jopt.preset(name, JQGaLoreConfig(**QCFG_KW))
    qt = optimizers.preset(name, QGaLoreConfig(**QCFG_KW))
    jstate = jstep.init_state(jb, qj, jax.random.PRNGKey(1), jnp.float32)
    tstate = from_jax_state(jax_state_np(jstate), device="cpu")
    jspecs = jqg.leaf_specs(jstate.params, qj)
    tspecs = qgalore.leaf_specs(tstate.params, qt)
    jbatch = jsyn.batch_for_bundle(jb, JShapeCell("p", 32, 4, "train"), 0, 1)
    _, jg = jstack.fused_value_and_grad(jb, jstate.params, jbatch, {})
    tg = qgalore.unflatten([k for k, _ in qgalore.flatten(tstate.params)],
                           [torch.from_numpy(np.array(g))
                            for g in jax.tree_util.tree_leaves(jg)])
    jp, jo, tp, to = jstate.params, jstate.opt, tstate.params, tstate.opt
    for refresh in (True, False):
        jmasks = {i: jnp.ones((s.nbatch,), bool)
                  for i, s in enumerate(jspecs) if s.galore} if refresh \
            else None
        tmasks = {i: np.ones((s.nbatch,), bool)
                  for i, s in enumerate(tspecs) if s.galore} if refresh \
            else None
        jp, jo, _ = jqg.apply_updates(jp, jg, jo, qj, 1e-2,
                                      jax.random.PRNGKey(0),
                                      refresh_masks=jmasks, refresh=refresh,
                                      specs=jspecs)
        tp, to, _ = qgalore.apply_updates(
            tp, tg, to, qt, 1e-2, lambda *a: pytest.fail("SR is off"),
            refresh_masks=tmasks, refresh=refresh, specs=tspecs)
    for t, j in zip(_leaves(tp), _jleaves(jp)):
        if _is_q(j):
            assert np.abs(_deq(t) - _deq(j)).max() <= \
                float(np.asarray(j.scale).max()) + 1e-6
        else:
            # an 8-bit moment that sits on a rounding boundary may round
            # the other way in one package: it moves the second step of
            # the elements it feeds (a whole row or column after GaLore's
            # back-projection), by less than two learning rates
            t, j = t.numpy(), np.asarray(j)
            close = np.isclose(t, j, rtol=1e-4, atol=1e-6)
            assert close.mean() > 0.99
            assert np.abs(t - j).max() <= 2 * 1e-2
    assert to.count == int(jo.count) == 2


def test_step_refuses_what_is_not_ported(models, tmp_path):
    """What this slice ported is taken (a checkpoint directory, adaptive
    rank, a rule-set); what it did not port is still refused (a flash
    bundle, a recipe that is neither a config nor a rule-set)."""
    _, tb = models
    tr = Trainer(tb, TrainConfig(**TCFG_KW, checkpoint_dir=str(tmp_path)),
                 _tcfg())
    assert tr.mgr is not None and tr.maybe_restore() == 0
    specs = qgalore.leaf_specs({"w": torch.zeros((64, 64))}, _tcfg())
    ctl = adaptive.SubspaceController(specs,
                                      QGaLoreConfig(adaptive_rank=True))
    assert ctl.current_ranks() == {}
    rules = ParamRules(base=_tcfg(), groups=(
        ParamGroup("frozen", pattern=r"^\['w'\]$", frozen=True),))
    got = qgalore.leaf_specs({"w": torch.zeros((64, 64)),
                              "u": torch.zeros((64, 64))}, rules)
    assert [(s.path, s.frozen, s.group) for s in got] == [
        ("['u']", False, "default"), ("['w']", True, "frozen")]
    with pytest.raises(TypeError, match="QGaLoreConfig"):
        qgalore.leaf_specs({"w": torch.zeros((64, 64))}, object())
    flash = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                 dtype=torch.float32, flash_attention=True)
    with pytest.raises(ValueError, match="flash"):
        Trainer(flash, TrainConfig(**TCFG_KW), _tcfg())


# ---------------------------------------------------------------------------
# controller
# ---------------------------------------------------------------------------

def test_controller_matches_jax(init):
    """The same similarities give the same masks, intervals and SVD counts,
    exactly, over a long random schedule."""
    jstate, tstate, _, _ = init
    cfg_kw = dict(QCFG_KW, adaptive_k=2, max_interval=32)
    jcfg = jopt.preset("qgalore", JQGaLoreConfig(**cfg_kw))
    tcfg = optimizers.preset("qgalore", QGaLoreConfig(**cfg_kw))
    jc = jadaptive.SubspaceController(jqg.leaf_specs(jstate.params, jcfg),
                                      jcfg)
    tc = adaptive.SubspaceController(qgalore.leaf_specs(tstate.params, tcfg),
                                     tcfg)
    rng = np.random.default_rng(0)
    for s in range(200):
        jm, tm = jc.masks_for_step(s), tc.masks_for_step(s)
        assert jm.keys() == tm.keys()
        for k in jm:
            np.testing.assert_array_equal(jm[k], tm[k])
        if not jm:
            continue
        sims = {tc.specs[i].path: np.where(
            m, rng.choice([0.1, 0.5, 0.9], size=m.shape), -1.0)
            for i, m in tm.items()}
        jc.observe(s, jm, sims)
        tc.observe(s, tm, sims)
    assert tc.svd_count_summary() == jc.svd_count_summary()
    assert tc.interval_summary() == jc.interval_summary()
    assert tc.total_svd_count() == jc.total_svd_count()
    assert tc.baseline_svd_count(200) == jc.baseline_svd_count(200)
    assert max(max(v) for v in tc.interval_summary().values()) > 4


# ---------------------------------------------------------------------------
# a live trajectory
# ---------------------------------------------------------------------------

STEPS = 16


def test_trajectory_matches_jax(models, aligned_svd):
    """tests/test_golden.py's configuration for 16 steps, both packages
    from the same initial state, with the reference's batches and SR
    uniforms: losses within 2e-3, SVD counts and intervals equal."""
    jb, tb = models
    jtr = JTrainer(jb, JTrainConfig(**TCFG_KW, steps=STEPS,
                                    async_checkpoint=False),
                   _jcfg(), cell=JShapeCell("golden", 32, 4, "train"),
                   impl="fused", param_dtype=jnp.float32)
    start = jax_state_np(jtr.state)
    seen = []
    observe = jtr.controller.observe

    def recording(s, masks, sims, ratios=None):
        seen.extend(float(v) for a in sims.values()
                    for v in np.asarray(a).ravel() if v >= 0)
        return observe(s, masks, sims, ratios)

    jtr.controller.observe = recording
    jhist = jtr.run()
    # no similarity so near the threshold that noise could flip a decision
    assert seen and min(abs(s - QCFG_KW["cos_threshold"])
                        for s in seen) > 1e-3

    ttr = Trainer(tb, TrainConfig(**TCFG_KW, steps=STEPS), _tcfg(),
                  cell=ShapeCell("golden", 32, 4, "train"),
                  state=from_jax_state(start, device="cpu"),
                  uniforms=jax_uniforms(0),
                  batches=jax_batches(jb, JShapeCell("golden", 32, 4,
                                                     "train"), 0))
    LAUNCHES.clear()
    thist = ttr.run()
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=2e-3,
                               atol=2e-3)
    assert ttr.controller.svd_count_summary() == \
        jtr.controller.svd_count_summary()
    assert ttr.controller.interval_summary() == \
        jtr.controller.interval_summary()
    assert all(np.isfinite(h["grad_norm"]) for h in thist)
    # the CPU path ran the plain versions only
    assert LAUNCHES["fused_qgalore_update_ref"] > 0
    assert LAUNCHES["int8_matmul"] == LAUNCHES["int8_matmul_t"] == \
        LAUNCHES["fused_qgalore_update"] == 0
