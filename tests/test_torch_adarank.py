"""The randomized subspace method and dynamic rank adaptation of the port
against the JAX package: the range finder on the reference's own Gaussian
draws (handed over through numpy: threefry cannot be reproduced in torch),
the range finder against the exact SVD, the explained-variance profile,
rank migration, the controller's decisions and its JSON, and the
rank-transition schedule ``(step, path, old, new)`` of a live 12-step
reference run."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.config import TrainConfig as JTrainConfig
from repro.core import adaptive as jadaptive
from repro.core import optimizers as jopt
from repro.core import projector as jproj
from repro.core import qgalore as jqg
from repro.core import transform as jtransform
from repro.core.rules import as_rules as jas_rules
from repro.data import synthetic as jsyn
from repro.models import model_zoo as jzoo
from repro.train import stack as jstack
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
from repro_torch.core import adaptive, optimizers, projector, qgalore
from repro_torch.models import model_zoo
from repro_torch.serve.params import from_jax_state
from repro_torch.train.trainer import Trainer

from test_torch_train import (_deq, align_signs_to_jax,
                              jax_batches, jax_state_np, jax_uniforms)
from torch_one_thread import one_thread  # noqa: F401

# tests/test_trainer.py's adaptive-rank configuration: a rank-8 -> 4 shrink
# at step 8 of a 12-step run
ADA_KW = dict(rank=8, min_dim=32, update_interval=4, adaptive_k=1,
              cos_threshold=0.3, galore_embeddings=True, adaptive_rank=True,
              rank_ladder=(4,), explained_ratio_threshold=0.45,
              rank_patience=3, min_rank=4)
TCFG_KW = dict(seed=0, global_batch=4, seq_len=32, learning_rate=1e-2,
               warmup_steps=2, grad_clip=1.0, log_every=0)
CELL = ("golden", 32, 4, "train")


def jax_normals(seed: int):
    """The reference's randomized test matrices: ``normal(fold_in(fold_in(
    fold_in(PRNGKey(seed + 17), step), leaf_idx), unit), (k, p))``
    (trainer.py's step key, qgalore.py's leaf and unit folds)."""
    base_key = jax.random.PRNGKey(seed + 17)

    def draw(step_idx, leaf_idx, unit, shape):
        k = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(base_key, step_idx), leaf_idx), unit)
        return torch.from_numpy(np.array(
            jax.random.normal(k, shape, jnp.float32)))
    return draw


def _lowrank_plus_noise(rng, m, n, r_true, noise):
    """A matrix with a clean rank-r_true spectral gap and small noise."""
    U = np.linalg.qr(rng.standard_normal((m, r_true)))[0]
    V = np.linalg.qr(rng.standard_normal((n, r_true)))[0]
    s = np.linspace(10.0, 5.0, r_true)
    return (U * s @ V.T + noise * rng.standard_normal((m, n))).astype(
        np.float32)


def _pp(P):
    P = np.asarray(P, np.float64)
    return P @ P.T


# ---------------------------------------------------------------------------
# the randomized range finder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,rank", [((48, 32), 8), ((32, 80), 8),
                                        ((96, 96), 4), ((64, 200), 16)])
def test_randomized_matches_jax(shape, rank):
    """A batch of three gradients through one port call, each unit on the
    reference's draw for its key: the same subspace (similarity >= 1 -
    1e-5) and the same projector ``P P^T`` within 1e-4."""
    rng = np.random.default_rng(sum(shape) + rank)
    G = rng.standard_normal((3,) + shape).astype(np.float32)
    side = projector.galore_side(shape)
    k, p = projector.omega_shape(shape, rank, side)
    key = jax.random.PRNGKey(11)
    keys = [jax.random.fold_in(key, i) for i in range(3)]
    omega = np.stack([np.array(jax.random.normal(kk, (k, p), jnp.float32))
                      for kk in keys])
    Pt = projector.compute_subspace(torch.from_numpy(G), rank, side,
                                    "randomized", torch.from_numpy(omega))
    assert tuple(Pt.shape) == (3, projector.proj_dim(shape), rank)
    for i in range(3):
        Pj = np.array(jproj.compute_subspace(
            jnp.asarray(G[i]), rank, side, "randomized", keys[i]))
        sim = float(projector.subspace_similarity(Pt[i],
                                                  torch.from_numpy(Pj)))
        assert sim >= 1 - 1e-5, (i, sim)
        np.testing.assert_allclose(_pp(Pt[i].numpy()), _pp(Pj), rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("m,n,r,seed", [(64, 96, 8, 3), (48, 32, 4, 0),
                                        (128, 32, 8, 1), (64, 32, 4, 2),
                                        (128, 96, 8, 5), (48, 96, 4, 7)])
def test_randomized_matches_svd(m, n, r, seed):
    """``tests/test_property.py``'s check: on a low-rank-plus-noise matrix
    the range finder (on a torch draw) and the exact SVD agree on the
    dominant subspace (overlap >= 0.95)."""
    rng = np.random.default_rng(seed)
    G = torch.from_numpy(_lowrank_plus_noise(rng, m, n, r, 0.01))
    side = projector.galore_side((m, n))
    gen = torch.Generator().manual_seed(seed + 9)
    omega = torch.randn(projector.omega_shape((m, n), r, side), generator=gen)
    P_svd = projector.compute_subspace(G, r, side, "svd")
    P_rnd = projector.compute_subspace(G, r, side, "randomized", omega)
    assert float(projector.subspace_similarity(P_svd, P_rnd)) >= 0.95


def test_explained_ratio_matches_jax():
    rng = np.random.default_rng(4)
    for shape in ((2, 48, 32), (2, 32, 80)):
        G = rng.standard_normal(shape).astype(np.float32)
        side = projector.galore_side(shape)
        P = np.asarray(jproj.compute_subspace(jnp.asarray(G[0]), 8, side))
        P = np.stack([P, P])
        got = projector.explained_ratio(torch.from_numpy(G),
                                        torch.from_numpy(P), side).numpy()
        want = np.asarray(jproj.explained_ratio(jnp.asarray(G),
                                                jnp.asarray(P), side))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert np.all(np.diff(got, axis=-1) >= -1e-7) and got.max() <= 1


def _models_and_state(cfg_kw, seed=0):
    qj = jopt.preset("qgalore", JQGaLoreConfig(**cfg_kw))
    qt = optimizers.preset("qgalore", QGaLoreConfig(**cfg_kw))
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    jstate = jstep.init_state(jb, qj, jax.random.PRNGKey(seed), jnp.float32)
    tstate = from_jax_state(jax_state_np(jstate), device="cpu")
    return jb, qj, qt, jstate, tstate


def test_randomized_refresh_matches_jax(monkeypatch):
    """One refresh step with ``subspace_method="randomized"`` through
    ``apply_updates``, the reference's test matrices and uniforms handed
    over: every fresh P spans the reference's subspace (``P P^T`` within
    1e-4), the similarities agree within 1e-4, and under
    ``adaptive_rank`` so do the explained-variance profiles."""
    kw = dict(ADA_KW, subspace_method="randomized")
    jb, qj, qt, jstate, tstate = _models_and_state(kw)
    jspecs = jqg.leaf_specs(jstate.params, qj)
    tspecs = qgalore.leaf_specs(tstate.params, qt)
    jbatch = jsyn.batch_for_bundle(jb, JShapeCell(*CELL), 0, 0)
    _, jg = jstack.fused_value_and_grad(jb, jstate.params, jbatch, {})
    jg, _ = jtransform.clip_by_global_norm(jg, 1.0, specs=jspecs)
    g_np = [np.array(g) for g in jax.tree_util.tree_leaves(jg)]
    tg = qgalore.unflatten([k for k, _ in qgalore.flatten(tstate.params)],
                           [torch.from_numpy(g) for g in g_np])
    step_idx, lr = 0, 5e-3
    rng = jax.random.fold_in(jax.random.PRNGKey(17), step_idx)
    jmasks = {i: jnp.ones((s.nbatch,), bool)
              for i, s in enumerate(jspecs) if s.galore}
    jp, jo, jm = jqg.apply_updates(jstate.params, jg, jstate.opt, qj, lr,
                                   rng, refresh_masks=jmasks, refresh=True,
                                   specs=jspecs)
    fresh = {}

    def capture(path, g, P_new, units):
        fresh[path] = P_new.clone()
        return P_new
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", capture)
    draw, normals = jax_uniforms(0), jax_normals(0)
    tp, to, tm = qgalore.apply_updates(
        tstate.params, tg, tstate.opt, qt, lr,
        lambda leaf, layer, shape: draw(step_idx, leaf, layer, shape),
        refresh_masks={i: np.ones((s.nbatch,), bool)
                       for i, s in enumerate(tspecs) if s.galore},
        refresh=True, specs=tspecs,
        omegas=lambda leaf, unit, shape: normals(step_idx, leaf, unit,
                                                 shape))
    n_units = 0
    for idx, spec in enumerate(tspecs):
        if not spec.galore:
            continue
        leaf_key = jax.random.fold_in(rng, idx)
        g = g_np[idx].reshape((spec.nbatch,) + spec.mat_shape)
        for u in range(spec.nbatch):
            Pj = np.asarray(jproj.compute_subspace(
                jnp.asarray(g[u]), spec.rank, spec.side, "randomized",
                jax.random.fold_in(leaf_key, u), qt.subspace_iters))
            np.testing.assert_allclose(_pp(fresh[spec.path][u].numpy()),
                                       _pp(Pj), rtol=0, atol=1e-4)
            n_units += 1
    assert n_units == sum(s.nbatch for s in tspecs if s.galore)
    assert set(tm["sims"]) == set(jm["sims"]) == set(tm["ratios"])
    for path in tm["sims"]:
        np.testing.assert_allclose(tm["sims"][path],
                                   np.asarray(jm["sims"][path]), atol=1e-4)
        np.testing.assert_allclose(tm["ratios"][path],
                                   np.asarray(jm["ratios"][path]),
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# rank migration and the controller
# ---------------------------------------------------------------------------

def test_migrate_rank_state_matches_jax():
    """Truncation and round-to-nearest requantization: the same codes as
    the reference for the same state; specs rebuilt with the override."""
    _, qj, qt, jstate, tstate = _models_and_state(ADA_KW, seed=3)
    jspecs = jqg.leaf_specs(jstate.params, qj)
    tspecs = qgalore.leaf_specs(tstate.params, qt)
    j_inner = jax.tree_util.tree_leaves(
        jstate.opt.inner, is_leaf=lambda x: isinstance(x, jqg.Adam8bitState))
    j_proj = jax.tree_util.tree_leaves(
        jstate.opt.proj, is_leaf=lambda x: x is None
        or isinstance(x, jqg.quant.QTensor))
    checked = 0
    for idx, spec in enumerate(tspecs):
        if not spec.galore:
            continue
        ti, tP = qgalore.migrate_rank_state(tstate.opt.inner[idx],
                                            tstate.opt.proj[idx], spec, 4,
                                            qt)
        ji, jP = jqg.migrate_rank_state(j_inner[idx], j_proj[idx],
                                        jspecs[idx], 4, qj)
        np.testing.assert_array_equal(tP.q.numpy(), np.asarray(jP.q))
        np.testing.assert_allclose(_deq(tP), _deq(jP), rtol=0, atol=1e-7)
        for a, b in ((ti.m, ji.m), (ti.v, ji.v)):
            np.testing.assert_array_equal(a.q.numpy(), np.asarray(b.q))
        checked += 1
    assert checked
    over = {tspecs[i].path: 4 for i, s in enumerate(tspecs) if s.galore}
    t_new = qgalore.apply_rank_overrides(tspecs, over)
    j_new = jqg.apply_rank_overrides(jspecs, over)
    assert [(s.rank, s.low_shape, s.proj_shape, s.cfg.rank)
            for s in t_new if s.galore] == \
        [(s.rank, s.low_shape, s.proj_shape, s.cfg.rank)
         for s in j_new if s.galore]
    with pytest.raises(ValueError, match="shrink"):
        qgalore.apply_rank_overrides(t_new, {next(iter(over)): 8})
    with pytest.raises(ValueError, match="unknown"):
        qgalore.apply_rank_overrides(tspecs, {"['nope']": 4})


def _mini(mod, cfg_cls, band):
    cfg = cfg_cls(rank=8, min_dim=32, adaptive_rank=True, rank_ladder=(4,),
                  explained_ratio_threshold=0.5, rank_hysteresis=band,
                  rank_patience=2, min_rank=4)
    if mod is adaptive:
        specs = qgalore.leaf_specs({"w": torch.zeros((64, 64))}, cfg)
    else:
        specs = jqg.leaf_specs({"w": jnp.zeros((64, 64))}, jas_rules(cfg))
    return mod.SubspaceController(specs, cfg), specs[0].path


@pytest.mark.parametrize("band,vals", [
    (0.0, [0.51, 0.45, 0.51]), (0.1, [0.51, 0.45, 0.51, 0.9, 0.9, 0.9]),
    (0.1, [0.51, 0.30, 0.51, 0.45, 0.51]), (0.0, [0.6, 0.6, 0.6])])
def test_rank_decisions_match_jax(band, vals):
    """``tests/test_adarank.py``'s hysteresis cases and a plain shrink:
    the same decisions, ranks, transitions and JSON in both packages, and
    each package's JSON restores into the other's controller."""
    tc, path = _mini(adaptive, QGaLoreConfig, band)
    jc, _ = _mini(jadaptive, JQGaLoreConfig, band)
    for step, v in enumerate(vals):
        prof = np.full((1, 8), v, np.float32)
        for c in (tc, jc):
            c.observe(step, {0: np.array([True])}, {path: np.array([0.9])},
                      {path: prof})
        assert tc.take_rank_decisions() == jc.take_rank_decisions()
    assert tc.rank_transition_summary() == jc.rank_transition_summary()
    assert tc.current_ranks() == jc.current_ranks()
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    tc2, _ = _mini(adaptive, QGaLoreConfig, band)
    jc2, _ = _mini(jadaptive, JQGaLoreConfig, band)
    tc2.from_json(jc.to_json())
    jc2.from_json(tc.to_json())
    assert tc2.to_json() == jc2.to_json() == tc.to_json()
    with pytest.raises(ValueError, match="leaf set"):
        tc2.from_json(json.dumps({"units": {}}))


# ---------------------------------------------------------------------------
# a live trajectory across a rank transition
# ---------------------------------------------------------------------------

STEPS = 12


def test_rank_transitions_match_jax(monkeypatch):
    """``tests/test_trainer.py``'s adaptive-rank configuration for 12 steps,
    both packages from the reference's init, on its batches and uniforms
    (SVD column signs aligned): the transitions ``(step, path, old,
    new)``, final ranks, SVD counts and intervals equal, losses within
    2e-3, the same optimizer-state bytes, and the controllers' JSON equal
    up to the similarity history."""
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", align_signs_to_jax)
    qj = jopt.preset("qgalore", JQGaLoreConfig(**ADA_KW))
    qt = optimizers.preset("qgalore", QGaLoreConfig(**ADA_KW))
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                              dtype=torch.float32)
    jtr = JTrainer(jb, JTrainConfig(**TCFG_KW, steps=STEPS,
                                    async_checkpoint=False), qj,
                   cell=JShapeCell(*CELL), impl="fused",
                   param_dtype=jnp.float32)
    start = jax_state_np(jtr.state)
    seen = {"jax": {}, "port": {}}

    def recording(ctl, into):
        observe = ctl.observe

        def rec(s, masks, sims, ratios=None):
            for path, r in (ratios or {}).items():
                r = np.asarray(r)
                if r.shape[-1] == 8:            # the rank-4 rung decides
                    into[s, path] = r[..., 3]
            return observe(s, masks, sims, ratios)
        ctl.observe = rec
    recording(jtr.controller, seen["jax"])
    jhist = jtr.run()
    jtrans = jtr.controller.rank_transition_summary()
    assert jtrans and {t["step"] for t in jtrans} == {8}

    ttr = Trainer(tb, TrainConfig(**TCFG_KW, steps=STEPS), qt,
                  cell=ShapeCell(*CELL),
                  state=from_jax_state(start, device="cpu"),
                  uniforms=jax_uniforms(0),
                  batches=jax_batches(jb, JShapeCell(*CELL), 0))
    recording(ttr.controller, seen["port"])
    thist = ttr.run()
    # the profiles that decided the shrinks drift apart (the trajectories
    # agree to within SR code flips) by less than their distance from the
    # threshold, so both packages face the same decisions
    assert seen["port"].keys() == seen["jax"].keys()
    diff = max(np.abs(seen["port"][k] - seen["jax"][k]).max()
               for k in seen["jax"])
    decided = np.concatenate([v[v >= 0] for v in seen["jax"].values()])
    margin = np.abs(decided - ADA_KW["explained_ratio_threshold"]).min()
    assert diff <= 1e-3 and diff < margin
    assert ttr.controller.rank_transition_summary() == jtrans
    assert ttr.controller.current_ranks() == jtr.controller.current_ranks()
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=2e-3,
                               atol=2e-3)
    assert ttr.controller.svd_count_summary() == \
        jtr.controller.svd_count_summary()
    assert ttr.controller.interval_summary() == \
        jtr.controller.interval_summary()
    assert [s.rank for s in ttr.specs] == [s.rank for s in jtr.specs]
    assert qgalore.optimizer_state_bytes(ttr.state.params, ttr.rules,
                                         specs=ttr.specs) == \
        jqg.optimizer_state_bytes(jtr.state.params, jtr.rules,
                                  specs=jtr.specs)

    def strip(blob):
        blob = json.loads(blob)
        for us in blob["units"].values():
            for u in us:
                u.pop("sims")
        return blob
    assert strip(ttr.controller.to_json()) == strip(jtr.controller.to_json())
