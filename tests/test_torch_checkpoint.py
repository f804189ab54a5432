"""Checkpoint, resume and fault recovery of the port's ``Trainer``
(``tests/test_trainer.py``'s cases, on the CPU), and the hand-over of
checkpoints between the packages: a directory the JAX package's
``Trainer`` wrote restores into the port, which then continues the run as
the reference does, and a directory the port wrote restores into the
reference's ``CheckpointManager``."""
import shutil

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
from repro.core import qgalore as jqg
from repro.core import rules as jrules
from repro.core.rules import as_rules as jas_rules
from repro.models import model_zoo as jzoo
from repro.train import checkpoint as jckpt
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
from repro_torch.core import optimizers, qgalore
from repro_torch.core.rules import ParamGroup, ParamRules
from repro_torch.models import model_zoo
from repro_torch.serve.params import from_jax_state
from repro_torch.train import checkpoint
from repro_torch.train.trainer import Trainer

from test_torch_train import (QCFG_KW, TCFG_KW, align_signs_to_jax,
                              jax_batches, jax_state_np, jax_uniforms)
from torch_one_thread import one_thread  # noqa: F401

CELL = ShapeCell("tiny", seq_len=32, global_batch=4, kind="train")
ADA_KW = dict(QCFG_KW, galore_embeddings=True, adaptive_rank=True,
              rank_ladder=(4,), explained_ratio_threshold=0.45,
              rank_patience=3, min_rank=4)


@pytest.fixture(scope="module")
def bundle():
    return model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                dtype=torch.float32)


def make_trainer(bundle, path=None, steps=12, ckpt_every=0, fault_hook=None,
                 accum=1, qcfg_kw=QCFG_KW, rules=None, async_save=False):
    qcfg = optimizers.preset("qgalore", QGaLoreConfig(**qcfg_kw))
    tcfg = TrainConfig(**TCFG_KW, steps=steps,
                       checkpoint_dir=str(path) if path else "",
                       checkpoint_every=ckpt_every,
                       async_checkpoint=async_save)
    return Trainer(bundle, tcfg, rules or qcfg, cell=CELL, accum=accum,
                   fault_hook=fault_hook)


def _state_arrays(tr):
    return checkpoint.state_arrays(tr.state)


def _assert_states_equal(a, b):
    sa, sb = _state_arrays(a), _state_arrays(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


class Run:
    """One uninterrupted run with its checkpoints: the yardstick of the
    resume tests, which restore copies of its checkpoint directories."""

    def __init__(self, bundle, root, **kw):
        self.kw, self.root = kw, root
        self.trainer = make_trainer(bundle, root / "run", **kw)
        self.hist = self.trainer.run()
        self.losses = {h["step"]: h["loss"] for h in self.hist}

    def resume(self, bundle, step, path, **kw):
        """A fresh trainer on a directory holding only checkpoint
        ``step``, restored; its tail is run."""
        name = f"step_{step:08d}"
        shutil.copytree(self.root / "run" / name, path / name)
        tr = make_trainer(bundle, path, **{**self.kw, **kw})
        assert tr.maybe_restore() == step + 1
        return tr, tr.run()


@pytest.fixture(scope="module", params=[(1, False), (2, True)],
                ids=["accum1-sync", "accum2-async"])
def plain_run(bundle, tmp_path_factory, request):
    accum, async_save = request.param
    return Run(bundle, tmp_path_factory.mktemp("plain"), steps=10,
               ckpt_every=3, accum=accum, async_save=async_save)


@pytest.fixture(scope="module")
def ada_run(bundle, tmp_path_factory):
    """A rank-8 -> 4 shrink at step 8; checkpoints at 5, 10 and 11."""
    run = Run(bundle, tmp_path_factory.mktemp("ada"), steps=12,
              ckpt_every=5, qcfg_kw=ADA_KW)
    trans = run.trainer.controller.rank_transition_summary()
    assert trans and {t["step"] for t in trans} == {8}
    return run


def test_resume_bit_identical(bundle, tmp_path, plain_run):
    """Restore a mid-run checkpoint into a fresh trainer and continue: the
    same losses, the same final state array for array, the same intervals
    and SVD counts as the uninterrupted run (the SR and batch draws are
    functions of the step)."""
    tr, hist = plain_run.resume(bundle, 3, tmp_path)
    assert [h["step"] for h in hist] == list(range(4, 10))
    for h in hist:
        assert h["loss"] == plain_run.losses[h["step"]], h
    _assert_states_equal(plain_run.trainer, tr)
    assert plain_run.trainer.controller.interval_summary() == \
        tr.controller.interval_summary()
    assert plain_run.trainer.controller.svd_count_summary() == \
        tr.controller.svd_count_summary()


def test_checkpoint_layout_and_gc(plain_run):
    """``step_%08d`` directories with ``arrays.npz`` and ``meta.json``, no
    ``.tmp`` left behind, at most ``keep_checkpoints`` kept (the periodic
    ones and the run's last step); the meta carries the controller,
    fingerprint, group map and overrides."""
    tr, d = plain_run.trainer, plain_run.root / "run"
    assert tr.mgr.all_steps() == [3, 6, 9]
    assert sorted(p.name for p in d.iterdir()) == \
        ["step_00000003", "step_00000006", "step_00000009"]
    assert sorted(p.name for p in (d / "step_00000009").iterdir()) \
        == ["arrays.npz", "meta.json"]
    meta = tr.mgr.read_meta()
    assert meta["step"] == 9
    assert meta["rules_fingerprint"] == tr.rules.fingerprint()
    assert meta["rank_overrides"] == {}
    assert set(meta["groups"]) == {s.path for s in tr.specs}
    assert meta["controller"] == tr.controller.to_json()


def test_fault_recovery(bundle, tmp_path, plain_run):
    """A step that fails is replayed from the last checkpoint: the run
    completes with the losses of a run without the fault."""
    boom = {"armed": True}

    def fault(step):
        if step == 8 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    tr = make_trainer(bundle, tmp_path, **plain_run.kw, fault_hook=fault)
    hist = tr.run()
    assert not boom["armed"]
    # steps 7 and 8 ran again after the restore of step 6
    assert [h["step"] for h in hist] == list(range(8)) + [7, 8, 9]
    for h in hist:
        assert h["loss"] == plain_run.losses[h["step"]], h


def test_fault_budget_exhausted_raises(bundle, tmp_path):
    def always_fail(step):
        raise RuntimeError("permafail")

    tr = make_trainer(bundle, tmp_path, steps=4, ckpt_every=2,
                      fault_hook=always_fail)
    with pytest.raises(RuntimeError, match="permafail"):
        tr.run(max_failures=2)


def test_straggler_detection(bundle):
    tr = make_trainer(bundle, steps=1)
    for i in range(20):
        tr.stragglers.observe(i, 0.1)
    assert tr.stragglers.observe(20, 1.0)
    assert tr.stragglers.events[-1]["step"] == 20


def test_resume_bit_identical_across_rank_transition(bundle, tmp_path,
                                                     ada_run):
    """A checkpoint after the shrink (truncated state and the override
    map) restores into a fresh trainer, which adopts the overrides before
    the arrays; one before the shrink replays it. Both tails bit-identical
    to the uninterrupted run."""
    trans = ada_run.trainer.controller.rank_transition_summary()
    meta = ada_run.trainer.mgr.read_meta(10)
    assert meta["rank_overrides"]
    tr, hist = ada_run.resume(bundle, 10, tmp_path / "after")
    assert any(s.rank == 4 for s in tr.specs if s.galore)
    assert [h["step"] for h in hist] == [11]
    for h in hist:
        assert h["loss"] == ada_run.losses[h["step"]], h
    _assert_states_equal(ada_run.trainer, tr)
    assert tr.controller.rank_transition_summary() == trans

    tr, hist = ada_run.resume(bundle, 5, tmp_path / "before")
    assert [h["step"] for h in hist] == list(range(6, 12))
    for h in hist:
        assert h["loss"] == ada_run.losses[h["step"]], h
    _assert_states_equal(ada_run.trainer, tr)
    assert tr.controller.rank_transition_summary() == trans


def test_restore_refusals(bundle, tmp_path, ada_run, plain_run):
    """A shrunk checkpoint into a run without rank adaptation, and any
    checkpoint into a run under other param-group rules, fail on the meta
    with their own message, before any array is read."""
    name = "step_00000010"
    shutil.copytree(ada_run.root / "run" / name, tmp_path / "ada" / name)
    off = make_trainer(bundle, tmp_path / "ada", steps=12,
                       qcfg_kw=dict(ADA_KW, adaptive_rank=False))
    with pytest.raises(ValueError, match="adaptive_rank"):
        off.maybe_restore()

    plain = plain_run.root / "run"
    base = optimizers.preset("qgalore", QGaLoreConfig(**QCFG_KW))
    other = ParamRules(base=base, groups=(
        ParamGroup("frozen", pattern=r"embedding", frozen=True),))
    tr2 = make_trainer(bundle, plain, steps=10, rules=other)
    with pytest.raises(ValueError, match="param-group rules"):
        tr2.maybe_restore()
    # recipe knobs of the base that leave the state's layout alone do not
    # change the fingerprint: the restore goes through
    tr3 = make_trainer(bundle, plain, steps=10,
                       accum=plain_run.kw["accum"],
                       qcfg_kw=dict(QCFG_KW, cos_threshold=0.9))
    assert tr3.maybe_restore() == 10


# ---------------------------------------------------------------------------
# hand-over between the packages
# ---------------------------------------------------------------------------

def _jcfg():
    return jopt.preset("qgalore", JQGaLoreConfig(**QCFG_KW))


def _tcfg():
    return optimizers.preset("qgalore", QGaLoreConfig(**QCFG_KW))


STEPS, SAVED = 8, 4


def test_reference_checkpoint_restored_by_port(bundle, tmp_path,
                                               monkeypatch):
    """The reference saves at step 4 of an 8-step run; the port restores
    that directory (the state bit for bit, the controller) and runs steps
    5-7 on the reference's batches and uniforms: losses within 2e-3 of the
    reference's uninterrupted run, SVD counts and intervals equal."""
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", align_signs_to_jax)
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    jcell = JShapeCell("golden", 32, 4, "train")
    jtr = JTrainer(jb, JTrainConfig(**TCFG_KW, steps=STEPS,
                                    checkpoint_dir=str(tmp_path / "ref"),
                                    checkpoint_every=SAVED,
                                    keep_checkpoints=5,
                                    async_checkpoint=False),
                   _jcfg(), cell=jcell, impl="fused",
                   param_dtype=jnp.float32)
    jhist = jtr.run()
    (tmp_path / "port").mkdir()
    shutil.copytree(tmp_path / "ref" / f"step_{SAVED:08d}",
                    tmp_path / "port" / f"step_{SAVED:08d}")

    ttr = Trainer(bundle, TrainConfig(**TCFG_KW, steps=STEPS,
                                      checkpoint_dir=str(tmp_path / "port"),
                                      async_checkpoint=False),
                  _tcfg(), cell=ShapeCell("golden", 32, 4, "train"),
                  uniforms=jax_uniforms(0),
                  batches=jax_batches(jb, jcell, 0))
    assert ttr.maybe_restore() == SAVED + 1
    saved = np.load(tmp_path / "ref" / f"step_{SAVED:08d}" / "arrays.npz")
    mine = checkpoint.state_arrays(ttr.state)
    assert mine.keys() == set(saved.files)
    for k in saved.files:
        np.testing.assert_array_equal(mine[k], saved[k], err_msg=k)
    thist = ttr.run()
    assert [h["step"] for h in thist] == list(range(SAVED + 1, STEPS))
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist[SAVED + 1:]],
                               rtol=2e-3, atol=2e-3)
    assert ttr.controller.svd_count_summary() == \
        jtr.controller.svd_count_summary()
    assert ttr.controller.interval_summary() == \
        jtr.controller.interval_summary()


def test_port_checkpoint_restored_by_reference(bundle, tmp_path):
    """The port's directory restores into the reference's
    ``CheckpointManager`` and abstract state, array for array, and its
    controller JSON and fingerprint are the reference's to read."""
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    jstate = jstep.init_state(jb, _jcfg(), jax.random.PRNGKey(0),
                              jnp.float32)
    tr = Trainer(bundle, TrainConfig(**TCFG_KW, steps=3,
                                     checkpoint_dir=str(tmp_path),
                                     async_checkpoint=False), _tcfg(),
                 cell=CELL, state=from_jax_state(jax_state_np(jstate),
                                                 device="cpu"))
    tr.run()
    mgr = jckpt.CheckpointManager(str(tmp_path))
    abstract = jstep.abstract_state(jb, _jcfg(), jnp.float32)
    state, meta = mgr.restore(None, abstract)
    assert meta["step"] == 2
    want = checkpoint.state_arrays(tr.state)
    got = {jax.tree_util.keystr(p): np.asarray(l) for p, l in
           jax.tree_util.tree_flatten_with_path(state)[0]}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    jckpt.check_rules_compat(meta, jas_rules(_jcfg()).fingerprint(),
                             jrules.group_assignment(
                                 jqg.leaf_specs(jstate.params, _jcfg())))
    jctl = jadaptive.SubspaceController(
        jqg.leaf_specs(jstate.params, _jcfg()), _jcfg())
    jctl.from_json(meta["controller"])
    assert jctl.svd_count_summary() == tr.controller.svd_count_summary()
    assert jctl.interval_summary() == tr.controller.interval_summary()
