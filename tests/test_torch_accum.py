"""Gradient accumulation of the port against the JAX package: the
microbatched step (``accum`` 2: gradients summed in float32 over the
microbatches, then divided; the mean loss) on its own, and an 8-step
trajectory of ``tests/test_golden.py``'s configuration at ``accum`` 2
against a live reference run at ``accum`` 2."""
import gc
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShapeCell as JShapeCell
from repro.config import TrainConfig as JTrainConfig
from repro.data import synthetic as jsyn
from repro.models import model_zoo as jzoo
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import ShapeCell, TrainConfig
from repro_torch.core import qgalore
from repro_torch.kernels import LAUNCHES
from repro_torch.models import model_zoo
from repro_torch.serve.params import from_jax_state
from repro_torch.train import checkpoint, stack, step
from repro_torch.train.trainer import Trainer

from test_torch_train import (TCFG_KW, _jcfg, _tcfg, align_signs_to_jax,
                              jax_batches, jax_state_np, jax_uniforms)
from torch_one_thread import one_thread  # noqa: F401

STEPS = 8
ACCUM = 2
CELL = ("golden", 32, 4, "train")


@pytest.fixture(scope="module")
def bundles():
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                              dtype=torch.float32)
    return jb, tb


@pytest.mark.parametrize("lowrank", [False, True])
def test_accumulated_grads_are_the_microbatch_mean(bundles, lowrank):
    """``accumulated_value_and_grad`` equals the mean of the two
    microbatches' ``fused_value_and_grad`` (full-rank, as on a refresh
    step, and low-rank, as on a steady one), the loss their mean, the
    metrics the last microbatch's."""
    jb, tb = bundles
    jstate = jstep.init_state(jb, _jcfg(), jax.random.PRNGKey(2),
                              jnp.float32)
    tstate = from_jax_state(jax_state_np(jstate), device="cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             jsyn.batch_for_bundle(jb, JShapeCell(*CELL), 0, 0).items()}
    trees = {}
    if lowrank:
        trees = qgalore.unflatten([k for k, _ in qgalore.flatten(
            tstate.params)], tstate.opt.proj)
    (loss, metrics), grads = step.accumulated_value_and_grad(
        tb, tstate.params, batch, trees, ACCUM)
    parts = [stack.fused_value_and_grad(
        tb, tstate.params, {k: v[i * 2:(i + 1) * 2] for k, v in
                            batch.items()}, trees) for i in range(ACCUM)]
    assert float(loss) == pytest.approx(
        float((parts[0][0][0] + parts[1][0][0]) / 2), rel=1e-6)
    for k in metrics:
        assert float(metrics[k]) == float(parts[1][0][1][k])
    flat = [g for _, g in qgalore.flatten(grads)]
    for i, g in enumerate(flat):
        a, b = (qgalore.flatten(p[1])[i][1] for p in parts)
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, (a + b) / 2, rtol=0, atol=0)
    with pytest.raises(ValueError, match="microbatches"):
        step.accumulated_value_and_grad(tb, tstate.params, batch, trees, 3)


def test_accum_trajectory_matches_jax(bundles, monkeypatch):
    """8 steps at ``accum`` 2 (two microbatches of 2 rows), both packages
    from the same state on the reference's batches and uniforms: losses
    within 2e-3, SVD counts and intervals equal, on the CPU the plain
    versions only; then ``eval_loss`` on the same held-out batches."""
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", align_signs_to_jax)
    jb, tb = bundles
    jtr = JTrainer(jb, JTrainConfig(**TCFG_KW, steps=STEPS,
                                    async_checkpoint=False), _jcfg(),
                   cell=JShapeCell(*CELL), impl="fused",
                   param_dtype=jnp.float32, accum=ACCUM)
    start = jax_state_np(jtr.state)
    jhist = jtr.run()
    ttr = Trainer(tb, TrainConfig(**TCFG_KW, steps=STEPS), _tcfg(),
                  cell=ShapeCell(*CELL), accum=ACCUM,
                  state=from_jax_state(start, device="cpu"),
                  uniforms=jax_uniforms(0),
                  batches=jax_batches(jb, JShapeCell(*CELL), 0))
    LAUNCHES.clear()
    thist = ttr.run()
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose([h["grad_norm"] for h in thist],
                               [h["grad_norm"] for h in jhist], rtol=2e-3)
    assert ttr.controller.svd_count_summary() == \
        jtr.controller.svd_count_summary()
    assert ttr.controller.interval_summary() == \
        jtr.controller.interval_summary()
    assert LAUNCHES["fused_qgalore_update_ref"] > 0
    assert LAUNCHES["int8_matmul"] == LAUNCHES["fused_qgalore_update"] == 0
    # held-out loss on the reference's held-out batches (seed + 1)
    ttr.eval_batches = jax_batches(jb, JShapeCell(*CELL), 1)
    assert ttr.eval_loss(2) == pytest.approx(jtr.eval_loss(2), rel=2e-3,
                                             abs=2e-3)


def test_steps_leave_no_tensor_to_the_collector(bundles):
    """With the garbage collector off, a refresh step and steady steps at
    ``accum`` 2 leave no tensor alive but the trainer's state: no reference
    cycle holds a step's gradients (tens of GiB at 7B on the card) until
    the collector happens to run."""
    _, tb = bundles
    tr = Trainer(tb, TrainConfig(**TCFG_KW, steps=3), _tcfg(),
                 cell=ShapeCell(*CELL), accum=ACCUM)

    def storages(ts):
        return {t.untyped_storage().data_ptr() for t in ts}

    def tensors():
        with warnings.catch_warnings():     # deprecated objects warn
            warnings.simplefilter("ignore")
            return [o for o in gc.get_objects()
                    if torch.is_tensor(o) and o.numel() >= 1024]
    gc.collect()
    before = storages(tensors())
    gc.disable()
    try:
        tr.run()
        # a view of the state (a reshaped stack) keeps its base tensor
        # object: count memory, not objects
        keep = before | storages(checkpoint.state_tensors(tr.state))
        left = [t for t in tensors()
                if t.untyped_storage().data_ptr() not in keep]
    finally:
        gc.enable()
    assert not left, [tuple(t.shape) for t in left]
