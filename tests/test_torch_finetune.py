"""The port's fine-tuning path (``launch/finetune.py``, ``split_layers``)
against the JAX package's ``tests/test_finetune.py`` and a live reference
run: the rule-set's shape and first-match resolution, ``split_layers`` out
of range, the split model against the unsplit one (bit-equal) and against
the JAX split bundle, the report of ``run`` with its memory figures equal
to the reference's, a 6-step fine-tune trajectory from the reference's
state with its batches and SR uniforms, and checkpoints refused under
other rules in both directions. One live JAX fine-tune is shared by the
file."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.config import TrainConfig as JTrainConfig
from repro.core import optimizers as jopt
from repro.core import qgalore as jqg
from repro.data import synthetic as jsyn
from repro.launch import finetune as jfinetune
from repro.models import base as jbase
from repro.models import lora as jlora
from repro.models import model_zoo as jzoo
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
from repro_torch.core import qgalore, quant
from repro_torch.core.optimizers import preset
from repro_torch.data.synthetic import batch_for_bundle
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import finetune
from repro_torch.models import base, model_zoo
from repro_torch.serve.params import from_jax_params, from_jax_state
from repro_torch.train import stack, step
from repro_torch.train.trainer import Trainer

from test_torch_train import (aligned_svd, jax_batches, jax_state_np,  # noqa
                              jax_uniforms)
from test_torch_transform import to_jax
from torch_one_thread import one_thread  # noqa: F401

STEPS = 6
# run()'s smoke settings for 6 steps
QKW = dict(rank=8, min_dim=32, update_interval=max(STEPS // 4, 2))
TKW = dict(global_batch=4, seq_len=32, steps=STEPS, learning_rate=1e-3,
           warmup_steps=max(STEPS // 10, 1), log_every=0)
REPORT_KEYS = {"arch", "smoke", "steps", "rank", "freeze_layers", "groups",
               "frozen_leaves", "tuned_leaves", "final_loss", "first_loss",
               "qgalore", "qlora", "qgalore_leq_qlora", "svd_used"}


@pytest.fixture(scope="module")
def live():
    """The reference's fine-tune trainer as ``run`` builds it (llama-60m
    smoke split after one layer, rank 8), its starting state as numpy, and
    its 6-step history; the similarities it saw are recorded."""
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32,
                         split_layers=1)
    jr = jfinetune.build_finetune_rules(JQGaLoreConfig(**QKW), 8)
    cell = JShapeCell("finetune", 32, 4, "train")
    jtr = JTrainer(jb, JTrainConfig(**TKW, async_checkpoint=False), jr,
                   cell=cell, param_dtype=jnp.float32)
    start = jax_state_np(jtr.state)
    seen = []
    observe = jtr.controller.observe

    def recording(s, masks, sims, ratios=None):
        seen.extend(float(v) for a in sims.values()
                    for v in np.asarray(a).ravel() if v >= 0)
        return observe(s, masks, sims, ratios)

    jtr.controller.observe = recording
    hist = jtr.run()
    return {"bundle": jb, "rules": jr, "trainer": jtr, "start": start,
            "hist": hist, "seen": seen, "cell": cell}


def _port_rules(freeze_early=True):
    return finetune.build_finetune_rules(QGaLoreConfig(**QKW), 8,
                                         freeze_early=freeze_early)


def test_finetune_rules_shape():
    """Group names and ranks, first-match resolution, both forms of the
    rule-set; the checkpoint fingerprint is the reference's."""
    rules = finetune.build_finetune_rules(
        QGaLoreConfig(rank=16, min_dim=32), rank=16)
    assert [g.name for g in rules.groups] == ["frozen_base",
                                              "qgalore_blocks"]
    assert rules.groups[0].frozen and rules.groups[1].rank == 16
    assert rules.resolve("['seg0_dense']['attn']['wq']").name == \
        "frozen_base"
    assert rules.resolve("['seg1_dense']['attn']['wq']").name == \
        "qgalore_blocks"
    assert rules.resolve("['final_norm']").name == "frozen_base"
    rules0 = finetune.build_finetune_rules(
        QGaLoreConfig(rank=16, min_dim=32), rank=16, freeze_early=False)
    assert rules0.resolve("['seg0_dense']['attn']['wq']").name == \
        "qgalore_blocks"
    assert rules0.resolve("['embedding']").name == "frozen_base"
    for early in (True, False):
        assert _port_rules(early).fingerprint() == \
            jfinetune.build_finetune_rules(JQGaLoreConfig(**QKW), 8,
                                           freeze_early=early).fingerprint()


@pytest.mark.parametrize("bad", [2, 3, -1])
def test_split_layers_out_of_range_rejected(bad):
    cfg = model_zoo.get_config("llama-60m", smoke=True)      # 2 layers
    with pytest.raises(ValueError, match="split_layers"):
        model_zoo.build(cfg, device="cpu", dtype=torch.float32,
                        split_layers=bad)


def _slice(x, sl):
    if isinstance(x, dict):
        return {k: _slice(v, sl) for k, v in x.items()}
    if isinstance(x, quant.QTensor):
        return x.map(lambda t: t[sl].clone())
    return x[sl].clone()


def test_split_model_equals_unsplit():
    """The same weights in one segment and in two: two segments named
    ``seg0_dense`` and ``seg1_dense``, the loss bit-equal through the
    plain forward and the fused backward, and the gradients bit-equal
    (the split stacks concatenated)."""
    cfg = model_zoo.get_config("llama-60m", smoke=True)
    one = model_zoo.build(cfg, device="cpu", dtype=torch.float32)
    two = model_zoo.build(cfg, device="cpu", dtype=torch.float32,
                          split_layers=1)
    assert [two.seg_key(i) for i in range(2)] == ["seg0_dense",
                                                  "seg1_dense"]
    assert [s.n_layers for s in two.segments] == [1, 1]
    p1 = step.init_state(one, QGaLoreConfig(), seed=4).params
    p2 = {k: v for k, v in p1.items() if k != "seg0_dense"}
    p2["seg0_dense"] = _slice(p1["seg0_dense"], slice(0, 1))
    p2["seg1_dense"] = _slice(p1["seg0_dense"], slice(1, 2))
    batch = batch_for_bundle(one, ShapeCell("s", 16, 2, "train"), 0, 1)
    l1 = base.loss_fn(one, p1, batch)[0]
    l2 = base.loss_fn(two, p2, batch)[0]
    assert torch.equal(l1, l2)
    (f1, _), g1 = stack.fused_value_and_grad(one, p1, batch, {})
    (f2, _), g2 = stack.fused_value_and_grad(two, p2, batch, {})
    assert torch.equal(f1, f2) and torch.equal(f1, l1)
    s0, s1 = (dict(qgalore.flatten(g2[k])) for k in ("seg0_dense",
                                                     "seg1_dense"))
    for keys, a in qgalore.flatten(g1["seg0_dense"]):
        assert torch.equal(a, torch.cat([s0[keys], s1[keys]])), keys
    for k in ("embedding", "final_norm", "head"):
        assert torch.equal(g1[k], g2[k])


def test_split_loss_matches_jax(live):
    """The port's split bundle on the reference's starting weights: the
    loss within the model tolerance (1e-4 relative) of the JAX split
    bundle's."""
    jb, start = live["bundle"], live["start"]
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                              dtype=torch.float32, split_layers=1)
    tp = from_jax_params(start["params"], device="cpu")
    jb_batch = jsyn.batch_for_bundle(jb, live["cell"], 0, 0)
    want = jbase.loss_fn(jb, to_jax(tp), jb_batch)[0]
    got = base.loss_fn(tb, tp, {k: torch.from_numpy(np.array(v))
                                for k, v in jb_batch.items()})[0]
    assert float(got) == pytest.approx(float(want), rel=1e-4)


def test_finetune_report_and_memory_match_jax(live, tmp_path):
    """``run`` at smoke size on the CPU: the report's keys, the JSON on
    disk, the contracts' figures, and the Q-GaLore and QLoRA memory equal
    the reference's (``memory_report`` on the same layout, the adapters
    under the ``full`` recipe) to 1e-12."""
    out = str(tmp_path / "finetune_memory.json")
    report = finetune.run(arch="llama-60m", smoke=True, steps=STEPS, rank=8,
                          freeze_layers=1, out=out, device="cpu")
    assert set(report) == REPORT_KEYS
    assert os.path.exists(out)
    with open(out) as f:
        assert json.load(f)["qgalore_leq_qlora"] is True
    assert report["qgalore"]["total_gb"] <= report["qlora"]["total_gb"]
    assert report["frozen_leaves"] > 0 and report["tuned_leaves"] > 0
    assert report["groups"]["frozen_base"] == report["frozen_leaves"]
    assert report["rank"] == 8
    assert 0 < report["qgalore"]["optimizer_gb"] \
        < report["qlora"]["adapter_plus_opt_gb"]
    assert np.isfinite(report["final_loss"])
    jtr, jr = live["trainer"], live["rules"]
    jspecs = jtr.specs
    assert report["groups"] == {g: sum(1 for s in jspecs if s.group == g)
                                for g in sorted({s.group for s in jspecs})}
    rep = jqg.memory_report(jtr.state.params, jr)
    adapter_gb = jqg.memory_report(
        jlora.init_adapters(jtr.state.params, 8, jax.random.PRNGKey(0)),
        jopt.preset("full"))["total_gb"]
    want = {"qgalore": {k: rep[k] for k in ("weights_gb", "optimizer_gb",
                                            "total_gb")},
            "qlora": {"weights_gb": rep["weights_gb"],
                      "adapter_plus_opt_gb": adapter_gb,
                      "total_gb": rep["weights_gb"] + adapter_gb}}
    for side, fields in want.items():
        for k, v in fields.items():
            assert report[side][k] == pytest.approx(v, rel=0, abs=1e-12), \
                (side, k)


def test_finetune_trajectory_matches_jax(live, aligned_svd):  # noqa: F811
    """The port's trainer under the fine-tune rules from the reference's
    starting state, with its batches and SR uniforms: the 6 losses within
    2e-3, the SVD counts and intervals equal, the contracts held, and the
    frozen leaves bit-equal to the reference's after training."""
    seen = live["seen"]
    assert seen and min(abs(s - 0.4) for s in seen) > 1e-3
    jb, jtr = live["bundle"], live["trainer"]
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                              dtype=torch.float32, split_layers=1)
    rules = _port_rules()
    ttr = Trainer(tb, TrainConfig(**TKW), rules,
                  cell=ShapeCell("finetune", 32, 4, "train"),
                  state=from_jax_state(live["start"], device="cpu"),
                  uniforms=jax_uniforms(0),
                  batches=jax_batches(jb, live["cell"], 0))
    specs = ttr.specs
    frozen = finetune.check_frozen_stateless(specs, ttr.state.opt)
    finetune.check_group_ranks(specs, 8)
    before = finetune.frozen_weights(ttr.state.params, specs)
    LAUNCHES.clear()
    hist = ttr.run()
    finetune.check_frozen_unchanged(before, ttr.state.params, specs)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in live["hist"]],
                               rtol=2e-3, atol=2e-3)
    assert ttr.controller.svd_count_summary() == \
        jtr.controller.svd_count_summary()
    assert ttr.controller.interval_summary() == \
        jtr.controller.interval_summary()
    assert ttr.controller.total_svd_count() == \
        jtr.controller.total_svd_count()
    jflat = jax.tree_util.tree_leaves(jtr.state.params,
                                      is_leaf=lambda x: isinstance(
                                          x, jqg.quant.QTensor))
    tflat = [l for _, l in qgalore.flatten(ttr.state.params)]
    for i in frozen:
        t, j = tflat[i], jflat[i]
        if isinstance(t, quant.QTensor):
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
            np.testing.assert_array_equal(t.scale.numpy(),
                                          np.asarray(j.scale))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the fused update (its plain version on the CPU) runs on the tuned
    # layers only, at every step without a refresh
    n_tuned = sum(s.nbatch for s in specs if s.galore)
    n = LAUNCHES["fused_qgalore_update_ref"]
    assert n % n_tuned == 0 and 0 < n <= n_tuned * (STEPS - 1)


@pytest.mark.parametrize("direction", ["freeze_less", "freeze_more"])
def test_restore_under_different_rules_fails_loudly(tmp_path, direction):
    """A checkpoint written under one rule-set refuses a restore under the
    other with the rules-mismatch ValueError, before any array is read;
    the same rules restore."""
    bundle = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                  dtype=torch.float32, split_layers=1)
    base_cfg = preset("qgalore", QGaLoreConfig(rank=8, min_dim=32))
    ft = finetune.build_finetune_rules(QGaLoreConfig(rank=8, min_dim=32), 8)
    write, read = (ft, base_cfg) if direction == "freeze_less" \
        else (base_cfg, ft)

    def make(qcfg):
        tcfg = TrainConfig(global_batch=2, seq_len=16, steps=2,
                           learning_rate=1e-3, warmup_steps=1, log_every=0,
                           checkpoint_dir=str(tmp_path), checkpoint_every=0,
                           async_checkpoint=False)
        return Trainer(bundle, tcfg, qcfg,
                       cell=ShapeCell("t", 16, 2, "train"))

    tr = make(write)
    tr.run(steps=1)
    with pytest.raises(ValueError, match="param-group rules"):
        make(read).maybe_restore()
    assert make(write).maybe_restore() == 1


def test_finetune_cli(capsys, tmp_path):
    """``main`` with the reference's flags and ``--device cpu``: the
    report as JSON and the closing line; without ``--device`` and without
    a card it raises rather than run on the CPU."""
    out = tmp_path / "ft.json"
    assert finetune.main(["--smoke", "--steps", "4", "--device", "cpu",
                          "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "qgalore_leq_qlora=True" in text.splitlines()[-1]
    assert json.loads(out.read_text())["steps"] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            finetune.run(steps=2)
