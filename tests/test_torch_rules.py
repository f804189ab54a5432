"""The port's param-group rules and memory model against the JAX package:
``ParamRules.fingerprint`` string-equal for the same rules, the same
per-leaf group resolution, ``memory_report`` equal field for field for the
five methods of ``benchmarks/table2_memory.py`` on llama-60m, -1b and -7b
(the 7B layout built without allocating: ``jax.eval_shape`` there, the
``meta`` device here), and one refresh and one steady optimizer step under
a rule-set (a frozen group, a rank override, a learning-rate multiplier,
an 8-bit projection) on the reference's own gradients and uniforms."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.core import optimizers as jopt
from repro.core import qgalore as jqg
from repro.core import rules as jrules
from repro.core import transform as jtransform
from repro.data import synthetic as jsyn
from repro.models import model_zoo as jzoo
from repro.train import stack as jstack
from repro.train import step as jstep
from repro_torch.config import QGaLoreConfig
from repro_torch.core import optimizers, qgalore, rules
from repro_torch.models import model_zoo
from repro_torch.serve.params import from_jax_state
from repro_torch.train import step

from test_torch_train import (_check_state, _jcfg, _tcfg, align_signs_to_jax,
                              jax_state_np, jax_uniforms)

# the methods and ranks of benchmarks/table2_memory.py
METHODS = ("full", "adam8bit", "galore", "galore8bit", "qgalore")
RANKS = {"llama-60m": 128, "llama-1b": 512, "llama-7b": 1024}


def _rule_sets(port: bool):
    """The same rule-sets built in either package."""
    cfg_cls = QGaLoreConfig if port else JQGaLoreConfig
    preset = optimizers.preset if port else jopt.preset
    mod = rules if port else jrules
    base = preset("qgalore", cfg_cls(rank=8, min_dim=32))
    G = mod.ParamGroup
    return [
        base,
        mod.ParamRules(base=base),
        mod.ParamRules(base=base, groups=(
            G("frozen", pattern=r"embedding", frozen=True),
            G("attn", pattern=r"attn", rank=4, update_interval=2),)),
        mod.ParamRules(base=base, groups=(
            G("mlp", pattern=r"/ffn/", rank=4, proj_bits=8, lr_scale=0.5,
              weight_decay=0.1),
            G("head", pattern=r"head", adam_bits=32, weight_bits=0),)),
        # recipe knobs only: the group's name and pattern still count
        mod.ParamRules(base=base, groups=(
            G("slow", pattern=r"wq", lr_scale=0.1, cos_threshold=0.9,
              stochastic_rounding=False),)),
        preset("galore", cfg_cls(rank=16, min_dim=64, quant_block=128)),
    ]


def test_fingerprint_matches_jax():
    got = [rules.as_rules(r).fingerprint() for r in _rule_sets(True)]
    want = [jrules.as_rules(r).fingerprint() for r in _rule_sets(False)]
    assert got == want
    assert got[0] == got[1]
    assert len(set(got)) == 5
    assert rules.normalize_path("['seg0_dense']['attn']['wq']") == \
        jrules.normalize_path("['seg0_dense']['attn']['wq']")
    with pytest.raises(TypeError):
        rules.as_rules(object())


@pytest.fixture(scope="module")
def smoke_params():
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    tb = model_zoo.build_arch("llama-60m", smoke=True, device="meta",
                              dtype=torch.float32)
    return jb, tb


@pytest.mark.parametrize("which", range(6))
def test_group_resolution_matches_jax(smoke_params, which):
    """Every leaf resolves to the same group, with the same GaLore side,
    rank, frozen flag and learning-rate multiplier; ``group_assignment``
    (the checkpoint's group map) is equal."""
    jb, tb = smoke_params
    tr, jr = _rule_sets(True)[which], _rule_sets(False)[which]
    jp = jax.eval_shape(lambda k: jstep.prepare_params(
        jb.init_params(k), jr, jnp.float32), jax.random.PRNGKey(0))
    tp = step.abstract_params(tb, tr, torch.float32)
    js, ts = jqg.leaf_specs(jp, jr), qgalore.leaf_specs(tp, tr)
    fields = ("path", "shape", "galore", "side", "rank", "batch", "frozen",
              "lr_scale", "group")
    assert [tuple(getattr(s, f) for f in fields) for s in ts] == \
        [tuple(getattr(s, f) for f in fields) for s in js]
    assert rules.group_assignment(ts) == jrules.group_assignment(js)
    # the weights each group keeps INT8 (weight_bits per group)
    is_q = lambda x: isinstance(x, jqg.quant.QTensor)
    assert [isinstance(l, qgalore.QTensor)
            for _, l in qgalore.flatten(tp)] == \
        [is_q(l) for l in jax.tree_util.tree_leaves(jp, is_leaf=is_q)]


@pytest.mark.parametrize("arch", list(RANKS))
def test_memory_report_matches_jax(arch):
    """``memory_report`` field for field, the five methods, no allocation;
    ``optimizer_state_bytes`` and ``dp_payload_bytes`` too."""
    jb = jzoo.build(jzoo.get_config(arch))
    tb = model_zoo.build(model_zoo.get_config(arch), device="meta")
    for method in METHODS:
        jq = jopt.preset(method, JQGaLoreConfig(rank=RANKS[arch]))
        tq = optimizers.preset(method, QGaLoreConfig(rank=RANKS[arch]))
        jp = jax.eval_shape(lambda k: jstep.prepare_params(
            jb.init_params(k), jq, jnp.bfloat16), jax.random.PRNGKey(0))
        tp = step.abstract_params(tb, tq, torch.bfloat16)
        assert qgalore.memory_report(tp, tq) == jqg.memory_report(jp, jq), \
            (arch, method)
        assert qgalore.optimizer_state_bytes(tp, tq) == \
            jqg.optimizer_state_bytes(jp, jq)
        assert qgalore.dp_payload_bytes(qgalore.leaf_specs(tp, tq)) == \
            jqg.dp_payload_bytes(jqg.leaf_specs(jp, jq))
    if arch == "llama-7b":
        # the repo's 7B figure: weights + optimizer state under 16 GiB
        rep = qgalore.memory_report(tp, tq)
        assert rep["total_gb"] < 16.0


def _rules_pair():
    """A rule-set over the golden configuration: the embedding frozen,
    attention at rank 4 with lr x 0.5, the MLP with an 8-bit P (off the
    fused kernel's recipe, so its steady update runs unfused)."""
    def build(mod, base):
        G = mod.ParamGroup
        return mod.ParamRules(base=base, groups=(
            G("frozen", pattern=r"embedding", frozen=True),
            G("attn", pattern=r"/attn/", rank=4, lr_scale=0.5),
            G("mlp", pattern=r"/ffn/", proj_bits=8),))
    return build(rules, _tcfg()), build(jrules, _jcfg())


def test_rule_set_steps_match_jax(monkeypatch):
    """A refresh step then a steady step under the rule-set, both packages
    from the reference's init, on the reference's gradients and uniforms:
    the state within one quantum (``test_torch_train._check_state``), the
    frozen leaves untouched and stateless."""
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", align_signs_to_jax)
    tr, jr = _rules_pair()
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    jstate = jstep.init_state(jb, jr, jax.random.PRNGKey(0), jnp.float32)
    tstate = from_jax_state(jax_state_np(jstate), device="cpu")
    jspecs = jqg.leaf_specs(jstate.params, jr)
    tspecs = qgalore.leaf_specs(tstate.params, tr)
    frozen = [i for i, s in enumerate(tspecs) if s.frozen]
    assert frozen and [s.frozen for s in jspecs] == [s.frozen
                                                       for s in tspecs]
    assert all(tstate.opt.inner[i] is None for i in frozen)
    jbatch = jsyn.batch_for_bundle(jb, JShapeCell("r", 32, 4, "train"), 0, 0)
    _, jg = jstack.fused_value_and_grad(jb, jstate.params, jbatch, {})
    jg, _ = jtransform.clip_by_global_norm(jg, 1.0, specs=jspecs)
    tg = qgalore.unflatten([k for k, _ in qgalore.flatten(tstate.params)],
                           [torch.from_numpy(np.array(g))
                            for g in jax.tree_util.tree_leaves(jg)])
    jp, jo, tp, to = jstate.params, jstate.opt, tstate.params, tstate.opt
    draw = jax_uniforms(0)
    for s, refresh in enumerate((True, False)):
        jm = {i: jnp.ones((x.nbatch,), bool)
              for i, x in enumerate(jspecs) if x.galore} if refresh else None
        tm = {i: np.ones((x.nbatch,), bool)
              for i, x in enumerate(tspecs) if x.galore} if refresh else None
        rng = jax.random.fold_in(jax.random.PRNGKey(17), s)
        jp, jo, _ = jqg.apply_updates(jp, jg, jo, jr, 5e-3, rng,
                                      refresh_masks=jm, refresh=refresh,
                                      specs=jspecs)
        tp, to, _ = qgalore.apply_updates(
            tp, tg, to, tr, 5e-3,
            lambda leaf, layer, shape, s=s: draw(s, leaf, layer, shape),
            refresh_masks=tm, refresh=refresh, specs=tspecs)
    # the reference's inner tree drops the frozen leaves' None
    _check_state(tp, qgalore.QGaLoreState(
        [i for i in to.inner if i is not None], to.proj, to.count), jp, jo)
    t_flat = [l for _, l in qgalore.flatten(tp)]
    s_flat = [l for _, l in qgalore.flatten(tstate.params)]
    for i in frozen:
        assert t_flat[i] is s_flat[i]
        assert to.inner[i] is None and to.proj[i] is None
