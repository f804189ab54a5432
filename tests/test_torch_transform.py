"""The port's transform chain (``core/transform.py``): the stage-by-stage
reference chain against the port's own monolith (``qgalore.apply_updates``
with ``fused_update=False``) bit for bit, the production executor
``qgalore_transform`` against ``apply_updates``, and the port's chain
against the JAX package's chain on the reference's own gradients and
uniforms (a refresh step, then a steady one).

The model is llama-60m smoke split after one layer, under the fine-tune
rule-set (a frozen base and first layer, rank 8 on the rest) and under the
plain golden configuration, so frozen leaves, stacked and whole leaves,
and the float norms all pass through the stages."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adam8bit as jadam
from repro.core import qgalore as jqg
from repro.core import quant as jq
from repro.core import transform as jtransform
from repro.launch import finetune as jfinetune
from repro_torch.config import QGaLoreConfig, ShapeCell
from repro_torch.core import qgalore, quant, transform
from repro_torch.core.rules import ParamRules
from repro_torch.data.synthetic import batch_for_bundle
from repro_torch.kernels import LAUNCHES
from repro_torch.launch import finetune
from repro_torch.models import model_zoo
from repro_torch.train import stack, step

from test_torch_train import (QCFG_KW, _check_state, _jcfg, _tcfg,
                              align_signs_to_jax, jax_uniforms)

LR = 5e-3


def _rules(kind: str, fused: bool = True):
    base = dataclasses.replace(_tcfg(), fused_update=fused)
    if kind == "plain":
        return ParamRules(base=base)
    r = finetune.build_finetune_rules(QGaLoreConfig(**QCFG_KW), rank=8)
    return ParamRules(base=dataclasses.replace(r.base, fused_update=fused),
                      groups=r.groups)


@pytest.fixture(scope="module")
def model():
    """The port's split smoke model (float32, CPU) and one batch."""
    bundle = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                  dtype=torch.float32, split_layers=1)
    batch = batch_for_bundle(bundle, ShapeCell("t", 32, 4, "train"), 0, 0)
    return bundle, batch


def _setup(model, kind: str, fused: bool, lowrank: bool):
    bundle, batch = model
    rules = _rules(kind, fused)
    state = step.init_state(bundle, rules, seed=0)
    specs = qgalore.leaf_specs(state.params, rules)
    trees = qgalore.unflatten([k for k, _ in qgalore.flatten(state.params)],
                              state.opt.proj) if lowrank else {}
    _, grads = stack.fused_value_and_grad(bundle, state.params, batch, trees)
    grads, _ = transform.clip_by_global_norm(grads, 1.0, specs=specs)
    return rules, state, specs, grads


def _masks(specs, refresh):
    return {i: np.ones((s.nbatch,), bool)
            for i, s in enumerate(specs) if s.galore} if refresh else None


def _uniforms(seed: int = 3):
    return step.generator_uniforms(seed, "cpu")


def _tensors(tree):
    out = []
    for _, leaf in qgalore.flatten(tree):
        if leaf is None:
            out.append(None)
        elif isinstance(leaf, quant.QTensor):
            out.extend(t for t in (leaf.q, leaf.scale, leaf.zero)
                       if t is not None)
        elif isinstance(leaf, qgalore.Adam8bitState):
            out.extend(_tensors({"m": leaf.m, "v": leaf.v}))
        else:
            out.append(leaf)
    return out


def _assert_bit_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("refresh", [False, True], ids=["steady", "refresh"])
@pytest.mark.parametrize("kind", ["finetune", "plain"])
def test_reference_chain_equals_unfused_monolith(model, kind, refresh):
    """The four stages composed literally give the monolith's unfused
    update bit for bit: params, projections, moments, count, sims. The
    port updates leaves one by one (the reference's ``batch_leaves=False``
    by construction)."""
    rules, state, specs, grads = _setup(model, kind, fused=False,
                                        lowrank=not refresh)
    draw = _uniforms()
    uni = lambda leaf, layer, shape: draw(0, leaf, layer, shape)
    masks = _masks(specs, refresh)
    LAUNCHES.clear()
    want_p, want_o, want_m = qgalore.apply_updates(
        state.params, grads, state.opt, rules, LR, uni, refresh_masks=masks,
        refresh=refresh, specs=specs)
    assert LAUNCHES["fused_qgalore_update_ref"] == 0
    tx = transform.qgalore_reference_chain(rules)
    got_p, got_s, got_m = tx.update(
        grads, transform.chain_state(state.opt), state.params, lr=LR,
        uniforms=uni, refresh_masks=masks, refresh=refresh, specs=specs)
    assert LAUNCHES["fused_qgalore_update_ref"] == 0
    _assert_bit_equal(got_p, want_p)
    P, inner, n1, n2 = got_s.stages
    assert n1 is None and n2 is None and got_s.count == want_o.count == 1
    _assert_bit_equal(dict(enumerate(P)), dict(enumerate(want_o.proj)))
    _assert_bit_equal(dict(enumerate(inner)), dict(enumerate(want_o.inner)))
    assert got_m["sims"].keys() == want_m["sims"].keys()
    assert bool(got_m["sims"]) == refresh
    for k, v in want_m["sims"].items():
        np.testing.assert_array_equal(got_m["sims"][k], v)
    # frozen leaves pass through every stage as the same objects
    flat = [l for _, l in qgalore.flatten(state.params)]
    for i, (_, l) in enumerate(qgalore.flatten(got_p)):
        if specs[i].frozen:
            assert l is flat[i] and P[i] is None and inner[i] is None


@pytest.mark.parametrize("refresh", [False, True], ids=["steady", "refresh"])
def test_qgalore_transform_is_the_monolith(model, refresh):
    """``qgalore_transform`` initialises and updates exactly as
    ``qgalore.init`` / ``apply_updates`` (the fused path, through the
    plain fused version on the CPU), and its state is a ``QGaLoreState``;
    the reference chain's ``init`` draws the same projections."""
    bundle, _ = model
    rules, state, specs, grads = _setup(model, "finetune", fused=True,
                                        lowrank=not refresh)
    tx = transform.qgalore_transform(rules, specs=specs)
    opt0 = tx.init(state.params, seed=1)
    assert isinstance(opt0, qgalore.QGaLoreState)
    _assert_bit_equal(dict(enumerate(opt0.proj)), dict(enumerate(
        qgalore.init(state.params, rules, 1, specs).proj)))
    chain0 = transform.qgalore_reference_chain(rules).init(state.params,
                                                           seed=1)
    _assert_bit_equal(dict(enumerate(chain0.stages[0])),
                      dict(enumerate(opt0.proj)))
    _assert_bit_equal(dict(enumerate(chain0.stages[1])),
                      dict(enumerate(opt0.inner)))
    draw = _uniforms()
    uni = lambda leaf, layer, shape: draw(0, leaf, layer, shape)
    masks = _masks(specs, refresh)
    LAUNCHES.clear()
    got = tx.update(grads, state.opt, state.params, lr=LR, uniforms=uni,
                    refresh_masks=masks, refresh=refresh)
    n_fused = LAUNCHES["fused_qgalore_update_ref"]
    want = qgalore.apply_updates(state.params, grads, state.opt, rules, LR,
                                 uni, refresh_masks=masks, refresh=refresh,
                                 specs=specs)
    assert isinstance(got[1], qgalore.QGaLoreState)
    assert n_fused == (0 if refresh else
                       sum(s.nbatch for s in specs if s.galore))
    _assert_bit_equal(got[0], want[0])
    _assert_bit_equal(dict(enumerate(got[1].proj)),
                      dict(enumerate(want[1].proj)))
    _assert_bit_equal(dict(enumerate(got[1].inner)),
                      dict(enumerate(want[1].inner)))
    assert got[1].count == want[1].count == 1


def test_chain_clip_stage_and_errors(model):
    """The clip stage scales like the train step's clip and reports the
    norm; the weight-decay stage adds ``wd * W``; a chain without rules or
    a backproject without a project stage is refused."""
    _, state, _, grads = _setup(model, "plain", fused=False, lowrank=False)
    # no GaLore: Adam runs on the full-rank gradients the decay adds to
    rules = ParamRules(base=dataclasses.replace(_tcfg(), enabled=False))
    specs = qgalore.leaf_specs(state.params, rules)
    flat = [g.clone() for _, g in qgalore.flatten(grads)]
    keys = [k for k, _ in qgalore.flatten(grads)]
    want, norm = transform.clip_by_global_norm(
        qgalore.unflatten(keys, [g.clone() for g in flat]), 0.5, specs=specs)
    assert float(norm) == pytest.approx(
        float(transform.global_norm(grads)), rel=1e-6)
    tx = transform.chain(transform.clip_global_norm(0.5),
                         transform.quantized_adam(rules),
                         transform.add_weight_decay(0.1),
                         transform.sr_requant(rules))
    uni = lambda leaf, layer, shape: _uniforms()(0, leaf, layer, shape)
    s0 = tx.init(state.params)
    _, s1, m = tx.update(qgalore.unflatten(keys, flat), s0, state.params,
                         lr=LR, uniforms=uni, specs=specs)
    assert float(m["grad_norm"]) == float(norm) and s1.count == 1
    for g, w in zip(flat, [x for _, x in qgalore.flatten(want)]):
        assert torch.equal(g, w)       # scaled in place, as the step's clip
    with pytest.raises(ValueError, match="rules"):
        transform.chain(transform.clip_global_norm(1.0))
    bad = transform.chain(transform.backproject(rules))
    with pytest.raises(ValueError, match="project"):
        bad.update(grads, bad.init(state.params), state.params, lr=LR,
                   uniforms=uni, specs=specs)


# ---------------------------------------------------------------------------
# against the JAX package's chain
# ---------------------------------------------------------------------------

def to_jax(x):
    """A port tree (QTensors, Adam states, tensors, None) as the JAX
    package's, through numpy."""
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not isinstance(
            x, qgalore.Adam8bitState):
        return [to_jax(v) for v in x]
    if isinstance(x, qgalore.Adam8bitState):
        return jadam.Adam8bitState(to_jax(x.m), to_jax(x.v))
    if isinstance(x, quant.QTensor):
        q, sc, z, bits, block, last, dt = quant.to_numpy(x)
        return jq.QTensor(jnp.asarray(q), jnp.asarray(sc),
                          None if z is None else jnp.asarray(z), bits,
                          block, last, dt)
    return None if x is None else jnp.asarray(x.numpy())


def test_chain_matches_jax_chain(model, monkeypatch):
    """The port's reference chain and the JAX package's under the
    fine-tune rules, from one state and one batch's clipped full-rank
    gradients (the port's, handed over through numpy) with the
    reference's uniforms: a refresh step (every GaLore layer by SVD,
    singular-vector signs aligned) then a steady step. Codes within one
    INT8 quantum (nearly all equal), moments within one quantum of their
    8-bit storage, P within one INT4 quantum
    (``test_torch_train._check_state``). No bit-exact claim: the
    reference's own chain-versus-monolith parity is red on some hosts."""
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", align_signs_to_jax)
    jr = jfinetune.build_finetune_rules(_jcfg(), rank=8)
    tr, tstate, tspecs, tg = _setup(model, "finetune", fused=True,
                                    lowrank=False)
    assert tr.fingerprint() == jr.fingerprint()
    jparams = to_jax(tstate.params)
    jspecs = jqg.leaf_specs(jparams, jr)
    assert [(s.path, s.frozen, s.rank, s.side) for s in tspecs] == \
        [(s.path, s.frozen, s.rank, s.side) for s in jspecs]
    jg = to_jax(tg)
    jtx = jtransform.qgalore_reference_chain(jr)
    ttx = transform.qgalore_reference_chain(tr)
    ts = transform.chain_state(tstate.opt)
    js = jtransform.ChainState((to_jax(ts.stages[0]), to_jax(ts.stages[1]),
                                None, None), jnp.int32(0))
    jp, tp = jparams, tstate.params
    draw = jax_uniforms(0)
    for s, refresh in enumerate((True, False)):
        jm = {i: jnp.ones((x.nbatch,), bool)
              for i, x in enumerate(jspecs) if x.galore} if refresh else None
        jp, js, _ = jtx.update(jg, js, jp, lr=LR,
                               rng=jax.random.fold_in(jax.random.PRNGKey(17),
                                                      s),
                               refresh_masks=jm, refresh=refresh,
                               specs=jspecs)
        tp, ts, _ = ttx.update(
            tg, ts, tp, lr=LR,
            uniforms=lambda leaf, layer, shape, s=s: draw(s, leaf, layer,
                                                          shape),
            refresh_masks=_masks(tspecs, refresh), refresh=refresh,
            specs=tspecs)
    tP, tI = ts.stages[0], ts.stages[1]
    _check_state(tp, SimpleNamespace(inner=[x for x in tI if x is not None],
                                     proj=tP, count=ts.count),
                 jp, SimpleNamespace(inner=js.stages[1], proj=js.stages[0],
                                     count=js.count))
    assert ts.count == int(js.count) == 2
    frozen = [i for i, x in enumerate(tspecs) if x.frozen]
    t_flat = [l for _, l in qgalore.flatten(tp)]
    s_flat = [l for _, l in qgalore.flatten(tstate.params)]
    assert frozen and all(t_flat[i] is s_flat[i] for i in frozen)
