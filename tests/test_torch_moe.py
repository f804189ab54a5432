"""The mixture of experts (qwen3-moe-30b-a3b) against the live JAX package
at its smoke config (E 8, top-2, expert_ff 32), f32: the batched INT8
matmul and its gradients, the MoE layer (drop-free, with drops at a small
capacity, and the capacity factor's branch), the model's loss, logits,
gradients, prefill and decode, a smoke config with a shared expert and a
leading dense layer, the slot scheduler's exact-length admission, and a
4-step Q-GaLore trajectory. Both packages compute on the same INT8 codes
(``from_jax_params``); the reference's batches, SR uniforms and SVD signs
are handed over as in ``test_torch_train.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import MoEConfig as JMoEConfig
from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.config import TrainConfig as JTrainConfig
from repro.config import replace as jreplace
from repro.core import optimizers as jopt
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.models import base as jbase
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro.train import stack as jstack
from repro.train import step as jstep
from repro.train.trainer import Trainer as JTrainer
from repro_torch.config import MoEConfig, QGaLoreConfig, ShapeCell, \
    TrainConfig, replace
from repro_torch.core import optimizers, qgalore, quant
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.models import base, model_zoo, moe
from repro_torch.serve import engine
from repro_torch.serve.params import from_jax_params, from_jax_state
from repro_torch.serve.scheduler import Request, Scheduler, make_scheduler
from repro_torch.train import stack
from repro_torch.train.trainer import Trainer

from test_models_smoke import make_batch
from test_torch_serve import _to_numpy
from test_torch_train import align_signs_to_jax, jax_batches, \
    jax_state_np, jax_uniforms
from torch_one_thread import one_thread  # noqa: F401

ARCH = "qwen3-moe-30b-a3b"
CELL = JShapeCell("t", seq_len=12, global_batch=2, kind="train")
OP_TOL = 1e-5       # one op at f32 on the same codes
FWD_TOL = 1e-4      # the model's logits and loss
GRAD_TOL = 5e-3     # the reference's per-leaf bar (tests/test_stack.py)


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _shared_cfg(cfg, moe_cls, rep):
    """The smoke config with one shared expert and a leading dense layer
    (its FFN 48 wide)."""
    return rep(cfg, moe=moe_cls(num_experts=8, top_k=2, expert_ff=32,
                                num_shared_experts=1, first_dense_layers=1,
                                dense_ff=48))


def _build(shared: bool):
    jcfg = jzoo.get_config(ARCH, smoke=True)
    tcfg = model_zoo.get_config(ARCH, smoke=True)
    if shared:
        jcfg = _shared_cfg(jcfg, JMoEConfig, jreplace)
        tcfg = _shared_cfg(tcfg, MoEConfig, replace)
    jb = jzoo.build(jcfg, dtype=jnp.float32)
    jp = jstep.prepare_params(jb.init_params(jax.random.PRNGKey(1)),
                              JQGaLoreConfig(), jnp.float32)
    jbatch = make_batch(jb, CELL)
    tb = model_zoo.build(tcfg, device="cpu", dtype=torch.float32)
    tp = from_jax_params(_to_numpy(jp), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jb, jp, jbatch, tb, tp, tbatch


@pytest.fixture(scope="module")
def models():
    """``models(shared)``: one build of each config, shared by the file."""
    cache = {}

    def get(shared=False):
        if shared not in cache:
            cache[shared] = _build(shared)
        return cache[shared]
    return get


# ---------------------------------------------------------------------------
# the batched INT8 matmul
# ---------------------------------------------------------------------------

def _qdb_inputs():
    """``tests/test_quantized_dense.py``'s batched shapes: x (4, 9, 64),
    W (4, 64, 300) (its codes padded to 512 columns), g (4, 9, 300)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 9, 64)).astype(np.float32)
    w = (rng.standard_normal((4, 64, 300)) * 0.1).astype(np.float32)
    g = rng.standard_normal((4, 9, 300)).astype(np.float32)
    jqt = jq.quantize_blockwise(jnp.asarray(w), bits=8, symmetric=True)
    tqt = quant.from_numpy(_to_numpy({"w": jqt})["w"], "cpu")
    return x, g, jqt, tqt


def test_quantized_dense_batched_matches():
    x, _, jqt, tqt = _qdb_inputs()
    want = jops.quantized_dense_batched(jnp.asarray(x), jqt,
                                        dtype=jnp.float32, backend="ref")
    LAUNCHES.clear()
    got = ops.quantized_dense_batched(torch.from_numpy(x), tqt,
                                      dtype=torch.float32)
    assert tuple(got.shape) == (4, 9, 300)
    assert _maxerr(got.numpy(), want) < OP_TOL
    # one plain call for all experts, no kernel on the CPU
    assert dict(LAUNCHES) == {"deq_matmul_batched": 1}


def test_quantized_dense_batched_grads_match():
    """``dL/dx`` (one ``deq_matmul_t_batched`` call) and ``dL/dW`` on the
    (E, K, N) shadow against jax.grad of the reference op."""
    x, g, jqt, tqt = _qdb_inputs()

    def f(shadow, xx):
        out = jops.quantized_dense_batched(xx, jq.QVirtual(jqt, shadow),
                                           dtype=jnp.float32, backend="ref")
        return jnp.sum(out * jnp.asarray(g))

    jdw, jdx = jax.grad(f, argnums=(0, 1))(jq.virtualize(jqt).shadow,
                                           jnp.asarray(x))
    wv = quant.virtualize(tqt)
    xt = torch.from_numpy(x).requires_grad_(True)
    LAUNCHES.clear()
    out = ops.quantized_dense_batched(xt, wv, dtype=torch.float32)
    dw, dx = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                 [wv.shadow, xt])
    assert LAUNCHES["deq_matmul_batched"] == 1
    assert LAUNCHES["deq_matmul_t_batched"] == 1
    assert tuple(dw.shape) == (4, 64, 300)
    assert _maxerr(dw.numpy(), jdw) < OP_TOL
    assert _maxerr(dx.numpy(), jdx) < OP_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batched_plain_versions_are_the_2d_ones_per_expert(dtype):
    """The kernels' plain versions at an expert axis compute, expert by
    expert, what the 2-D plain versions compute (to f32 rounding: the
    batched einsum sums in another order)."""
    from repro_torch.kernels import int8_matmul as ti8
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(3)
    E, M, K, N = 3, 5, 96, 512
    x = torch.randn((E, M, K), generator=gen).to(dtype)
    g = torch.randn((E, M, N), generator=gen).to(dtype)
    q = torch.randint(-127, 128, (E, K, N), generator=gen,
                      dtype=torch.int8)
    s = torch.rand((E, K, N // 256), generator=gen) * 0.01
    got = ti8.int8_matmul_batched(x, q, s)
    got_t = ti8.int8_matmul_t_batched(g, q, s)
    for e in range(E):
        assert _maxerr(got[e], ref.int8_matmul_ref(x[e], q[e], s[e], 256)) \
            < OP_TOL
        assert _maxerr(got_t[e], ref.int8_matmul_t_ref(g[e], q[e], s[e],
                                                       256)) < OP_TOL
    with pytest.raises(ValueError, match="expert axes differ"):
        ti8.int8_matmul_batched(x[:2], q, s)


def test_plan_counts_the_experts_and_not_the_rows():
    """The small path's K split fills the card from all E x N/128 column
    tiles (one split at an MoE layer's 128 experts), and no plan depends
    on M within a path."""
    from repro_torch.kernels.int8_matmul import plan
    assert plan(4, 2048, 768).splits == 8
    assert plan(4, 2048, 768, E=128).splits == 1
    assert plan(4, 768, 2048, E=128) == plan(16, 768, 2048, E=128)
    for M in (17, 160, 512):
        assert plan(M, 2048, 768, E=128).splits == plan(M, 2048, 768).splits


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer(models, shared=False):
    """The model's first MoE layer's parameters in both packages."""
    jb, jp, _, tb, tp, _ = models(shared)
    key = tb.seg_key(len(tb.segments) - 1)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp[key]["moe"])
    return jb.cfg, jl, base.layer_params(tp[key], 0)["moe"]


@pytest.mark.parametrize("shape,capacity", [
    ((2, 12, 64), None),        # T·k 48: C = T, nothing dropped
    ((2, 12, 64), 3),           # 6 tokens an expert on average: drops
    ((3, 700, 64), None),       # T·k 4200 > 4096: C from the factor
])
def test_moe_apply_matches(models, shape, capacity):
    cfg, jl, tl = _layer(models)
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    want, jaux = jmoe.moe_apply(jl, jnp.asarray(x), cfg, capacity=capacity,
                                dtype=jnp.float32)
    got, aux = moe.moe_apply(tl, torch.from_numpy(x), cfg,
                             capacity=capacity, dtype=torch.float32)
    assert tuple(got.shape) == shape
    assert _maxerr(got.numpy(), want) < OP_TOL
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    T = shape[0] * shape[1]
    C = moe.capacity_for(T, cfg.moe, capacity=capacity)
    if capacity is not None:
        # some tokens were dropped: the kept set must be the reference's
        ref = moe.moe_ref(tl, torch.from_numpy(x), cfg)
        assert _maxerr(got.numpy(), ref.numpy()) > 1e-2
    elif T * 2 > moe.DROP_FREE_TK:
        assert C == int(np.ceil(T * 2 / 8 * 1.25))
    else:
        assert C == T


def test_moe_ref_matches(models):
    cfg, jl, tl = _layer(models)
    x = np.random.default_rng(10).standard_normal((2, 5, 64)) \
        .astype(np.float32)
    want = jmoe.moe_ref(jl, jnp.asarray(x), cfg)
    got = moe.moe_ref(tl, torch.from_numpy(x), cfg)
    assert _maxerr(got.numpy(), want) < OP_TOL
    # drop-free dispatch computes the oracle's function
    out, _ = moe.moe_apply(tl, torch.from_numpy(x), cfg,
                           dtype=torch.float32)
    assert _maxerr(out.numpy(), got.numpy()) < OP_TOL


def test_combine_is_deterministic_and_ties_take_the_lower_expert(models):
    """Two runs give the same bits; equal router probabilities pick the
    lower expert first, as ``lax.top_k`` does."""
    cfg, _, tl = _layer(models)
    x = torch.randn((2, 12, 64), generator=torch.Generator().manual_seed(2))
    a, _ = moe.moe_apply(tl, x, cfg, dtype=torch.float32)
    b, _ = moe.moe_apply(tl, x, cfg, dtype=torch.float32)
    assert torch.equal(a, b)
    flat = dict(tl, router=torch.zeros_like(tl["router"]))
    w, e, _ = moe._route(flat["router"], x.reshape(-1, 64), cfg.moe)
    assert (e == torch.tensor([0, 1])).all()
    assert torch.allclose(w, torch.full_like(w, 0.5))
    # the expert-parallel entry on one shard (a one-rank gloo group)
    # computes what the layer does
    import tempfile

    import torch.distributed as dist
    from repro_torch.distributed.comm import Comm
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store",
                                world_size=1, rank=0)
        try:
            c, c_aux = moe.moe_ep_sharded(tl, x, cfg, Comm(),
                                          dtype=torch.float32)
        finally:
            dist.destroy_process_group()
    _, aux = moe.moe_apply(tl, x, cfg, dtype=torch.float32)
    assert torch.equal(c, a) and torch.equal(c_aux, aux)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _forward(jb, jp, jbatch, tb, tp, tbatch):
    carry, ctx = jb.embed(jp, jbatch)
    carry = jbase.run_segments(jb, jp, carry, ctx)
    jl, jm = jb.head_loss(jp, carry, jbatch)
    want = jb.head_logits(jp, carry)
    with torch.no_grad():
        tc, tctx = tb.embed(tp, tbatch)
        tc = base.run_segments(tb, tp, tc, tctx)
        tl, tm = tb.head_loss(tp, tc, tbatch)
        got = tb.head_logits(tp, tc)
    return (float(jl), float(jm["aux_loss"]), np.asarray(want)), \
        (float(tl), float(tm["aux_loss"]), got.numpy())


@pytest.mark.parametrize("shared", [False, True])
def test_forward_loss_aux_and_logits_match(models, shared):
    (jl, jaux, want), (tl, aux, got) = _forward(*models(shared))
    assert aux > 0
    assert tl == pytest.approx(jl, rel=FWD_TOL)
    assert aux == pytest.approx(jaux, rel=FWD_TOL)
    assert _maxerr(got, want) < FWD_TOL
    tb = models(shared)[3]
    names = [s.name for s in tb.segments]
    assert names == (["dense", "moe"] if shared else ["moe"])
    assert not tb.ragged_prefill_ok
    assert all(s.append is None for s in tb.segments if s.name == "moe")


@pytest.mark.parametrize("shared", [False, True])
def test_fused_value_and_grad_matches(models, shared):
    """Full-rank ``fused_value_and_grad`` against the reference's: the
    router gets the aux loss's gradient through the per-layer recompute
    (``dL/daux`` from the head), the expert stacks theirs per expert."""
    jb, jp, jbatch, tb, tp, tbatch = models(shared)
    (jl, jm), jg = jstack.fused_value_and_grad(jb, jp, jbatch, {})
    (tl, tm), tg = stack.fused_value_and_grad(tb, tp, tbatch, {})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(tm["aux_loss"]) == pytest.approx(float(jm["aux_loss"]),
                                                  rel=1e-5)
    flat = qgalore.flatten(tg)
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(flat) == len(leaves)
    paths = [k for k, _ in flat]
    key = tb.seg_key(len(tb.segments) - 1)
    assert (key, "moe", "router") in paths
    for (keys, g), want in zip(flat, leaves):
        assert torch.isfinite(g).all(), keys
        assert tuple(g.shape) == tuple(want.shape), keys
        assert _maxerr(g.numpy(), want) <= GRAD_TOL, keys


def test_aux_gradient_reaches_the_router(models):
    """Without the aux term's cotangent the router's gradient would be
    the cross-entropy's alone: the fused backward's equals the whole-graph
    autograd of the loss with aux."""
    _, _, _, tb, tp, tbatch = models()
    (_, _), tg = stack.fused_value_and_grad(tb, tp, tbatch, {})
    virt = stack._virt(tp)
    loss, _ = base.loss_fn(tb, virt, tbatch)
    router = virt["seg0_moe"]["moe"]["router"]
    want, = torch.autograd.grad(loss, [router])
    got = tg["seg0_moe"]["moe"]["router"]
    assert _maxerr(got.numpy(), want.numpy()) < 1e-5


def test_prefill_then_decode_matches_full_forward(models):
    """The port's prefill of 6 tokens, then teacher-forced decode at the
    drop-free capacity B·S, against the reference's full-sequence logits
    at each length (2e-3 after the prefill, 5e-3 a decode step)."""
    jb, jp, jbatch, tb, tp, _ = models()
    toks = np.array(jbatch["tokens"])
    S, prompt = toks.shape[1], 6

    def ref_last(upto):
        carry, ctx = jb.embed(jp, {"tokens": jnp.asarray(toks[:, :upto])})
        carry = jbase.run_segments(jb, jp, carry, ctx)
        return np.asarray(jb.head_logits(jp, carry)[:, -1])

    prefill = engine.build_prefill(tb, S + 2)
    decode = engine.build_decode(tb)
    logits, state = prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :prompt])})
    assert _maxerr(logits[:, -1].numpy(), ref_last(prompt)) < 2e-3
    for t in range(prompt, S):
        logits, state = decode(tp, state,
                               torch.from_numpy(toks[:, t: t + 1]))
        assert _maxerr(logits[:, -1].numpy(), ref_last(t + 1)) < 5e-3, t


def test_full_config_param_count():
    """Counted on the meta device, equal to the reference's
    ``count_params_analytic`` and in ``test_models_smoke.py``'s range."""
    want = jzoo.count_params_analytic(jzoo.get_config(ARCH))
    got = model_zoo.count_params(model_zoo.get_config(ARCH))
    assert got == want
    assert 25e9 < got < 36e9


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_slot_scheduler_exact_length_admission(models):
    """``make_scheduler("auto")`` picks the slot scheduler, which prefills
    one request at its exact length and gives per-request ``generate``'s
    tokens (``tests/test_scheduler.py:219``)."""
    _, _, _, tb, tp, _ = models()
    assert not engine.append_ok(tb)
    with pytest.raises(ValueError, match="ragged"):
        engine.build_prefill(tb, 16, pad_id=0)
    with pytest.raises(ValueError, match="one-shot prefill"):
        engine.build_append(tb, 16)
    V = tb.cfg.vocab_size
    rng = np.random.default_rng(7)
    reqs = [Request(rid=r, tokens=rng.integers(
        1, V, size=int(rng.integers(3, 9))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 4))) for r in range(3)]
    sched = make_scheduler(tb, tp, num_slots=2, max_len=16,
                           dtype=torch.float32, prompt_bucket=8,
                           device="cpu")
    assert type(sched) is Scheduler
    shapes = []
    prefill = sched._prefill

    def recording(params, batch):
        shapes.append(tuple(batch["tokens"].shape))
        return prefill(params, batch)

    sched._prefill = recording
    comps = {c.rid: c for c in sched.run(reqs)}
    assert shapes == [(1, len(r.tokens)) for r in reqs]
    for r in reqs:
        out, _ = engine.generate(
            tb, tp, {"tokens": torch.from_numpy(r.tokens)[None]},
            steps=r.max_new_tokens - 1, max_len=16, device="cpu")
        assert comps[r.rid].tokens == out[0].tolist(), f"rid {r.rid}"


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

QCFG_KW = dict(rank=8, min_dim=32, update_interval=2, adaptive_k=1,
               cos_threshold=0.3)
TCFG_KW = dict(seed=0, global_batch=4, seq_len=32, learning_rate=1e-2,
               warmup_steps=2, grad_clip=1.0, log_every=0)
STEPS = 4


def test_trajectory_matches_jax(monkeypatch):
    """4 Q-GaLore steps from the reference's initial state with its
    batches and SR uniforms (one draw a (layer, expert) problem): losses
    within 2e-3, SVD counts equal; the expert stacks are projected and
    updated once per (layer, expert)."""
    monkeypatch.setattr(qgalore, "SUBSPACE_HOOK", align_signs_to_jax)
    jb = jzoo.build_arch(ARCH, smoke=True, dtype=jnp.float32)
    tb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32)
    cell = JShapeCell("t", 32, 4, "train")
    jtr = JTrainer(jb, JTrainConfig(**TCFG_KW, steps=STEPS,
                                    async_checkpoint=False),
                   jopt.preset("qgalore", JQGaLoreConfig(**QCFG_KW)),
                   cell=cell, impl="fused", param_dtype=jnp.float32)
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
    assert seen and min(abs(v - QCFG_KW["cos_threshold"])
                        for v in seen) > 1e-3
    ttr = Trainer(tb, TrainConfig(**TCFG_KW, steps=STEPS),
                  optimizers.preset("qgalore", QGaLoreConfig(**QCFG_KW)),
                  cell=ShapeCell("t", 32, 4, "train"),
                  state=from_jax_state(start, device="cpu"),
                  uniforms=jax_uniforms(0), batches=jax_batches(jb, cell, 0))
    specs = {s.path: s for s in ttr.specs}
    wi = specs["['seg0_moe']['moe']['experts_wi']"]
    assert wi.galore and wi.batch == (2, 8) and wi.nbatch == 16
    assert not specs["['seg0_moe']['moe']['router']"].galore
    LAUNCHES.clear()
    thist = ttr.run()
    np.testing.assert_allclose([h["loss"] for h in thist],
                               [h["loss"] for h in jhist], rtol=2e-3,
                               atol=2e-3)
    assert ttr.controller.svd_count_summary() == \
        jtr.controller.svd_count_summary()
    assert all(np.isfinite(h["grad_norm"]) for h in thist)
    assert LAUNCHES["deq_matmul_batched"] > 0
    assert not any(LAUNCHES[k] for k in ("int8_matmul_batched",
                                         "int8_matmul_t_batched",
                                         "fused_qgalore_update"))
