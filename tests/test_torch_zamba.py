"""The SSM hybrid (zamba2-2.7b) against the live JAX package at its smoke
config (6 layers: 2 superblocks of 2 Mamba2 blocks and a site of the
shared block, d 64, 4 heads, SSM state 16 and head 16, chunk 16, LoRA
rank 8), f32: the chunked SSD (padded, from an initial state) against the
reference's and the sequential oracle, a Mamba2 block's short-prompt
cache and decode step, the model's loss, the fused per-layer gradient
against the reference's ``jax.grad`` (the shared block's gradient summed
over its sites, the embedding's over the ``h`` and ``x0`` paths), prefill
then decode against the full forward, the INT8 params' train-and-serve
case, the pool (the SSM state float32 whatever the pool's dtype, every
leaf written in place), the flash route, the slot scheduler, the
refusals, the parameter count and the GaLore leaf specs. Both packages
compute on the same INT8 codes (``from_jax_params``) and the reference's
batch; the reference's forward and gradient are each jitted once."""
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
from repro.models import ssm as jssm
from repro.train import stack as jstack
from repro.train import step as jstep
from repro_torch.config import QGaLoreConfig, TrainConfig, replace
from repro_torch.core import optimizers, projector, qgalore, quant
from repro_torch.kernels import LAUNCHES
from repro_torch.models import base, model_zoo, ssm
from repro_torch.serve import engine
from repro_torch.serve.paged import PagedScheduler
from repro_torch.serve.params import from_jax_params, quantize_leaf
from repro_torch.serve.scheduler import Request, Scheduler, init_pool, \
    insert_requests, make_scheduler
from repro_torch.train import stack
from repro_torch.train.trainer import Trainer

from test_models_smoke import make_batch
from test_torch_serve import _to_numpy
from torch_one_thread import one_thread  # noqa: F401

ARCH = "zamba2-2.7b"
# 20 tokens: two SSD chunks of 16, the second padded by 12
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
    jitted forward; the model is causal, so position t's logits are those
    of the first t + 1 tokens), and its ``jax.grad`` (one jit)."""
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
# the SSD core and one Mamba2 block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked_matches_reference(initial):
    """``ssd_chunked`` at S 21 and chunk 8 (three chunks, the last padded
    by 3), from zeros or a given state: y and the final state against the
    reference's chunked form and against the sequential oracle (the
    padded identity steps leave the state as the unpadded run's), within
    1e-5 of max|ref|."""
    rng = np.random.default_rng(21)
    b, S, h, p, n = 2, 21, 3, 4, 5
    x = rng.standard_normal((b, S, h, p)).astype(np.float32)
    A = -np.abs(rng.standard_normal((b, S, h))).astype(np.float32) * 0.5
    B = rng.standard_normal((b, S, n)).astype(np.float32)
    C = rng.standard_normal((b, S, n)).astype(np.float32)
    init = rng.standard_normal((b, h, p, n)).astype(np.float32) \
        if initial else None
    jargs = [jnp.asarray(a) for a in (x, A, B, C)]
    targs = [torch.from_numpy(a) for a in (x, A, B, C)]
    jinit = None if init is None else jnp.asarray(init)
    tinit = None if init is None else torch.from_numpy(init)
    want_y, want_st = jax.jit(lambda *a: jssm.ssd_chunked(
        *a, chunk=8, initial_state=jinit))(*jargs)
    got_y, got_st = ssm.ssd_chunked(*targs, chunk=8, initial_state=tinit)
    oracle_y, oracle_st = ssm.ssd_reference(*targs, initial_state=tinit)
    assert tuple(got_y.shape) == tuple(want_y.shape) == (b, S, h, p)
    assert _maxerr(got_y.numpy(), want_y) < OP_TOL
    assert _maxerr(got_st.numpy(), want_st) < OP_TOL
    assert _maxerr(got_y.numpy(), oracle_y.numpy()) < OP_TOL
    assert _maxerr(got_st.numpy(), oracle_st.numpy()) < OP_TOL


def test_mamba2_short_prompt_cache_and_decode():
    """``mamba2_apply(return_cache=True)`` on a 2-token prompt (the conv
    window left-padded to K - 1 = 3 rows) and then two ``mamba2_decode``
    steps, which write the window and the state into the tensors handed
    over, against the reference's (1e-5); the window holds the pre-conv
    inputs."""
    jcfg = jzoo.get_config(ARCH, smoke=True)
    cfg = model_zoo.get_config(ARCH, smoke=True)
    jp = jax.jit(lambda k: jssm.mamba2_init(k, jcfg))(jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    japply = jax.jit(lambda p, u: jssm.mamba2_apply(
        p, u, jcfg, dtype=jnp.float32, return_cache=True))
    jdecode = jax.jit(lambda p, u, c: jssm.mamba2_decode(
        p, u, jcfg, cache=c, dtype=jnp.float32))
    jout, jc = japply(jp, jnp.asarray(x[:, :2]))
    out, cache = ssm.mamba2_apply(tp, torch.from_numpy(x[:, :2]), cfg,
                                  dtype=torch.float32, return_cache=True)
    assert _maxerr(out.numpy(), jout) < OP_TOL
    assert tuple(cache.conv.shape) == (2, 3, 160)
    assert not cache.conv[:, 0].any()
    assert _maxerr(cache.conv.numpy(), jc.conv) < OP_TOL
    assert _maxerr(cache.ssm.numpy(), jc.ssm) < OP_TOL
    conv, state = cache.conv.clone(), cache.ssm.clone()
    for t in (2, 3):
        jout, jc = jdecode(jp, jnp.asarray(x[:, t: t + 1]), jc)
        out, got = ssm.mamba2_decode(
            tp, torch.from_numpy(x[:, t: t + 1]), cfg,
            cache=ssm.Mamba2Cache(conv, state), dtype=torch.float32)
        assert got.conv is conv and got.ssm is state
        assert _maxerr(out.numpy(), jout) < OP_TOL, t
        assert _maxerr(conv.numpy(), jc.conv) < OP_TOL, t
        assert _maxerr(state.numpy(), jc.ssm) < OP_TOL, t


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
    assert [s.name for s in tb.segments] == ["zamba"]
    assert tb.segments[0].n_layers == 2


def test_fused_grad_matches_jax_grad(models, ref_forward):
    """``test_stack.py::test_fused_matches_simple_fullrank`` and the
    gradient half of ``test_models_smoke.py``: the port's per-layer
    recompute backward (a superblock a layer) against the reference's
    ``jax.grad``, every leaf within 5e-3 of max|ref|: the shared block's
    leaves (summed over both sites through ``ctx``, nonzero) and the
    embedding (the ``h`` and ``x0`` paths) among them."""
    _, _, _, tb, tp, tbatch = models
    (jl, _), jg = ref_forward[3]
    (tl, _), tg = stack.fused_value_and_grad(tb, tp, tbatch, {})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    flat = qgalore.flatten(tg)
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(flat) == len(leaves) == 27
    for (keys, g), want in zip(flat, leaves):
        assert torch.isfinite(g).all(), keys
        assert tuple(g.shape) == tuple(want.shape), keys
        assert _maxerr(g.numpy(), want) <= GRAD_TOL, keys
    shared = [(k, g) for k, g in flat if k[0] == "shared_attn"]
    assert len(shared) == 10
    assert all(float(g.abs().max()) > 0 for _, g in shared)
    assert float(tg["embedding"].abs().max()) > 0


def test_shared_gradient_projected_once(models):
    """With a P for each shared matrix (``proj_trees["shared_attn"]``),
    the fused backward emits the projection of the summed full-rank
    gradient (``project_leaf`` of the proj-free run's, 1e-5), the vectors
    full-rank; and with ``acc`` a second microbatch adds into the first
    tree in place."""
    _, _, _, tb, tp, tbatch = models
    (_, _), full = stack.fused_value_and_grad(tb, tp, tbatch, {})
    gen = torch.Generator().manual_seed(5)

    def make_P(g):
        if g.ndim < 2:
            return None
        rows = projector.proj_dim(tuple(g.shape))
        return torch.linalg.qr(torch.randn((rows, 4), generator=gen))[0]

    P = {k: make_P(v) if torch.is_tensor(v) else
         {kk: make_P(vv) for kk, vv in v.items()}
         for k, v in full["shared_attn"].items()}
    (_, _), low = stack.fused_value_and_grad(tb, tp, tbatch,
                                             {"shared_attn": P})
    want = stack._project_tree(full["shared_attn"], P)
    for (keys, g), (_, w) in zip(qgalore.flatten(low["shared_attn"]),
                                 qgalore.flatten(want)):
        assert tuple(g.shape) == tuple(w.shape), keys
        assert _maxerr(g.numpy(), w.numpy()) < OP_TOL, keys
    assert tuple(low["shared_attn"]["attn"]["wq"].shape) == (64, 4)
    acc = {k: qgalore.unflatten(*zip(*[(ks, g.clone()) for ks, g in
                                       qgalore.flatten(v)]))
           if isinstance(v, dict) else v.clone() for k, v in low.items()}
    (_, _), twice = stack.fused_value_and_grad(
        tb, tp, tbatch, {"shared_attn": P}, acc=acc)
    assert twice["shared_attn"]["fuse"] is acc["shared_attn"]["fuse"]
    assert _maxerr(twice["shared_attn"]["fuse"].numpy(),
                   2 * low["shared_attn"]["fuse"].numpy()) < OP_TOL


def test_trainer_steps_on_the_hybrid_tree():
    """``Trainer`` on the hybrid's tree (4-D Mamba2 stacks, the shared
    subtree, quantized vectors) through refreshes, steady fused updates,
    ``accum`` 2 and adaptive rank: finite losses, every shared matrix's
    weights moved by its own subspace, and the LoRA ``B`` (all zero at
    init, its block scales clamped) moved off zero."""
    tb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32)
    qcfg = optimizers.preset("qgalore", QGaLoreConfig(
        rank=8, min_dim=32, update_interval=2, adaptive_rank=True,
        rank_patience=1, min_rank=4))
    tr = Trainer(tb, TrainConfig(global_batch=4, seq_len=20, steps=4),
                 qcfg, accum=2)
    before = qgalore.flatten(tr.state.params)
    hist = tr.run()
    assert len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
    after = dict(qgalore.flatten(tr.state.params))
    moved = {k for k, w in before if not torch.equal(
        quant.dequantize(w) if hasattr(w, "q") else w,
        quant.dequantize(after[k]) if hasattr(after[k], "q") else after[k])}
    assert {k for k, _ in before if k[0] == "shared_attn" and
            (k[-1].startswith("w") or k[-1] == "fuse")} <= moved
    assert ("seg0_zamba", "lora_q", "B") in moved
    assert after[("seg0_zamba", "lora_q", "B")].q.any()


def test_ctx_gradient_only_where_ctx_is_differentiable(models):
    """The ctx gradient leaves other models alone: llama-60m's and
    xlstm-125m's ctx holds no differentiable leaf, so their per-layer
    backward differentiates what it did before (their gradient tests in
    ``test_torch_train.py`` and ``test_torch_xlstm.py`` hold it against
    the reference); zamba's ctx holds the shared block's ten leaves, the
    same tensors as the non-segment leaves the embedding's backward
    reaches."""
    for arch in ("llama-60m", "xlstm-125m"):
        b = model_zoo.build_arch(arch, smoke=True, device="cpu",
                                 dtype=torch.float32)
        p = b.init_params(torch.Generator().manual_seed(0))
        seg_keys = {b.seg_key(i) for i in range(len(b.segments))}
        ns = stack._virt({k: v for k, v in p.items() if k not in seg_keys})
        toks = torch.ones((1, 4), dtype=torch.int32)
        _, ctx = b.embed({**p, **ns}, {"tokens": toks})
        assert stack._ctx_diff(ctx) == [], arch
    _, _, _, tb, tp, tbatch = models
    ns = stack._virt({k: v for k, v in tp.items() if k != "seg0_zamba"})
    _, ctx = tb.embed({**tp, **ns}, tbatch)
    got = stack._ctx_diff(ctx)
    want = stack._diff(ns["shared_attn"])
    assert len(got) == len(want) == 10
    assert all(a is b for a, b in zip(got, want))


def test_prefill_then_decode_matches_full_forward(models, ref_forward):
    """``test_serve.py::test_decode_matches_full_forward``: a prefill of 8
    tokens (only K and V grown to the window), then teacher-forced decode
    to 20 tokens, against the reference's full-sequence logits at each
    length (2e-3 after the prefill, 5e-3 a step)."""
    _, _, jbatch, tb, tp, _ = models
    toks = np.array(jbatch["tokens"])
    B, S = toks.shape
    prompt, window = 8, S + 4
    logits, state = engine.build_prefill(tb, window)(
        tp, {"tokens": torch.from_numpy(toks[:, :prompt])})
    shapes = tb.segments[0].cache_shapes(B, window)
    got = state.caches["seg0_zamba"]
    assert [tuple(c.shape) for c in got] == [(2,) + s for s, _ in shapes]
    assert [tuple(c.shape[2:4]) for c in got] == [(2, 3), (2, 8),
                                                  (window, 4), (window, 4)]
    assert got[1].dtype == torch.float32
    assert _maxerr(logits[:, -1].numpy(), ref_forward[2][:, prompt - 1]) \
        < 2e-3
    decode = engine.build_decode(tb)
    for t in range(prompt, S):
        logits, state = decode(tp, state, torch.from_numpy(toks[:, t: t + 1]))
        assert _maxerr(logits[:, -1].numpy(), ref_forward[2][:, t]) < 5e-3, t


def test_quantized_params_train_and_serve(models):
    """``tests/test_quantized_dense.py``'s families case for the hybrid:
    the INT8 params (the stacked conv, norms and LoRA ``B``, all zero, so
    its block scales clamp; ``A_log``, ``D``, ``dt_bias`` and LoRA ``A``
    at 8 wide float) train and serve with finite numbers, every matmul
    through the INT8 op."""
    _, _, _, tb, tp, tbatch = models
    sb = tp["seg0_zamba"]
    for leaf in (sb["mamba"]["conv_w"], sb["mamba"]["conv_b"],
                 sb["mamba"]["ssm_norm"], sb["mamba_norms"],
                 sb["lora_q"]["B"]):
        assert type(leaf).__name__ == "QTensor"
    assert not sb["lora_q"]["B"].q.any()
    for leaf in (sb["mamba"]["A_log"], sb["lora_o"]["A"]):
        assert isinstance(leaf, torch.Tensor)
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
    # a superblock streams in_proj and out_proj of each Mamba2 block, and
    # the site fuse, wq, wk, wv, wo, the two LoRA B (A is 8 wide), the
    # FFN's three and site_out; then the head
    assert dict(LAUNCHES) == {"deq_matmul": 2 * (2 * 2 + 11) + 1}


def test_pool_dtypes_and_decode_writes_in_place(models):
    """A bf16 slot pool holds the SSM state in float32 and the conv
    window, K and V in bf16; a prefill's rows go in as they are; two
    decode steps write all four of the pool's own tensors."""
    _, _, jbatch, tb, tp, _ = models
    bf = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.bfloat16)
    leaves = init_pool(bf, 3, 16, torch.bfloat16, "cpu") \
        .caches["seg0_zamba"]
    assert [c.dtype for c in leaves] == [torch.bfloat16, torch.float32,
                                         torch.bfloat16, torch.bfloat16]
    assert [tuple(c.shape) for c in leaves] == [
        (2, 3, 2, 3, 160), (2, 3, 2, 8, 16, 16), (2, 3, 16, 4, 16),
        (2, 3, 16, 4, 16)]

    toks = torch.from_numpy(np.array(jbatch["tokens"]))
    pool = init_pool(tb, 3, 16, torch.float32, "cpu")
    _, rows = engine.build_prefill(tb, 16)(tp, {"tokens": toks[:, :6]})
    insert_requests(pool, [2, 0], rows)
    for p, r in zip(pool.caches["seg0_zamba"], rows.caches["seg0_zamba"]):
        assert torch.equal(p[:, [2, 0]], r)
        assert not p[:, 1].any()
    decode = engine.build_decode(tb)
    ids = [id(c) for c in pool.caches["seg0_zamba"]]
    before = [c.clone() for c in pool.caches["seg0_zamba"]]
    tok = torch.zeros((3, 1), dtype=torch.int32)
    tok[2], tok[0] = toks[0, 6], toks[1, 6]
    for step in range(2):
        _, pool = decode(tp, pool, tok)
        now = pool.caches["seg0_zamba"]
        assert [id(c) for c in now] == ids
        assert all(not torch.equal(a[:, [2, 0]], b[:, [2, 0]])
                   for a, b in zip(now, before)), step
        # K and V gain exactly the row at the length
        for kv, old in zip(now[2:], before[2:]):
            diff = (kv[:, [2, 0]] != old[:, [2, 0]]).any(-1).any(-1)
            assert diff.nonzero()[:, 2].unique().tolist() == [6 + step]
        before = [c.clone() for c in now]


def test_flash_route_matches_einsum(models):
    """``flash_attention=True`` routes each site's prefill attention
    through ``kops.flash_attention`` (one call a superblock, the plain
    version on the CPU), at the einsum route's logits and cache (1e-5);
    decode never takes it."""
    _, _, _, tb, tp, tbatch = models
    fb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32, flash_attention=True)
    toks = tbatch["tokens"][:, :12]
    want, wstate = engine.build_prefill(tb, 16)(tp, {"tokens": toks})
    LAUNCHES.clear()
    got, gstate = engine.build_prefill(fb, 16)(tp, {"tokens": toks})
    assert LAUNCHES["flash_attention_ref"] == 2
    assert _maxerr(got.numpy(), want.numpy()) < OP_TOL
    for g, w in zip(gstate.caches["seg0_zamba"],
                    wstate.caches["seg0_zamba"]):
        assert _maxerr(g.numpy(), w.numpy()) < OP_TOL
    LAUNCHES.clear()
    engine.build_decode(fb)(tp, gstate, toks[:, -1:])
    assert LAUNCHES["flash_attention_ref"] == 0


def test_refusals_by_name(models):
    """``build_prefill(pad_id=...)``, chunk-append, the paged scheduler and
    ``split_layers`` (the reference's message) are refused by name, so is
    a hybrid config without ``cfg.ssm`` or ``cfg.hybrid``, and a family
    ``ssm`` raises the reference's ``ValueError``; ``make_scheduler
    ("auto")`` gives the slot scheduler."""
    _, _, _, tb, tp, _ = models
    assert not tb.ragged_prefill_ok
    with pytest.raises(ValueError, match="ragged_prefill_ok"):
        engine.build_prefill(tb, max_len=16, pad_id=0)
    assert not engine.append_ok(tb)
    with pytest.raises(ValueError, match="chunk-append"):
        engine.build_append(tb, 32)
    with pytest.raises(ValueError, match="paged serving"):
        PagedScheduler(tb, None, num_slots=2, max_len=32, device="cpu")
    sched = make_scheduler(tb, tp, backend="auto", num_slots=2, max_len=32,
                           dtype=torch.float32, device="cpu")
    assert type(sched) is Scheduler
    cfg = model_zoo.get_config(ARCH, smoke=True)
    with pytest.raises(ValueError,
                       match="split_layers unsupported for family hybrid"):
        model_zoo.build(cfg, device="cpu", split_layers=1)
    with pytest.raises(ValueError, match="unknown family ssm"):
        model_zoo.build(replace(cfg, family="ssm"), device="cpu")
    for cut in ({"ssm": None}, {"hybrid": None}):
        with pytest.raises(ValueError, match="needs cfg.ssm and cfg.hybrid"):
            model_zoo.build(replace(cfg, **cut), device="cpu")


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


def test_param_count_and_by_layer_draw():
    """``test_models_smoke.py``'s counts: the smoke model's is positive,
    and the full config's, drawn on the meta device, equals the
    reference's ``count_params_analytic`` and lies in 2.0-3.4 G. A
    by-layer draw gives the default draw's tree, each superblock mapped as
    the whole stack would be."""
    cfg = model_zoo.get_config(ARCH)
    got = model_zoo.count_params(cfg)
    assert got == jzoo.count_params_analytic(jzoo.get_config(ARCH))
    assert 2.0e9 <= got <= 3.4e9
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
    """The GaLore decisions on the hybrid's tree (4-D Mamba2 stacks, the
    non-segment ``shared_attn`` subtree, quantized vectors) are the
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
    assert "['seg0_zamba']['mamba']['in_proj']" in proj
    assert "['shared_attn']['attn']['wq']" in proj
    assert "['shared_attn']['fuse']" in proj
    assert "['seg0_zamba']['lora_q']['A']" not in proj
