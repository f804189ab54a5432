"""Multi-head Latent Attention and multi-token prediction (deepseek-v3-671b)
against the live JAX package at its smoke config (3 layers: one dense, two
MoE with a shared expert; MLA ranks 32 / 16, nope 16, rope 8, v 16; MTP
depth 1), f32: the MLA layer (full-sequence, prefill with its compressed
cache, the absorbed decode with in-place writes), the model's losses
(``ce_loss``, ``mtp_loss``, ``aux_loss``), ``fused_value_and_grad`` at
full rank and with ``mtp_block``'s leaves projected, prefill then decode,
the INT8 params' train-and-serve case, the slot scheduler, the parameter
count, the by-layer draw's expert slices, and the port's refresh and
steady Q-GaLore steps. Both packages compute on the same INT8 codes
(``from_jax_params``) and the reference's batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.core import projector as jproj
from repro.core import qgalore as jqgalore
from repro.models import attention as jattn
from repro.models import base as jbase
from repro.models import model_zoo as jzoo
from repro.models.transformer import _head_logits as j_head
from repro.train import stack as jstack
from repro.train import step as jstep
from repro_torch.config import QGaLoreConfig, TrainConfig, replace
from repro_torch.core import optimizers, qgalore
from repro_torch.kernels import LAUNCHES
from repro_torch.models import attention, base, model_zoo, moe
from repro_torch.serve import engine
from repro_torch.serve.params import from_jax_params, quantize_leaf
from repro_torch.serve.scheduler import Request, Scheduler, make_scheduler
from repro_torch.train import stack
from repro_torch.train.trainer import Trainer

from test_models_smoke import make_batch
from test_torch_serve import _to_numpy
from torch_one_thread import one_thread  # noqa: F401

ARCH = "deepseek-v3-671b"
CELL = JShapeCell("t", seq_len=12, global_batch=2, kind="train")
OP_TOL = 1e-5       # one layer at f32 on the same codes
FWD_TOL = 1e-4      # the model's logits and losses
GRAD_TOL = 5e-3     # the reference's per-leaf bar (tests/test_stack.py)


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


@pytest.fixture(scope="module")
def models():
    """Both packages' smoke bundles at f32, the reference's INT8 params
    carried across, and the reference's batch. The float weights are the
    port's draw (the reference's distributions; its eager init takes ~17 s
    on the CPU), quantized by the reference's ``prepare_params``."""
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


# ---------------------------------------------------------------------------
# the MLA layer
# ---------------------------------------------------------------------------

def _attn(models):
    """The first (dense) layer's MLA parameters in both packages."""
    jb, jp, _, _, tp, _ = models
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["seg0_dense"]["attn"])
    return jb.cfg, jl, base.layer_params(tp["seg0_dense"], 0)["attn"]


@pytest.mark.parametrize("kind", ["apply", "prefill", "decode"])
def test_mla_layer_matches(models, kind):
    """Full-sequence MLA, the prefill's compressed cache, and the absorbed
    decode at rows of length 2, Smax - 1 (the last slot) and Smax (past the
    window: nothing written), within 1e-5 of max|ref|. Decode writes the
    port's cache tensors in place."""
    cfg, jl, tl = _attn(models)
    rng = np.random.default_rng(5)
    m = cfg.mla
    if kind != "decode":
        B, S = 2, 12
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
        kw = dict(positions=jnp.asarray(pos), dtype=jnp.float32)
        tkw = dict(positions=torch.from_numpy(pos.copy()),
                   dtype=torch.float32)
        if kind == "apply":
            want = (jax.jit(lambda p, x: jattn.mla_apply(p, x, cfg, **kw))(
                jl, jnp.asarray(x)),)
            got = (attention.mla_apply(tl, torch.from_numpy(x), cfg, **tkw),)
        else:
            wo, (wc, wr) = jax.jit(lambda p, x: jattn.mla_prefill(
                p, x, cfg, **kw))(jl, jnp.asarray(x))
            go, (gc, gr) = attention.mla_prefill(tl, torch.from_numpy(x),
                                                 cfg, **tkw)
            want, got = (wo, wc, wr), (go, gc, gr)
            assert tuple(gc.shape) == (B, S, m.kv_lora_rank)
            assert tuple(gr.shape) == (B, S, m.qk_rope_head_dim)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            assert _maxerr(g.numpy(), w) < OP_TOL
        return
    B, Smax = 3, 8
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((B, Smax, m.kv_lora_rank)).astype(np.float32)
    r = rng.standard_normal((B, Smax, m.qk_rope_head_dim)).astype(np.float32)
    length = np.array([2, Smax - 1, Smax], np.int32)
    want, (wc, wr) = jax.jit(lambda p, x, c, r, n: jattn.mla_decode(
        p, x, cfg, cache=(c, r), length=n, dtype=jnp.float32))(
        jl, jnp.asarray(x), jnp.asarray(c), jnp.asarray(r),
        jnp.asarray(length))
    tc, tr = torch.from_numpy(c.copy()), torch.from_numpy(r.copy())
    got, (gc, gr) = attention.mla_decode(
        tl, torch.from_numpy(x), cfg, cache=(tc, tr),
        length=torch.from_numpy(length), dtype=torch.float32)
    assert gc is tc and gr is tr                  # written in place
    assert _maxerr(got.numpy(), want) < OP_TOL
    assert _maxerr(gc.numpy(), wc) < OP_TOL
    assert _maxerr(gr.numpy(), wr) < OP_TOL
    # the row past the window kept its cache, the others only their slot
    written = np.zeros((B, Smax), bool)
    written[0, 2] = written[1, Smax - 1] = True
    for got_c, start, want_c in ((gc, c, wc), (gr, r, wr)):
        np.testing.assert_array_equal(got_c.numpy()[~written],
                                      start[~written])
        assert not np.isclose(got_c.numpy()[written], start[written]).any()
        assert _maxerr(got_c.numpy()[written], np.asarray(want_c)[written]) \
            < OP_TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_forward(models):
    """The reference's loss, metrics and logits at every position (one
    jitted forward; drop-free routing keeps the rows apart, and attention
    is causal, so position t's logits are those of the first t + 1
    tokens), and its full-rank ``fused_value_and_grad``."""
    jb, jp, jbatch, _, _, _ = models

    def fwd(p, b):
        carry, ctx = jb.embed(p, b)
        carry = jbase.run_segments(jb, p, carry, ctx)
        loss, metrics = jb.head_loss(p, carry, b)
        return loss, metrics, j_head(p, carry["h"], jb.cfg, jnp.float32)

    loss, metrics, logits = jax.jit(fwd)(jp, jbatch)
    grads = jax.jit(lambda p, b: jstack.fused_value_and_grad(
        jb, p, b, {}))(jp, jbatch)
    return loss, metrics, np.asarray(logits), grads


def test_forward_losses_and_logits_match(models, ref_forward):
    """The loss and its parts (``ce_loss`` with 0.3 of ``mtp_loss``,
    ``aux_loss``) and the last logits against the reference's."""
    jb, jp, jbatch, tb, tp, tbatch = models
    jl, jm, logits, _ = ref_forward
    want = logits[:, -1:]
    with torch.no_grad():
        tc, tctx = tb.embed(tp, tbatch)
        tc = base.run_segments(tb, tp, tc, tctx)
        tl, tm = tb.head_loss(tp, tc, tbatch)
        got = tb.head_logits(tp, tc)
    assert float(tl) == pytest.approx(float(jl), rel=FWD_TOL)
    for k in ("ce_loss", "mtp_loss", "aux_loss"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=FWD_TOL), k
    assert float(tm["mtp_loss"]) > 0 and float(tm["aux_loss"]) > 0
    assert _maxerr(got.numpy(), want) < FWD_TOL
    assert [s.name for s in tb.segments] == ["dense", "moe"]
    assert all(s.append is None for s in tb.segments)


def _proj_trees(params, keys=("mtp_block", "mtp_proj"), rank=4):
    """P (orthonormal columns, numpy) for every 2-D leaf of ``keys`` whose
    sides are both at least 16, None elsewhere; as a tree per key."""
    rng = np.random.default_rng(3)

    def make(t):
        if isinstance(t, dict):
            return {k: make(v) for k, v in t.items()}
        shape = tuple(t.shape)
        if len(shape) != 2 or min(shape) < 16:
            return None
        d = jproj.proj_dim(shape)
        return np.linalg.qr(rng.standard_normal((d, rank)))[0] \
            .astype(np.float32)
    return {k: make(params[k]) for k in keys}


@pytest.mark.parametrize("projected", [False, True])
def test_fused_value_and_grad_matches(models, ref_forward, projected):
    """``fused_value_and_grad`` against the reference's, leaf by leaf
    (5e-3): at full rank, and with a proj tree over ``mtp_block``'s leaves
    and ``mtp_proj``, non-segment entries the port projects after the
    head's backward (a subtree, leaf by leaf), against the reference's
    projector on its full-rank gradient (``tests/test_stack.py``)."""
    _, _, _, tb, tp, tbatch = models
    (jl, jm), jg = ref_forward[3]
    P = _proj_trees(tp) if projected else {}
    tP = {k: jax.tree_util.tree_map(torch.from_numpy, v)
          for k, v in P.items()}
    (tl, tm), tg = stack.fused_value_and_grad(tb, tp, tbatch, tP)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(tm["mtp_loss"]) == pytest.approx(float(jm["mtp_loss"]),
                                                  rel=1e-5)
    flat = qgalore.flatten(tg)
    Ps = dict(qgalore.flatten(P))
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(flat) == len(leaves)
    n_proj = 0
    for (keys, g), want in zip(flat, leaves):
        if Ps.get(keys) is not None:
            want = jproj.project(want, jnp.asarray(Ps[keys]),
                                 jproj.galore_side(want.shape))
            n_proj += 1
        assert torch.isfinite(g).all(), keys
        assert tuple(g.shape) == tuple(want.shape), keys
        assert _maxerr(g.numpy(), want) <= GRAD_TOL, keys
    # wq_a, wq_b, wkv_a, wkv_b, wo, the FFN's three, mtp_proj
    assert n_proj == (9 if projected else 0)


def test_prefill_then_decode_matches_full_forward(models, ref_forward):
    """The port's prefill of 6 tokens (its cache grown to the window along
    time, not batch), then teacher-forced absorbed decode, against the
    reference's full-sequence logits at each length (2e-3 after the
    prefill, 5e-3 a decode step)."""
    _, _, jbatch, tb, tp, _ = models
    toks = np.array(jbatch["tokens"])
    B, S = toks.shape
    prompt = 6

    def ref_last(upto):
        return ref_forward[2][:, upto - 1]

    prefill = engine.build_prefill(tb, S + 2)
    decode = engine.build_decode(tb)
    logits, state = prefill(tp, {"tokens": torch.from_numpy(
        toks[:, :prompt])})
    m = tb.cfg.mla
    for key, seg in zip(state.caches, tb.segments):
        c, r = state.caches[key]
        assert tuple(c.shape) == (seg.n_layers, B, S + 2, m.kv_lora_rank)
        assert tuple(r.shape) == (seg.n_layers, B, S + 2,
                                  m.qk_rope_head_dim)
        assert c[:, :, :prompt].abs().amax() > 0
        assert not c[:, :, prompt:].any() and not r[:, :, prompt:].any()
    assert _maxerr(logits[:, -1].numpy(), ref_last(prompt)) < 2e-3
    for t in range(prompt, S):
        logits, state = decode(tp, state,
                               torch.from_numpy(toks[:, t: t + 1]))
        assert _maxerr(logits[:, -1].numpy(), ref_last(t + 1)) < 5e-3, t


def test_quantized_params_train_and_serve(models):
    """``tests/test_quantized_dense.py``'s families case for deepseek: the
    INT8 params' loss and gradients are finite, and prefill and one decode
    step give finite logits; every matmul takes the INT8 op's plain
    version, ``wkv_b`` materialized once a decode layer."""
    _, _, _, tb, tp, tbatch = models
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
    # a decode streams wq_a, wq_b, wo and the FFN's three a dense layer,
    # the attention's three and the shared expert's three an MoE layer,
    # and the head (the smoke widths leave wkv_a (64, 24) and the router
    # (64, 8) float; wkv_b is materialized); the experts one batched call
    # a stack
    assert dict(LAUNCHES) == {"deq_matmul": 6 + 2 * 6 + 1,
                              "deq_matmul_batched": 2 * 3}


def test_slot_scheduler_serves(models):
    """``make_scheduler("auto")`` picks the slot scheduler (no append on
    MLA or MoE segments) and gives per-request ``generate``'s tokens."""
    _, _, _, tb, tp, _ = models
    assert not engine.append_ok(tb)
    rng = np.random.default_rng(8)
    reqs = [Request(rid=r, tokens=rng.integers(
        1, tb.cfg.vocab_size, size=int(rng.integers(3, 9))).astype(np.int32),
        max_new_tokens=2) for r in range(3)]
    sched = make_scheduler(tb, tp, num_slots=2, max_len=16,
                           dtype=torch.float32, device="cpu")
    assert type(sched) is Scheduler
    comps = {c.rid: c for c in sched.run(reqs)}
    for r in reqs:
        out, _ = engine.generate(
            tb, tp, {"tokens": torch.from_numpy(r.tokens)[None]},
            steps=r.max_new_tokens - 1, max_len=16, device="cpu")
        assert comps[r.rid].tokens == out[0].tolist(), f"rid {r.rid}"


def test_full_config_param_count():
    """Counted on the meta device, the MTP block included: equal to the
    reference's ``count_params_analytic`` and in ``test_models_smoke.py``'s
    range."""
    cfg = model_zoo.get_config(ARCH)
    got = model_zoo.count_params(cfg)
    assert got == jzoo.count_params_analytic(jzoo.get_config(ARCH))
    assert 550e9 < got < 750e9


def test_flash_and_mtp_depth_refusals():
    """``flash_attention=True`` on MLA is refused at build naming the
    query and key width (nope + rope = 192, the flash kernel takes 128);
    ``mtp_depth`` 2 is refused by name (the reference builds one block)."""
    cfg = model_zoo.get_config(ARCH)
    with pytest.raises(NotImplementedError, match="width .* is 192"):
        model_zoo.build(cfg, device="meta", flash_attention=True)
    model_zoo.build(cfg, device="meta")
    with pytest.raises(NotImplementedError, match="mtp_depth 2"):
        model_zoo.build(replace(cfg, mtp_depth=2), device="meta")


def test_by_layer_draw_slices_the_experts(monkeypatch):
    """A by-layer draw takes each expert stack a slice of experts at a time
    (3 of 8 here: uneven slices): mapped slice by slice, it gives the
    codes and scales of the whole stack quantized, and the tree of the
    default draw's shapes."""
    monkeypatch.setattr(moe, "EXPERT_SLICE", 3)
    tb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32)
    seen = []

    def record(keys, t):
        seen.append((keys, tuple(t.shape)))
        return t

    flt = tb.init_params(torch.Generator().manual_seed(4), leaf_fn=record,
                         by_layer=True)
    q = tb.init_params(torch.Generator().manual_seed(4),
                       leaf_fn=lambda _, t: quantize_leaf(t), by_layer=True)
    whole = tb.init_params(torch.Generator().manual_seed(4))
    wi = ("seg1_moe", "moe", "experts_wi")
    assert [s for k, s in seen if k == wi] == [(3, 64, 32), (3, 64, 32),
                                               (2, 64, 32)] * 2
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


def test_keys_and_specs_match_reference(models):
    """The nested non-segment entry ``mtp_block`` keeps the reference's key
    strings (checkpoints) and GaLore decisions (``leaf_specs``)."""
    _, jp, _, _, tp, _ = models
    qcfg = dict(rank=4, min_dim=16)
    tspecs = qgalore.leaf_specs(tp, QGaLoreConfig(**qcfg))
    jspecs = jqgalore.leaf_specs(jp, JQGaLoreConfig(**qcfg))
    got = [(s.path, s.galore, s.side) for s in tspecs]
    want = [(s.path, s.galore, s.side) for s in jspecs]
    assert got == want
    assert ("['mtp_block']['attn']['wq_a']", True, "right") in got


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def test_refresh_then_steady_step_projects_mtp(monkeypatch):
    """Two Q-GaLore steps of the port's ``Trainer``: a refresh, then a
    steady step whose ``mtp_block`` gradient is projected as a subtree
    (the first non-segment entry that holds a tree); finite losses and
    ``mtp_loss``. (A live reference run of the two steps compiles for
    ~2 min on the CPU; the projection is held against the reference's in
    ``test_fused_value_and_grad_matches``.)"""
    tb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32)
    projected = []
    project = stack._project_tree

    def recording(g, P):
        projected.append(sorted(g) if isinstance(g, dict) else None)
        return project(g, P)

    monkeypatch.setattr(stack, "_project_tree", recording)
    tr = Trainer(tb, TrainConfig(seed=0, global_batch=2, seq_len=16,
                                 steps=2, learning_rate=1e-2, warmup_steps=1,
                                 log_every=0),
                 optimizers.preset("qgalore", QGaLoreConfig(
                     rank=8, min_dim=64, update_interval=2)))
    specs = {s.path: s for s in tr.specs}
    assert specs["['mtp_block']['ffn']['wd']"].galore
    assert specs["['mtp_proj']"].galore
    before = tr.state.params["mtp_block"]["ffn"]["wd"].q.clone()
    hist = tr.run()
    assert len(hist) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["mtp_loss"])
               for h in hist)
    # step 0 refreshes (no projection); step 1 projects the subtree
    assert ["attn", "attn_norm", "ffn", "ffn_norm"] in projected
    assert not torch.equal(before,
                           tr.state.params["mtp_block"]["ffn"]["wd"].q)
