"""The encoder-decoder (seamless-m4t-medium) against the live JAX package
at its smoke config (2 + 2 layers, d 64, 4 heads, d_ff 128, vocab 512),
f32: cross-attention alone, the model's loss and logits, the fused
per-layer gradient against the reference's ``jax.grad`` (through the
bridge: ``frame_norm`` and ``enc_final_norm`` reached only through the
encoder), prefill then decode against the full forward, the INT8 params'
train-and-serve case, the flash route, the refusals, a ``Trainer`` run
on ``batch_for_bundle``'s frames, the bundles' input specs against the
reference's, the parameter count, the GaLore leaf
specs, and sampling on the reference's Gumbel draws. Both packages
compute on the same INT8 codes (``from_jax_params``) and the reference's
frames and tokens; its forward and gradient are each jitted once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.core import qgalore as jqgalore
from repro.models import attention as jattention
from repro.models import base as jbase
from repro.models import layers as jlayers
from repro.models import model_zoo as jzoo
from repro.serve import engine as jengine
from repro.train import stack as jstack
from repro.train import step as jstep
from repro_torch.config import QGaLoreConfig, ShapeCell, TrainConfig
from repro_torch.core import optimizers, qgalore
from repro_torch.data.synthetic import batch_for_bundle
from repro_torch.kernels import LAUNCHES
from repro_torch.models import attention, base, encdec, model_zoo
from repro_torch.serve import engine
from repro_torch.serve.paged import PagedScheduler
from repro_torch.serve.params import from_jax_params, quantize_leaf
from repro_torch.serve.scheduler import Scheduler, make_scheduler
from repro_torch.train import stack
from repro_torch.train.trainer import Trainer

from test_models_smoke import make_batch
from test_torch_serve import _to_numpy
from torch_one_thread import one_thread  # noqa: F401

ARCH = "seamless-m4t-medium"
# 32 frames; the decoder takes max(32 // 4, 16) = 16 tokens
CELL = JShapeCell("t", seq_len=32, global_batch=2, kind="train")
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
    and the reference's batch (bf16 frames, exact in f32)."""
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
    tbatch = {k: torch.from_numpy(np.array(v.astype(jnp.float32)
                                             if k == "frames" else v))
              for k, v in jbatch.items()}
    return jb, jp, jbatch, tb, tp, tbatch


@pytest.fixture(scope="module")
def ref_forward(models):
    """The reference's loss, metrics and logits at every decoder position
    (one jitted forward; the decoder is causal and the memory fixed, so
    position t's logits are those of the first t + 1 tokens), and its
    ``jax.grad`` (one jit)."""
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


def test_cross_apply_matches_reference():
    """``attention.cross_apply`` alone: q from x, k and v from a memory of
    another length, no mask and no RoPE, within 1e-5 of the reference's,
    at a prefill's width and at a decode step's (one query against the
    whole memory: ``_attend_dense`` non-causal at Sq != Skv)."""
    jcfg = jzoo.get_config(ARCH, smoke=True)
    cfg = model_zoo.get_config(ARCH, smoke=True)
    jp = jax.jit(lambda k: jattention.gqa_init(k, jcfg))(
        jax.random.PRNGKey(3))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(23)
    mem = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    fn = jax.jit(lambda p, x, m: jattention.cross_apply(
        p, x, m, jcfg, dtype=jnp.float32))
    for S in (5, 1):
        x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
        want = fn(jp, jnp.asarray(x), jnp.asarray(mem))
        got = attention.cross_apply(tp, torch.from_numpy(x),
                                    torch.from_numpy(mem), cfg,
                                    dtype=torch.float32)
        assert tuple(got.shape) == (2, S, cfg.d_model)
        assert _maxerr(got.numpy(), want) < OP_TOL, S


def test_forward_loss_matches(models, ref_forward):
    """``test_models_smoke.py::test_forward_loss``: the loss at random init
    near log(vocab) and equal to the reference's (1e-4), as are the last
    logits; two segments, the encoder apply-only and the decoder's ``pre``
    the bridge."""
    _, _, _, tb, tp, tbatch = models
    jl, _, logits, _ = ref_forward
    with torch.no_grad():
        loss, metrics = base.loss_fn(tb, tp, tbatch)
        c, ctx = tb.embed(tp, tbatch)
        got = tb.head_logits(tp, base.run_segments(tb, tp, c, ctx))
    expect = np.log(tb.cfg.vocab_size)
    assert 0.2 * expect < float(loss) < 3.0 * expect + 1.0
    assert float(loss) == pytest.approx(float(jl), rel=FWD_TOL)
    assert float(metrics["ce_loss"]) == float(loss)
    assert _maxerr(got.numpy(), logits[:, -1:]) < FWD_TOL
    enc, dec = tb.segments
    assert [s.name for s in tb.segments] == ["encoder", "decoder"]
    assert (enc.n_layers, dec.n_layers) == (2, 2)
    assert enc.prefill is enc.decode is enc.cache_shapes is enc.pre is None
    assert dec.pre is not None and dec.decode is not None
    assert tb.decode_extras == ("memory",) and not engine.append_ok(tb)


def test_fused_grad_matches_jax_grad(models, ref_forward):
    """``test_stack.py::test_fused_matches_simple_fullrank`` and the
    gradient half of ``test_models_smoke.py``: the port's per-layer
    recompute backward, through the bridge (its gradient taken after the
    decoder's layers; ``h`` and ``dec_h`` one tensor after it, ``memory``
    gathering every cross-attention's ``wk``/``wv`` cotangent), against
    the reference's ``jax.grad``: every leaf within 5e-3 of max|ref|,
    ``frame_norm`` and ``enc_final_norm`` nonzero."""
    _, _, _, tb, tp, tbatch = models
    (jl, _), jg = ref_forward[3]
    (tl, _), tg = stack.fused_value_and_grad(tb, tp, tbatch, {})
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    flat = qgalore.flatten(tg)
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(flat) == len(leaves) == 28
    for (keys, g), want in zip(flat, leaves):
        assert torch.isfinite(g).all(), keys
        assert tuple(g.shape) == tuple(want.shape), keys
        assert _maxerr(g.numpy(), want) <= GRAD_TOL, keys
    for k in ("frame_norm", "enc_final_norm", "embedding"):
        assert float(tg[k].abs().max()) > 0, k


def test_prefill_then_decode_matches_full_forward(models, ref_forward):
    """``test_serve.py::test_decode_matches_full_forward``: a prefill of 8
    decoder tokens on the 32 frames (the encoder run by ``apply``, no
    cache of its own, ``memory`` kept in ``extras``), then teacher-forced
    decode to 16 tokens, each step embedded through ``embed_decode``
    (tokens only: ``embed`` would need the frames), against the
    reference's full-sequence logits at each length (2e-3 after the
    prefill, 5e-3 a step)."""
    _, _, _, tb, tp, tbatch = models
    toks = tbatch["tokens"]
    B, S = toks.shape
    prompt, window = 8, S + 4
    logits, state = engine.build_prefill(tb, window)(
        tp, {"frames": tbatch["frames"], "tokens": toks[:, :prompt]})
    assert list(state.caches) == ["seg1_decoder"]
    assert [tuple(c.shape) for c in state.caches["seg1_decoder"]] == \
        [(2, B, window, 4, 16)] * 2
    assert list(state.extras) == ["memory"]
    assert tuple(state.extras["memory"].shape) == (B, 32, 64)
    assert _maxerr(logits[:, -1].numpy(), ref_forward[2][:, prompt - 1]) \
        < 2e-3
    decode = engine.build_decode(tb)
    for t in range(prompt, S):
        logits, state = decode(tp, state, toks[:, t: t + 1])
        assert list(state.extras) == ["memory"]
        assert _maxerr(logits[:, -1].numpy(), ref_forward[2][:, t]) < 5e-3, t


def test_quantized_params_train_and_serve(models):
    """``tests/test_quantized_dense.py``'s families case for the
    encoder-decoder: the INT8 params train and serve with finite numbers,
    every matmul through the INT8 op: a prefill streams 7 a encoder
    layer, 11 a decoder layer (self q, k, v, o; cross q, k, v, o; the
    FFN's three) and the head; a decode step the decoder's and the head,
    no encoder. ``generate`` carries ``extras`` through its EOS path."""
    _, _, _, tb, tp, tbatch = models
    (loss, _), grads = stack.fused_value_and_grad(tb, tp, tbatch, {})
    assert np.isfinite(float(loss))
    assert all(torch.isfinite(g).all() for _, g in qgalore.flatten(grads))
    toks = tbatch["tokens"]
    batch = {"frames": tbatch["frames"], "tokens": toks[:, :8]}
    LAUNCHES.clear()
    logits, state = engine.build_prefill(tb, 20)(tp, batch)
    assert torch.isfinite(logits).all()
    assert dict(LAUNCHES) == {"deq_matmul": 7 * 2 + 11 * 2 + 1}
    LAUNCHES.clear()
    logits, _ = engine.build_decode(tb)(tp, state, toks[:, 8:9])
    assert torch.isfinite(logits).all()
    assert dict(LAUNCHES) == {"deq_matmul": 11 * 2 + 1}
    out, last = engine.generate(tb, tp, batch, steps=4, max_len=20,
                                eos_id=int(logits[0, -1].argmax()),
                                device="cpu")
    assert tuple(out.shape) == (2, 5)
    assert torch.equal(last.extras["memory"], state.extras["memory"])


def test_flash_route_matches_einsum(models):
    """``flash_attention=True`` routes the decoder's causal self-attention
    at prefill through ``kops.flash_attention`` (one call a decoder layer,
    the plain version on the CPU); the encoder's non-causal attention and
    cross-attention never take it, nor does decode. The logits and the
    cache equal the einsum route's (1e-5)."""
    _, _, _, tb, tp, tbatch = models
    fb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32, flash_attention=True)
    batch = {"frames": tbatch["frames"], "tokens": tbatch["tokens"][:, :12]}
    want, wstate = engine.build_prefill(tb, 16)(tp, batch)
    LAUNCHES.clear()
    got, gstate = engine.build_prefill(fb, 16)(tp, batch)
    assert LAUNCHES["flash_attention_ref"] == 2
    assert _maxerr(got.numpy(), want.numpy()) < OP_TOL
    for g, w in zip(gstate.caches["seg1_decoder"],
                    wstate.caches["seg1_decoder"]):
        assert _maxerr(g.numpy(), w.numpy()) < OP_TOL
    LAUNCHES.clear()
    engine.build_decode(fb)(tp, gstate, batch["tokens"][:, -1:])
    assert LAUNCHES["flash_attention_ref"] == 0


def test_refusals_by_name(models):
    """The slot scheduler, and so ``make_scheduler("auto")``, refuses a
    bundle with ``decode_extras`` with the reference's message; the paged
    scheduler (``make_scheduler("paged")`` too) refuses it for want of
    chunk-append (``append_ok`` asks for no extras, as the reference's);
    ``generate`` serves it. ``pad_id``, chunk-append and ``split_layers``
    are refused by name too. Other bundles keep empty ``extras``."""
    _, _, _, tb, tp, _ = models
    for backend in ("slot", "auto"):
        with pytest.raises(NotImplementedError,
                           match="decode_extras=\\('memory',\\)"):
            make_scheduler(tb, tp, backend=backend, num_slots=2, max_len=32,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="decode_extras"):
        Scheduler(tb, tp, num_slots=2, max_len=32, device="cpu")
    for make in (lambda: PagedScheduler(tb, tp, num_slots=2, max_len=32,
                                        device="cpu"),
                 lambda: make_scheduler(tb, tp, backend="paged",
                                        num_slots=2, max_len=32,
                                        device="cpu")):
        with pytest.raises(ValueError, match="paged serving requires "
                                             "chunk-append"):
            make()
    assert not tb.ragged_prefill_ok
    with pytest.raises(ValueError, match="ragged_prefill_ok"):
        engine.build_prefill(tb, max_len=16, pad_id=0)
    with pytest.raises(ValueError, match="chunk-append"):
        engine.build_append(tb, 32)
    cfg = model_zoo.get_config(ARCH, smoke=True)
    with pytest.raises(ValueError,
                       match="split_layers unsupported for family encdec"):
        model_zoo.build(cfg, device="cpu", split_layers=1)
    llama = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                 dtype=torch.float32)
    assert llama.decode_extras == () and llama.embed_decode is None
    _, st = engine.build_prefill(llama, 8)(
        llama.init_params(torch.Generator().manual_seed(0)),
        {"tokens": torch.ones((1, 3), dtype=torch.int32)})
    assert st.extras == {}


def test_default_extras_are_read_only():
    """A ``DecodeState`` built without extras holds a read-only empty
    mapping, so no state can write into one that others share."""
    a = engine.DecodeState({}, torch.zeros(1, dtype=torch.int32))
    b = engine.DecodeState({}, torch.ones(1, dtype=torch.int32))
    assert a.extras == b.extras == {}
    with pytest.raises(TypeError):
        a.extras["memory"] = torch.zeros(1)
    assert "memory" not in b.extras


def test_trainer_steps_on_frames():
    """A 3-step ``Trainer`` run on ``batch_for_bundle``'s batches (frames
    (B, S, d), tokens and labels of ``max(S // 4, 16)``): finite losses,
    and as many SVDs as the reference's rules give on the same tree (the
    embedding excluded, the head and every stacked matrix in)."""
    tb = model_zoo.build_arch(ARCH, smoke=True, device="cpu",
                              dtype=torch.float32)
    cell = ShapeCell("t", 64, 4, "train")
    b = batch_for_bundle(tb, cell, 0)
    assert tuple(b["frames"].shape) == (4, 64, 64)
    assert b["frames"].dtype == torch.float32
    assert tuple(b["tokens"].shape) == tuple(b["labels"].shape) == \
        (4, max(64 // encdec.DEC_RATIO, 16))
    qcfg = optimizers.preset("qgalore", QGaLoreConfig(
        rank=8, min_dim=32, update_interval=2))
    tr = Trainer(tb, TrainConfig(global_batch=4, seq_len=64, steps=3), qcfg,
                 cell=cell)
    hist = tr.run()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    flt = jax.tree_util.tree_map(
        lambda t: jnp.asarray(t.numpy()),
        tb.init_params(torch.Generator().manual_seed(0)))
    jspecs = jqgalore.leaf_specs(flt, JQGaLoreConfig(rank=8, min_dim=32))
    units = sum(int(np.prod(s.batch)) for s in jspecs if s.galore)
    assert units == 2 * 18 + 1
    assert sum(s.nbatch for s in tr.specs if s.galore) == units
    # refreshes at steps 0 and 2 of the fixed interval
    assert tr.controller.total_svd_count() == 2 * units == \
        tr.controller.baseline_svd_count(3)


@pytest.mark.parametrize("arch,cell", [
    (ARCH, ("t", 32, 2, "train")),
    (ARCH, ("t", 64, 4, "train")),
    (ARCH, ("p", 100, 3, "prefill")),
    (ARCH, ("d", 48, 2, "decode")),
    ("internvl2-2b", ("t", 32, 2, "train")),
    ("llama-60m", ("t", 32, 2, "train")),
])
def test_input_specs_match_reference(arch, cell):
    """The bundle's ``input_specs`` names the reference's leaves at the
    reference's shapes (the encoder-decoder's frames and its quarter-length
    tokens, a decode cell's short memory, the VLM's prefix), and
    ``batch_for_bundle`` draws exactly those."""
    want = {k: tuple(v.shape) for k, v in
            jzoo.build_arch(arch, smoke=True).input_specs(
                JShapeCell(*cell)).items()}
    tb = model_zoo.build_arch(arch, smoke=True, device="cpu",
                              dtype=torch.float32)
    specs = tb.input_specs(ShapeCell(*cell))
    assert {k: tuple(s) for k, (s, _) in specs.items()} == want
    batch = batch_for_bundle(tb, ShapeCell(*cell), 0)
    assert {k: tuple(v.shape) for k, v in batch.items()} == want
    assert {k: v.dtype for k, v in batch.items()} == \
        {k: d for k, (_, d) in specs.items()}


def test_param_count_and_by_layer_draw():
    """``test_models_smoke.py``'s counts: the smoke model's is positive,
    and the full config's, drawn on the meta device, equals the
    reference's ``count_params`` (977,759,232). A by-layer draw gives the
    default draw's tree, each layer mapped as the whole stack would be."""
    cfg = model_zoo.get_config(ARCH)
    got = model_zoo.count_params(cfg)
    assert got == jbase.count_params(jzoo.build_arch(ARCH)) == 977_759_232
    smoke = model_zoo.get_config(ARCH, smoke=True)
    assert model_zoo.count_params(smoke) > 1000
    tb = model_zoo.build(smoke, device="cpu", dtype=torch.float32)
    flt = tb.init_params(torch.Generator().manual_seed(4), by_layer=True)
    q = tb.init_params(torch.Generator().manual_seed(4),
                       leaf_fn=lambda _, t: quantize_leaf(t), by_layer=True)
    whole = tb.init_params(torch.Generator().manual_seed(4))
    fl, ql, wl = (qgalore.flatten(t) for t in (flt, q, whole))
    assert [k for k, _ in fl] == [k for k, _ in ql] == [k for k, _ in wl]
    assert sorted(whole) == sorted(["embedding", "frame_norm", "seg0_encoder",
                                    "enc_final_norm", "seg1_decoder",
                                    "final_norm", "head"])
    for (keys, f), (_, qt), (_, w) in zip(fl, ql, wl):
        assert tuple(f.shape) == tuple(w.shape), keys
        want = quantize_leaf(f)
        if want is f:
            assert torch.equal(qt, f), keys
        else:
            assert torch.equal(qt.q, want.q), keys
            assert torch.equal(qt.scale, want.scale), keys


def test_leaf_specs_match_reference(models):
    """The GaLore decisions on the encoder-decoder's tree are the
    reference's: the same projected leaves, sides, ranks and batch axes;
    ``embedding`` non-GaLore, the head and every stacked matrix GaLore."""
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
    assert len(proj) == 19
    assert "['head']" in proj and "['embedding']" not in proj
    assert "['seg1_decoder']['cross_attn']['wk']" in proj


def test_sample_on_reference_gumbel_draws():
    """``engine.sample`` with the reference's Gumbel draws handed over
    (``jax.random.gumbel(key, (B, V))``) gives the tokens of the
    reference's ``sample(logits, key, T)`` (``jax.random.categorical``),
    at several keys and temperatures; greedy ignores the noise."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((4, 1, 512)).astype(np.float32) * 3
    for i, T in enumerate((0.5, 1.0, 1.7)):
        key = jax.random.PRNGKey(40 + i)
        want = jengine.sample(jnp.asarray(logits), key, T)
        noise = np.array(jax.random.gumbel(key, (4, 512)))
        got = engine.sample(torch.from_numpy(logits), T,
                            noise=torch.from_numpy(noise))
        assert got.dtype == torch.int32
        assert got.tolist() == np.asarray(want).tolist(), T
    greedy = engine.sample(torch.from_numpy(logits), 0.0,
                           noise=torch.from_numpy(noise))
    assert greedy.tolist() == logits[:, -1].argmax(-1).tolist()
