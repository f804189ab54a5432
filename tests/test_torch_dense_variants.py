"""The dense variants of the decoder against the live JAX package, at the
smoke configs: mistral-nemo-12b and yi-9b (the LLaMA shape, an explicit
head_dim), qwen3-32b (qk-norm), gemma-7b (GeGLU, the tied INT8 head, the
sqrt(d_model) embedding scale) and internvl2-2b (the VLM prefix). Both
packages compute on the same INT8 codes (``from_jax_params``) and the
reference's batches and ``patch_embeds``, handed over as numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.models import base as jbase
from repro.models import model_zoo as jzoo
from repro.models.transformer import _head_logits as j_head
from repro.train import stack as jstack
from repro.train import step as jstep
from repro_torch.config import HybridConfig, MLAConfig, MoEConfig, \
    ShapeCell, SSMConfig, TrainConfig, XLSTMConfig, replace
from repro_torch.core import qgalore, quant
from repro_torch.core.optimizers import preset
from repro_torch.data import synthetic
from repro_torch.kernels import LAUNCHES, ops
from repro_torch.models import base, model_zoo
from repro_torch.models.transformer import _head_logits as t_head
from repro_torch.serve import engine
from repro_torch.serve.params import from_jax_params
from repro_torch.serve.scheduler import Request, Scheduler, make_scheduler
from repro_torch.train import stack
from repro_torch.train.trainer import Trainer

from test_models_smoke import make_batch
from test_torch_serve import _to_numpy

ARCHS = ("mistral-nemo-12b", "yi-9b", "qwen3-32b", "gemma-7b",
         "internvl2-2b")
CELL = JShapeCell("t", seq_len=12, global_batch=2, kind="train")
FWD_TOL = 1e-4      # f32, the same codes: the plain versions' rounding
GRAD_TOL = 5e-3     # the reference's _maxerr bar (test_quantized_dense.py)


def _maxerr(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _jcfg(arch, vocab=None):
    cfg = jzoo.get_config(arch, smoke=True)
    if vocab:
        from repro.config import replace as jreplace
        cfg = jreplace(cfg, vocab_size=vocab)
    return cfg


def _build(arch, vocab=None):
    """A JAX build of ``arch`` (INT8 params, a batch) and the port's bundle
    on the same codes and batch."""
    jcfg = _jcfg(arch, vocab)
    jb = jzoo.build(jcfg, dtype=jnp.float32)
    jp = jstep.prepare_params(jb.init_params(jax.random.PRNGKey(1)),
                              JQGaLoreConfig(), jnp.float32)
    jbatch = make_batch(jb, CELL)
    tcfg = model_zoo.get_config(arch, smoke=True)
    if vocab:
        tcfg = replace(tcfg, vocab_size=vocab)
    tb = model_zoo.build(tcfg, device="cpu", dtype=torch.float32)
    tp = from_jax_params(_to_numpy(jp), device="cpu")
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    return jb, jp, jbatch, tb, tp, tbatch


@pytest.fixture(scope="module")
def models():
    """``models(arch, vocab=None)``: one build per architecture, shared by
    the file's tests."""
    cache = {}

    def get(arch, vocab=None):
        if (arch, vocab) not in cache:
            cache[arch, vocab] = _build(arch, vocab)
        return cache[arch, vocab]
    return get


def _forward(jb, jp, jbatch, tb, tp, tbatch):
    carry, ctx = jb.embed(jp, jbatch)
    carry = jbase.run_segments(jb, jp, carry, ctx)
    want = jb.head_logits(jp, {"h": carry["h"][:, -1:]})
    want_all = j_head(jp, carry["h"], jb.cfg, jnp.float32)
    with torch.no_grad():
        tc, tctx = tb.embed(tp, tbatch)
        tc = base.run_segments(tb, tp, tc, tctx)
        got_all = t_head(tp, tc["h"], tb.cfg, torch.float32)
        got = tb.head_logits(tp, tc)
    return np.asarray(want_all), got_all.numpy(), np.asarray(want), \
        got.numpy()


@pytest.mark.parametrize("arch,vocab", [(a, None) for a in ARCHS]
                         + [("internvl2-2b", 300)])
def test_full_forward_logits_match(models, arch, vocab):
    """Every position's logits (the VLM's prefix positions too) within 1e-4
    of max|ref| at f32; a vocab of 300 pads the untied head's codes to 512
    columns, which never reach the logits."""
    want_all, got_all, want, got = _forward(*models(arch, vocab))
    V = vocab or _jcfg(arch).vocab_size
    assert got_all.shape == want_all.shape and got_all.shape[-1] == V
    assert _maxerr(got_all, want_all) <= FWD_TOL
    assert _maxerr(got, want) <= FWD_TOL
    assert np.isfinite(got_all).all()
    if arch == "internvl2-2b":
        P = _jcfg(arch).num_prefix_embeddings
        assert got_all.shape[1] == P + CELL.seq_len
    # greedy picks stay in the real vocabulary
    toks = engine.sample(torch.from_numpy(got))
    assert int(toks.max()) < V


@pytest.mark.parametrize("arch", ARCHS)
def test_fused_value_and_grad(models, arch):
    """Full-rank ``fused_value_and_grad`` against the reference's: the tied
    embedding sums the lookup's and the head's gradients (gemma-7b),
    ``q_norm``/``k_norm`` get theirs (qwen3-32b), the prefix positions are
    cropped before the loss (internvl2-2b). Finite everywhere."""
    jb, jp, jbatch, tb, tp, tbatch = models(arch)
    (jl, _), jg = jstack.fused_value_and_grad(jb, jp, jbatch, {})
    (tl, _), tg = stack.fused_value_and_grad(tb, tp, tbatch, {})
    assert np.isfinite(float(tl))
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    flat = qgalore.flatten(tg)
    leaves = jax.tree_util.tree_leaves(jg)
    assert len(flat) == len(leaves)
    paths = [k for k, _ in flat]
    if arch == "gemma-7b":
        assert ("head",) not in paths
    if arch == "qwen3-32b":
        assert ("seg0_dense", "attn", "q_norm") in paths
    for (keys, g), want in zip(flat, leaves):
        assert torch.isfinite(g).all(), keys
        assert tuple(g.shape) == tuple(want.shape), keys
        assert _maxerr(g.numpy(), want) <= GRAD_TOL, keys


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen3-32b"])
def test_prefill_then_decode_matches_full_forward(models, arch):
    """The port's prefill of 6 tokens, then teacher-forced decode, against
    the reference's full-sequence logits at each length: 2e-3 after the
    prefill, 5e-3 a decode step (the reference's bars)."""
    jb, jp, jbatch, tb, tp, tbatch = models(arch)
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


def _qdt_inputs():
    """The reference's tied-head shapes: V 97, D 200 (neither a multiple
    of 256), x (13, 200), g (13, 97)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((13, 200)).astype(np.float32)
    w = (rng.standard_normal((97, 200)) * 0.1).astype(np.float32)
    g = rng.standard_normal((13, 97)).astype(np.float32)
    jqt = jq.quantize_blockwise(jnp.asarray(w), bits=8, symmetric=True)
    tqt = quant.from_numpy(_to_numpy({"w": jqt})["w"], "cpu")
    return x, g, jqt, tqt


def test_quantized_dense_t_forward_matches():
    x, _, jqt, tqt = _qdt_inputs()
    want = jops.quantized_dense_t(jnp.asarray(x), jqt, dtype=jnp.float32,
                                  backend="ref")
    LAUNCHES.clear()
    got = ops.quantized_dense_t(torch.from_numpy(x), tqt,
                                dtype=torch.float32)
    assert tuple(got.shape) == (13, 97)
    assert _maxerr(got.numpy(), want) < 1e-5
    assert LAUNCHES["deq_matmul_t"] == 1 and not LAUNCHES["int8_matmul_t"]


def test_quantized_dense_t_grads_match():
    """``dL/dx`` (through ``deq_matmul``, the plain version of
    ``int8_matmul``) and ``dL/dW`` onto the shadow, against jax.grad of the
    reference op."""
    x, g, jqt, tqt = _qdt_inputs()

    def f(shadow, xx):
        out = jops.quantized_dense_t(xx, jq.QVirtual(jqt, shadow),
                                     dtype=jnp.float32, backend="ref")
        return jnp.sum(out * jnp.asarray(g))

    jdw, jdx = jax.grad(f, argnums=(0, 1))(jq.virtualize(jqt).shadow,
                                           jnp.asarray(x))
    wv = quant.virtualize(tqt)
    xt = torch.from_numpy(x).requires_grad_(True)
    LAUNCHES.clear()
    out = ops.quantized_dense_t(xt, wv, dtype=torch.float32)
    dw, dx = torch.autograd.grad((out * torch.from_numpy(g)).sum(),
                                 [wv.shadow, xt])
    assert LAUNCHES["deq_matmul"] == 1
    assert tuple(dw.shape) == (97, 200)
    assert _maxerr(dw.numpy(), jdw) < 1e-5
    assert _maxerr(dx.numpy(), jdx) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts(arch):
    """Counted on the meta device (nothing allocated), equal to the
    reference's ``count_params_analytic``."""
    want = jzoo.count_params_analytic(jzoo.get_config(arch))
    assert model_zoo.count_params(model_zoo.get_config(arch)) == want


def test_gemma_paged_scheduler_matches_slot(models):
    """gemma-7b at f32 through ``make_scheduler()`` (the paged runtime, the
    tied head on every dispatch) gives the slot scheduler's tokens."""
    _, _, _, tb, tp, _ = models("gemma-7b")
    rng = np.random.default_rng(5)
    prefix = rng.integers(1, 512, size=10)
    reqs = []
    for i in range(5):
        t = rng.integers(1, 512, size=int(rng.integers(2, 12)))
        if i % 2:
            t = np.concatenate([prefix, t])
        reqs.append((i, t.astype(np.int32).tolist(), int(rng.integers(2, 6))))
    paged = make_scheduler(tb, tp, num_slots=2, max_len=32, block_size=4,
                           prefill_chunk=8, dtype=torch.float32,
                           device="cpu")
    assert type(paged).__name__ == "PagedScheduler"
    got = {c.rid: c.tokens for c in paged.run([Request(*r) for r in reqs])}
    slot = Scheduler(tb, tp, num_slots=2, max_len=32, dtype=torch.float32,
                     device="cpu")
    want = {c.rid: c.tokens for c in slot.run([Request(*r) for r in reqs])}
    assert got == want
    paged.alloc.check()


def test_vlm_batches_and_training(models):
    """``batch_for_bundle`` gives a VLM bundle its ``patch_embeds`` in the
    activation dtype, and ``Trainer`` trains internvl2-2b on them."""
    tb = models("internvl2-2b")[3]
    cfg = tb.cfg
    cell = ShapeCell("t", seq_len=16, global_batch=2, kind="train")
    batch = synthetic.batch_for_bundle(tb, cell, step=3)
    assert tuple(batch["patch_embeds"].shape) == (
        2, cfg.num_prefix_embeddings, cfg.d_model)
    assert batch["patch_embeds"].dtype == tb.dtype
    again = synthetic.batch_for_bundle(tb, cell, step=3)
    assert torch.equal(batch["patch_embeds"], again["patch_embeds"])
    llama = model_zoo.build_arch("llama-60m", smoke=True, device="cpu")
    assert "patch_embeds" not in synthetic.batch_for_bundle(llama, cell, 0)
    from repro_torch.config import QGaLoreConfig
    hist = Trainer(tb, TrainConfig(global_batch=2, seq_len=16, steps=3),
                   preset("qgalore", QGaLoreConfig(rank=8, min_dim=32,
                                                   update_interval=2))).run()
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("smoke", (False, True))
@pytest.mark.parametrize("arch", model_zoo.ARCH_IDS)
def test_configs_match_the_reference(arch, smoke):
    """The port's configs hold the reference's fields; its one extra,
    ``embed_scale``, is set where the JAX package keys the scale on the
    name."""
    import dataclasses
    tcfg = dataclasses.asdict(model_zoo.get_config(arch, smoke=smoke))
    jcfg = dataclasses.asdict(jzoo.get_config(arch, smoke=smoke))
    assert tcfg.pop("embed_scale") == jcfg["name"].startswith("gemma")
    assert tcfg == jcfg


def test_refusals_name_the_sub_slice():
    gemma = model_zoo.get_config("gemma-7b")
    with pytest.raises(NotImplementedError, match="head_dim <= 128"):
        model_zoo.build(gemma, device="meta", flash_attention=True)
    model_zoo.build(gemma, device="meta")       # the einsum path is fine
    base_cfg = model_zoo.get_config("llama-60m", smoke=True)
    # MoE (4b) is ported: built, not refused
    moe_cfg = replace(base_cfg, family="moe", moe=MoEConfig(
        num_experts=4, top_k=2, expert_ff=32))
    assert not model_zoo.build(moe_cfg, device="cpu").ragged_prefill_ok
    assert "qwen3-moe-30b-a3b" in model_zoo.ARCH_IDS
    # MLA and MTP (4c), xLSTM (4d) and the SSM hybrid (4e) are ported:
    # built, not refused
    hybrid = dict(family="hybrid", ssm=SSMConfig(state_dim=16, head_dim=16,
                                                 chunk_size=16),
                  hybrid=HybridConfig(attn_every=3, shared_lora_rank=8))
    for cfg, sub in ((replace(moe_cfg, attention="mla", mla=MLAConfig()),
                      "4c"),
                     (replace(base_cfg, attention="mla", mla=MLAConfig()),
                      "4c"),
                     (replace(base_cfg, mtp_depth=1), "4c"),
                     (replace(base_cfg, family="xlstm", xlstm=XLSTMConfig(
                         slstm_every=2)), "4d"),
                     (replace(base_cfg, **hybrid), "4e"),
                     (replace(base_cfg, family="encdec"), "4f")):
        if sub == "4f":
            built = model_zoo.build(cfg, device="meta")
            assert [s.name for s in built.segments] == ["encoder", "decoder"]
            assert not engine.append_ok(built)
            assert built.decode_extras == ("memory",)
            continue
        if sub in ("4d", "4e"):
            built = model_zoo.build(cfg, device="meta")
            assert [s.name for s in built.segments] == [
                {"4d": "xlstm", "4e": "zamba"}[sub]]
            assert not engine.append_ok(built)
            assert not built.ragged_prefill_ok
            continue
        if sub == "4c":
            built = model_zoo.build(cfg, device="meta")
            assert engine.append_ok(built) == (cfg.attention != "mla")
            names = qgalore.flatten(built.init_params(torch.Generator()))
            assert (("mtp_block", "attn", "wq") in [k for k, _ in names]) \
                == bool(cfg.mtp_depth)
            continue
        with pytest.raises(NotImplementedError, match=f"sub-slice {sub}"):
            model_zoo.build(cfg, device="cpu")
    # ... and refused by name without its SSM or hybrid settings
    for cut in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="needs cfg.ssm and cfg.hybrid"):
            model_zoo.build(replace(base_cfg, **{**hybrid, cut: None}),
                            device="meta")
    # every architecture of the JAX package is ported
    assert set(model_zoo.ARCH_IDS) == set(jzoo.ARCH_IDS)
