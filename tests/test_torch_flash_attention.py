"""The flash-attention prefill route against the JAX package: the port's
``ops.flash_attention`` (its plain version on the CPU) against the JAX op
on its ``ref`` and ``pallas-interpret`` backends, the routing rule of
``models.attention._flash_eligible``, and llama-60m smoke (MHA and a GQA
variant) built with ``flash_attention=True`` against the JAX model under
``REPRO_FLASH_ATTENTION=1``: prefill logits, ``generate`` and the slot
``Scheduler``. The JAX functions are built after the variable is set,
because the JAX package reads it at trace time."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.core import quant as jq
from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import model_zoo as jzoo
from repro.serve import engine as jeng
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.train import step as jstep
from repro_torch import config as tconfig
from repro_torch.config import QGaLoreConfig, TrainConfig
from repro_torch.core.optimizers import preset
from repro_torch.kernels import LAUNCHES, ops, ref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.models import attention
from repro_torch.models import model_zoo
from repro_torch.serve import engine
from repro_torch.serve.params import from_jax_params
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.train.trainer import Trainer

PAD = 0


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def _qkv(B, S, H, KH, d, dv, seed):
    return (_normal((B, S, H, d), seed), _normal((B, S, KH, d), seed + 1),
            _normal((B, S, KH, dv), seed + 2))


# ---------------------------------------------------------------------------
# The op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [128, 192, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax(S, causal):
    """2e-3 (``tests/test_kernels.py:130-139``) against the JAX op on the
    ``ref`` backend (plain softmax) and the Pallas kernel in interpret
    mode."""
    q, k, v = _qkv(2, S, 3, 3, 64, 64, S)
    LAUNCHES.clear()
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    assert LAUNCHES["flash_attention_ref"] == 1
    assert LAUNCHES["flash_attention"] == 0
    assert got.shape == (2, S, 3, 64) and got.dtype == torch.float32
    jq_, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    for kw in ({"backend": "ref"}, {"interpret": True}):
        want = jops.flash_attention(jq_, jk, jv, causal=causal, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)


def test_flash_dv_differs_from_d():
    """``tests/test_kernels.py:141-151``: d 48, dv 32."""
    q, k, v = _qkv(1, 128, 2, 2, 48, 32, 17)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True)
    assert got.shape == (1, 128, 2, 32)
    for kw in ({"backend": "ref"}, {"interpret": True}):
        want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_gqa_native_matches_jax_repeated(causal):
    """H 8, KH 2: the port reads kv head h // 4; the JAX op is given the
    kv heads repeated, as ``repro/models/attention.py:85-88`` folds GQA."""
    q, k, v = _qkv(2, 128, 8, 2, 32, 32, 23)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    kr, vr = (jnp.repeat(jnp.asarray(a), 4, axis=2) for a in (k, v))
    for kw in ({"backend": "ref"}, {"interpret": True}):
        want = jops.flash_attention(jnp.asarray(q), kr, vr, causal=causal,
                                    **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-3)


def test_flash_bf16_output_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 48, 4, 2, 64, 64, 3))
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 48, 4, 64)
    want = ref.flash_attention_ref(q, k, v, causal=True)
    assert ((got.float() - want).abs().max() / want.abs().max()) <= 1e-2


def test_flash_refuses_grad():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 8, 8, 5))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, v)


@pytest.mark.parametrize("shapes,msg", [
    (((1, 16, 6, 8), (1, 16, 4, 8), (1, 16, 4, 8)), "multiple"),
    (((1, 16, 2, 160), (1, 16, 2, 160), (1, 16, 2, 8)), "head dims"),
    (((1, 16, 2, 8), (1, 8, 2, 8), (1, 8, 2, 8)), "must be"),
])
def test_flash_rejects_bad_shapes(shapes, msg):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError, match=msg):
        tflash.flash_attention(q, k, v)


# ---------------------------------------------------------------------------
# The f32 kernel's arithmetic (csrc/flash_attention.cu, flash_f32)
# ---------------------------------------------------------------------------

def _split(t, passes):
    """(hi, lo) of an f32 tensor as bf16 values in f32; lo is zero for one
    pass."""
    hi = t.to(torch.bfloat16).float()
    lo = (t - hi).to(torch.bfloat16).float() if passes == 2 else \
        torch.zeros_like(t)
    return hi, lo


def _emulate_flash_f32(q, k, v, causal, passes=2):
    """float32 emulation of the f32 kernel: Q, K, V and P split into hi =
    bf16(x) and lo = bf16(x - hi), each product taken as hi.hi + hi.lo +
    lo.hi in f32 (lo zero for one pass), the online softmax over 64-row KV
    tiles in the log2 domain (scores times scale * log2 e, masked to
    -1e30, exp2), and acc / max(l, 1e-30) at the end."""
    B, S, H, d = q.shape
    G = H // k.shape[2]
    k, v = (t.repeat_interleave(G, dim=2).transpose(1, 2) for t in (k, v))
    q = q.transpose(1, 2)                                # (B, H, S, d)
    qh, ql = _split(q, passes)
    sl2 = np.float32(1.0 / np.sqrt(d)) * np.float32(1.4426950408889634)
    m = torch.full((B, H, S, 1), -1e30)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, v.shape[-1]))
    rows = torch.arange(S)[:, None]
    for kv0 in range(0, S, 64):
        kt, vt = k[:, :, kv0:kv0 + 64], v[:, :, kv0:kv0 + 64]
        kh, kl = _split(kt, passes)
        vh, vl = _split(vt, passes)
        s = qh @ kh.transpose(-1, -2) + qh @ kl.transpose(-1, -2) \
            + ql @ kh.transpose(-1, -2)
        x = s * sl2
        cols = kv0 + torch.arange(kt.shape[2])[None, :]
        if causal:
            x = torch.where(cols <= rows, x, torch.tensor(-1e30))
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ph, pl = _split(p, passes)
        acc = acc * alpha + ph @ vh + ph @ vl + pl @ vh
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).transpose(1, 2)


@pytest.mark.parametrize("B,S,H,KH,d,dv,causal", [
    (2, 128, 4, 4, 64, 64, True),      # llama's head width, two KV tiles
    (1, 192, 8, 2, 32, 32, True),      # GQA, three KV tiles
    (1, 100, 2, 2, 48, 32, False),     # d != dv, a ragged last KV tile
    (1, 512, 2, 1, 64, 128, True),     # GQA, dv 128, eight KV tiles
])
def test_flash_f32_kernel_arithmetic_matches_plain(B, S, H, KH, d, dv,
                                                   causal):
    """The f32 kernel's three passes on split operands within 1e-4 of
    max|plain| (``ref.flash_attention_ref``) and of the JAX package's Pallas
    kernel in interpret mode; one pass (hi only) must miss that bar, so a
    check at 1e-4 can tell a dropped pass."""
    qn, kn, vn = _qkv(B, S, H, KH, d, dv, S + d)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    want = ref.flash_attention_ref(q, k, v, causal=causal).numpy()
    kr, vr = (jnp.repeat(jnp.asarray(a), H // KH, axis=2) for a in (kn, vn))
    jwant = np.asarray(jops.flash_attention(jnp.asarray(qn), kr, vr,
                                            causal=causal, interpret=True))
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    three = _emulate_flash_f32(q, k, v, causal).numpy()
    assert three.shape == (B, S, H, dv)
    assert rel(three, want) <= 1e-4
    assert rel(three, jwant) <= 1e-4
    one = _emulate_flash_f32(q, k, v, causal, passes=1).numpy()
    assert rel(one, want) > 1e-4


# ---------------------------------------------------------------------------
# Routing (tests/test_models_smoke.py:102-141)
# ---------------------------------------------------------------------------

def test_flash_route_matches_chunked(monkeypatch):
    """Eligible calls take the flash op and match the chunked path and the
    JAX route; ineligible calls (non-causal, a decode offset, one query)
    stay on the chunked path bit for bit."""
    B, S, H, KH, dh = 2, 64, 8, 2, 16
    qn, kn, vn = _qkv(B, S, H, KH, dh, dh, 0)
    q, k, v = (torch.from_numpy(a) for a in (qn, kn, vn))
    want = attention.chunked_attention(q, k, v, causal=True)
    assert attention._flash_eligible(q, k, True, 0)
    LAUNCHES.clear()
    got = attention.chunked_attention(q, k, v, causal=True, flash=True)
    assert LAUNCHES["flash_attention_ref"] == 1
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "1")
    jwant = jattn.chunked_attention(jnp.asarray(qn), jnp.asarray(kn),
                                    jnp.asarray(vn), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=2e-5,
                               atol=2e-5)
    # MHA also routes
    kf, vf = (t.repeat_interleave(H // KH, dim=2) for t in (k, v))
    got_mha = attention.chunked_attention(q, kf, vf, causal=True,
                                          flash=True)
    np.testing.assert_allclose(got_mha.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    for kwargs, qq in (({"causal": False}, q), ({"q_offset": 16}, q),
                       ({}, q[:, :1])):
        assert not attention._flash_eligible(
            qq, k, kwargs.get("causal", True), kwargs.get("q_offset", 0))
        LAUNCHES.clear()
        on = attention.chunked_attention(qq, k, v, flash=True, **kwargs)
        off = attention.chunked_attention(qq, k, v, **kwargs)
        assert LAUNCHES["flash_attention_ref"] == 0
        assert torch.equal(on, off)


# ---------------------------------------------------------------------------
# Model level: llama-60m smoke and a GQA variant
# ---------------------------------------------------------------------------

def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda l: (np.asarray(l.q), np.asarray(l.scale), None, l.bits,
                   l.block, l.orig_last, l.dtype)
        if isinstance(l, jq.QTensor) else np.asarray(l),
        tree, is_leaf=lambda l: isinstance(l, jq.QTensor))


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def models(request):
    """(JAX bundle, JAX params, port bundle with the flash route, port
    params) on the same INT8 codes; ``request.param`` kv heads of 4."""
    kh = request.param
    jcfg = jconfig.replace(jzoo.get_config("llama-60m", smoke=True),
                           num_kv_heads=kh)
    jb = jzoo.build(jcfg, dtype=jnp.float32)
    jp = jstep.prepare_params(jb.init_params(jax.random.PRNGKey(kh)),
                              JQGaLoreConfig(), jnp.float32)
    tcfg = tconfig.replace(model_zoo.get_config("llama-60m", smoke=True),
                           num_kv_heads=kh)
    tb = model_zoo.build(tcfg, device="cpu", dtype=torch.float32,
                         flash_attention=True)
    return jb, jp, tb, from_jax_params(_to_numpy(jp), device="cpu")


def test_prefill_logits_match_jax_flash_route(models, monkeypatch):
    """1e-4, the tolerance of ``tests/test_torch_serve.py``; one flash
    call a layer, and decode never takes the route."""
    jb, jp, tb, tp = models
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "1")
    traced = []
    jflash = jops.flash_attention
    monkeypatch.setattr(jops, "flash_attention",
                        lambda *a, **k: traced.append(1) or jflash(*a, **k))
    toks = np.random.default_rng(0).integers(1, 512, size=(2, 10)) \
        .astype(np.int32)
    jl, js = jax.jit(jeng.build_prefill(jb, 24))(
        jp, {"tokens": jnp.asarray(toks)})
    assert traced            # the JAX route was traced (once: a layer scan)
    LAUNCHES.clear()
    tl, ts = engine.build_prefill(tb, 24)(tp,
                                          {"tokens": torch.from_numpy(toks)})
    assert LAUNCHES["flash_attention_ref"] == tb.cfg.num_layers
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    LAUNCHES.clear()
    engine.build_decode(tb)(tp, ts, torch.from_numpy(toks[:, :1]))
    assert LAUNCHES["flash_attention_ref"] == 0


def test_generate_tokens_match_jax_flash_route(models, monkeypatch):
    jb, jp, tb, tp = models
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "1")
    rng = np.random.default_rng(1)
    lengths = [9, 4, 6]
    toks = np.full((3, 9), PAD, np.int32)
    for i, L in enumerate(lengths):
        toks[i, :L] = rng.integers(1, 512, size=L)
    jt, _ = jeng.generate(jb, jp, {"tokens": jnp.asarray(toks)}, steps=6,
                          max_len=24, pad_id=PAD)
    LAUNCHES.clear()
    tt, _ = engine.generate(tb, tp, {"tokens": torch.from_numpy(toks)},
                            steps=6, max_len=24, pad_id=PAD, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert LAUNCHES["flash_attention_ref"] == tb.cfg.num_layers


def _requests(cls):
    rng = np.random.default_rng(5)
    return [cls(rid=r, tokens=rng.integers(1, 512, size=int(
        rng.integers(3, 12))).astype(np.int32),
        max_new_tokens=int(rng.integers(2, 8))) for r in range(6)]


def test_scheduler_matches_jax_scheduler_flash_route(models, monkeypatch):
    """Every group prefill takes the route once a layer."""
    jb, jp, tb, tp = models
    monkeypatch.setenv("REPRO_FLASH_ATTENTION", "1")
    jsched = JScheduler(jb, jp, num_slots=2, max_len=32, dtype=jnp.float32,
                        prompt_bucket=8)
    want = {c.rid: c.tokens for c in jsched.run(_requests(JRequest))}
    tsched = Scheduler(tb, tp, num_slots=2, max_len=32,
                       dtype=torch.float32, prompt_bucket=8, device="cpu")
    LAUNCHES.clear()
    got = {c.rid: c.tokens for c in tsched.run(_requests(Request))}
    assert got == want
    assert tsched.stats == jsched.stats
    assert LAUNCHES["flash_attention_ref"] == \
        tb.cfg.num_layers * tsched.stats["prefills"]


def test_trainer_refuses_flash_bundle():
    b = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                             dtype=torch.float32, flash_attention=True)
    with pytest.raises(ValueError, match="flash"):
        Trainer(b, TrainConfig(global_batch=2, seq_len=16, steps=1),
                preset("qgalore", QGaLoreConfig(rank=8, min_dim=32)))
