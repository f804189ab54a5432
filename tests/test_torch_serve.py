"""The port's serving path against the JAX package on llama-60m smoke,
both running on the same INT8 codes (the JAX init, exported through
from_jax_params): prefill and teacher-forced decode logits, greedy
generate (ragged prompts, EOS), and the slot scheduler's completions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import QGaLoreConfig
from repro.core import quant as jq
from repro.models import model_zoo as jzoo
from repro.serve import engine as jeng
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.train import step as jstep
from repro_torch.kernels import LAUNCHES
from repro_torch.models import model_zoo
from repro_torch.serve import engine
from repro_torch.serve.params import from_jax_params, prepare_params
from repro_torch.serve.scheduler import Request, Scheduler

PAD = 0


def _to_numpy(tree):
    return jax.tree_util.tree_map(
        lambda l: (np.asarray(l.q), np.asarray(l.scale), None, l.bits,
                   l.block, l.orig_last, l.dtype)
        if isinstance(l, jq.QTensor) else np.asarray(l),
        tree, is_leaf=lambda l: isinstance(l, jq.QTensor))


@pytest.fixture(scope="module")
def jax_model():
    bundle = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    params = jstep.prepare_params(bundle.init_params(jax.random.PRNGKey(0)),
                                  QGaLoreConfig(), jnp.float32)
    return bundle, params


@pytest.fixture(scope="module")
def torch_model(jax_model):
    bundle = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                  dtype=torch.float32)
    return bundle, from_jax_params(_to_numpy(jax_model[1]), device="cpu")


def _close(got, want):
    # f32 on both sides: they differ only in summation order
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_from_jax_params_quantizes_like_prepare_params(jax_model):
    """The port's own prepare_params on the JAX float init gives the
    JAX package's codes: the norm stacks too, the 1-D final norm not."""
    jb, jp = jax_model
    raw = jb.init_params(jax.random.PRNGKey(0))
    floats = jax.tree_util.tree_map(
        lambda l: torch.from_numpy(np.array(l)), raw)
    mine = prepare_params(floats, device="cpu")
    seg = mine["seg0_dense"]
    assert seg["attn_norm"].q.shape == (2, 256)
    assert seg["attn_norm"].orig_last == 64
    assert mine["embedding"].q.shape == (512, 256)
    assert mine["final_norm"].ndim == 1
    np.testing.assert_array_equal(seg["ffn"]["wd"].q.numpy(),
                                  np.asarray(jp["seg0_dense"]["ffn"]["wd"].q))
    np.testing.assert_array_equal(mine["head"].scale.numpy(),
                                  np.asarray(jp["head"].scale))


def test_prefill_and_decode_logits_match(jax_model, torch_model):
    (jb, jp), (tb, tp) = jax_model, torch_model
    rng = np.random.default_rng(0)
    toks = rng.integers(1, 512, size=(2, 10)).astype(np.int32)
    jl, js = jax.jit(jeng.build_prefill(jb, 24))(
        jp, {"tokens": jnp.asarray(toks)})
    LAUNCHES.clear()
    tl, ts = engine.build_prefill(tb, 24)(tp,
                                          {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))
    # 7 dense layers a block + the head, all on the plain CPU path
    assert LAUNCHES["deq_matmul"] == 7 * 2 + 1
    assert LAUNCHES["int8_matmul"] == 0
    jd = jax.jit(jeng.build_decode(jb))
    td = engine.build_decode(tb)
    for _ in range(4):
        nt = rng.integers(1, 512, size=(2, 1)).astype(np.int32)
        jl, js = jd(jp, js, jnp.asarray(nt))
        tl, ts = td(tp, ts, torch.from_numpy(nt))
        _close(tl, jl)
    k_j, v_j = js.caches["seg0_dense"]
    k_t, v_t = ts.caches["seg0_dense"]
    assert tuple(k_t.shape) == k_j.shape
    _close(k_t, k_j)
    _close(v_t, v_j)


def test_generate_ragged_tokens_match(jax_model, torch_model):
    (jb, jp), (tb, tp) = jax_model, torch_model
    rng = np.random.default_rng(1)
    lengths = [9, 4, 6]
    toks = np.full((3, 9), PAD, np.int32)
    for i, L in enumerate(lengths):
        toks[i, :L] = rng.integers(1, 512, size=L)
    jt, js = jeng.generate(jb, jp, {"tokens": jnp.asarray(toks)}, steps=6,
                           max_len=24, pad_id=PAD)
    tt, ts = engine.generate(tb, tp, {"tokens": torch.from_numpy(toks)},
                             steps=6, max_len=24, pad_id=PAD, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))
    # explicit lengths instead of trailing-pad detection
    tt2, _ = engine.generate(
        tb, tp, {"tokens": torch.from_numpy(toks),
                 "lengths": torch.tensor(lengths, dtype=torch.int32)},
        steps=6, max_len=24, device="cpu")
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt))


def test_generate_eos_matches(jax_model, torch_model):
    (jb, jp), (tb, tp) = jax_model, torch_model
    prompt = np.random.default_rng(2).integers(1, 512, size=(1, 6)) \
        .astype(np.int32)
    ref, _ = jeng.generate(jb, jp, {"tokens": jnp.asarray(prompt)},
                           steps=6, max_len=32)
    eos = int(np.asarray(ref)[0, 2])
    jt, js = jeng.generate(jb, jp, {"tokens": jnp.asarray(prompt)},
                           steps=6, max_len=32, eos_id=eos, pad_id=PAD)
    tt, ts = engine.generate(tb, tp, {"tokens": torch.from_numpy(prompt)},
                             steps=6, max_len=32, eos_id=eos, pad_id=PAD,
                             device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert int(ts.lengths[0]) == int(js.lengths[0]) < 6 + 6


def test_empty_prompt_rejected(torch_model):
    tb, tp = torch_model
    toks = torch.tensor([[PAD, PAD], [5, 3]], dtype=torch.int32)
    with pytest.raises(ValueError, match="empty prompt row"):
        engine.generate(tb, tp, {"tokens": toks}, steps=2, max_len=8,
                        pad_id=PAD, device="cpu")


def _requests(cls):
    """The request set of tests/test_scheduler.py::
    test_continuous_matches_lockstep."""
    rng = np.random.default_rng(5)
    out = []
    for r in range(6):
        tokens = rng.integers(1, 512, size=int(rng.integers(3, 12))) \
            .astype(np.int32)
        out.append(cls(rid=r, tokens=tokens,
                       max_new_tokens=int(rng.integers(2, 8))))
    return out


def test_scheduler_matches_jax_scheduler(jax_model, torch_model):
    (jb, jp), (tb, tp) = jax_model, torch_model
    jsched = JScheduler(jb, jp, num_slots=2, max_len=32, dtype=jnp.float32,
                        prompt_bucket=8)
    want = {c.rid: c.tokens for c in jsched.run(_requests(JRequest))}
    tsched = Scheduler(tb, tp, num_slots=2, max_len=32,
                       dtype=torch.float32, prompt_bucket=8, device="cpu")
    got = {c.rid: c.tokens for c in tsched.run(_requests(Request))}
    assert got == want
    assert tsched.stats == jsched.stats
    assert all(s.free for s in tsched.slots)


def test_scheduler_eos_and_oversize(torch_model):
    tb, tp = torch_model
    prompt = np.arange(1, 7, dtype=np.int32)
    ref, _ = engine.generate(tb, tp, {"tokens": torch.from_numpy(prompt)[None]},
                             steps=5, max_len=32, device="cpu")
    ref = ref[0].tolist()
    sched = Scheduler(tb, tp, num_slots=1, max_len=32, dtype=torch.float32,
                      prompt_bucket=8, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(Request(rid=9, tokens=prompt, max_new_tokens=40))
    comps = {c.rid: c for c in sched.run(
        [Request(rid=0, tokens=prompt, max_new_tokens=6, eos_id=ref[2]),
         Request(rid=1, tokens=prompt[:3], max_new_tokens=3)])}
    assert comps[0].tokens == ref[:3]
    assert len(comps[1].tokens) == 3
    assert sched.stats["admitted"] == sched.stats["retired"] == 2


def test_scheduler_arrivals_same_completions(torch_model):
    """Requests withheld until their arrival offsets complete with the
    same tokens as when all are queued at once (greedy)."""
    tb, tp = torch_model
    reqs = _requests(Request)[:4]
    kw = dict(num_slots=2, max_len=32, dtype=torch.float32,
              prompt_bucket=8, device="cpu")
    at_once = {c.rid: c.tokens for c in Scheduler(tb, tp, **kw).run(reqs)}
    sched = Scheduler(tb, tp, **kw)
    staged = {c.rid: c.tokens for c in sched.run(
        reqs, arrivals=[0.0, 0.05, 0.0, 0.1])}
    assert staged == at_once
    assert sched.stats["admitted"] == sched.stats["retired"] == 4


def test_temperature_sampling_follows_generator(torch_model):
    tb, tp = torch_model
    toks = torch.from_numpy(
        np.random.default_rng(8).integers(1, 512, size=(2, 5))
        .astype(np.int32))

    def run(seed):
        out, _ = engine.generate(tb, tp, {"tokens": toks}, steps=5,
                                 max_len=16, temperature=0.9, device="cpu",
                                 generator=torch.Generator().manual_seed(seed))
        return out

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 512
