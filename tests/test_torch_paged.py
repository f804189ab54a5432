"""The port's paged serving runtime (serve/paged.py, serve/radix.py,
engine.build_append) against the JAX package's on llama-60m smoke, both
on the same INT8 codes (the JAX init, exported through from_jax_params),
f32 on both sides: the allocator's invariants, chunked append against the
reference and against one-shot prefill, the paged scheduler's completions
and stats under radix hits, eviction and preemption, the capacity gain at
fixed memory, admission backpressure, and backend selection."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.config import QGaLoreConfig
from repro.models import model_zoo as jzoo
from repro.serve import engine as jeng
from repro.serve import paged as jpaged
from repro.serve.scheduler import Request as JRequest
from repro.train import step as jstep
from repro_torch.models import model_zoo
from repro_torch.serve import engine, paged
from repro_torch.serve.params import from_jax_params
from repro_torch.serve.radix import RadixCache
from repro_torch.serve.scheduler import Request, Scheduler, init_pool, \
    make_scheduler
from test_torch_serve import _to_numpy

PAD = 0
V = 512          # llama-60m smoke vocabulary


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
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _reqs(cls, seed, n, *, lo=3, hi=20, new_lo=2, new_hi=8, shared=0):
    """The request sets of tests/test_paged.py: every other prompt behind
    a ``shared``-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, V, size=shared) if shared else None
    out = []
    for i in range(n):
        p = rng.integers(1, V, size=int(rng.integers(lo, hi)))
        if prefix is not None and i % 2 == 0:
            p = np.concatenate([prefix, p])
        out.append(cls(rid=i, tokens=p.astype(np.int32).tolist(),
                       max_new_tokens=int(rng.integers(new_lo, new_hi))))
    return out


# ---------------------------------------------------------------------------
# Block allocator and radix cache
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(st.integers(2, 40),
       st.lists(st.tuples(st.integers(0, 2), st.integers(0, 10 ** 6)),
                max_size=200))
def test_allocator_random_ops_match_reference(num_blocks, ops):
    """Any sequence of alloc/ref/deref keeps the invariant (refcounts and
    the free list partition the pool), matches a model refcount, and
    hands out the reference allocator's block ids in its order."""
    a, ref = paged.BlockAllocator(num_blocks), jpaged.BlockAllocator(
        num_blocks)
    live = {}                       # phys -> model refcount
    for op, pick in ops:
        if op == 0:
            p = a.alloc()
            assert p == ref.alloc()
            if p is None:
                assert not a.free_blocks
            else:
                assert p not in live and p != 0
                live[p] = 1
        elif live:
            p = sorted(live)[pick % len(live)]
            if op == 1:
                a.ref(p)
                ref.ref(p)
                live[p] += 1
            else:
                a.deref(p)
                ref.deref(p)
                live[p] -= 1
                if live[p] == 0:
                    del live[p]
        a.check()
        assert {p: int(a.refcount[p]) for p in live} == live
        assert a.free_blocks == a.usable_blocks - len(live)
        np.testing.assert_array_equal(a.refcount, ref.refcount)
    with pytest.raises(ValueError, match="scratch"):
        a.deref(0)
    p = a.alloc()
    if p is not None:
        a.deref(p)
        with pytest.raises(ValueError, match="double free"):
            a.deref(p)
        with pytest.raises(ValueError, match="ref of free block"):
            a.ref(p)


def test_radix_lru_evicts_leaves_first():
    r = RadixCache(block_size=2)
    adopted = r.insert([1, 2, 3, 4], [10, 11])    # chain 10 -> 11
    assert adopted == [10, 11]
    r.insert([1, 2, 9, 9], [10, 12])              # branch at depth 1
    assert len(r) == 3
    assert r.match([1, 2, 3, 4, 5]) == [10, 11]
    # internal node 10 is pinned while children live
    assert r.evict(lambda p: p == 10) is None
    # the match touched 11 last, so 12 is now the LRU leaf
    assert r.evict(lambda p: True) == 12
    assert r.evict(lambda p: True) == 11
    assert r.evict(lambda p: True) == 10          # now a leaf
    assert r.evict(lambda p: True) is None
    assert len(r) == 0


def test_write_plan_and_pool_write_match_reference():
    """The append write plan and the pool write give the reference's
    targets and pool (scratch block 0 aside: colliding writes to it are
    dead content)."""
    rng = np.random.default_rng(9)
    MB, blk, NB, C = 4, 4, 9, 5
    tables = rng.integers(1, NB, size=(3, MB)).astype(np.int32)
    base = np.array([0, 6, 13], np.int32)
    chunk_len = np.array([5, 2, 0], np.int32)
    got = paged._append_write_plan(torch.from_numpy(tables),
                                   torch.from_numpy(base),
                                   torch.from_numpy(chunk_len), C, blk, MB)
    want = jpaged._append_write_plan(jnp.asarray(tables), jnp.asarray(base),
                                     jnp.asarray(chunk_len), C, blk, MB)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    phys, off = (np.array(w) for w in want)
    # distinct targets for the valid entries, as the scheduler makes them
    valid = phys != 0
    assert len({(p, o) for p, o in zip(phys[valid], off[valid])}) \
        == valid.sum()
    pool = rng.standard_normal((2, NB, blk, 2, 3)).astype(np.float32)
    kv = rng.standard_normal((2, len(phys), 2, 3)).astype(np.float32)
    mine = paged.pool_write_kv(
        {"s": (torch.from_numpy(pool.copy()),)}, torch.from_numpy(phys),
        torch.from_numpy(off), {"s": (torch.from_numpy(kv),)})["s"][0]
    ref = jpaged.pool_write_kv({"s": (jnp.asarray(pool),)}, jnp.asarray(phys),
                               jnp.asarray(off),
                               {"s": (jnp.asarray(kv),)})["s"][0]
    np.testing.assert_array_equal(mine.numpy()[:, 1:], np.asarray(ref)[:, 1:])
    assert not np.array_equal(mine.numpy()[:, 1:], pool[:, 1:])


# ---------------------------------------------------------------------------
# Chunked append
# ---------------------------------------------------------------------------

P_LEN, MAX_LEN = 13, 32


def _prompt():
    return np.random.default_rng(2).integers(1, V, size=P_LEN) \
        .astype(np.int32)


def _append_chunks(append, state, prompt, c, to_dev):
    pos = 0
    while pos < len(prompt):
        n = min(c, len(prompt) - pos)
        chunk = np.full((1, c), PAD, np.int32)
        chunk[0, :n] = prompt[pos:pos + n]
        logits, state = append(state, to_dev(chunk),
                               to_dev(np.array([n], np.int32)))
        pos += n
    return logits, state


@pytest.mark.parametrize("c", [1, 4, 13, 14])
def test_append_matches_reference(jax_model, torch_model, c):
    """The port's build_append against the reference's, chunk by chunk
    at width ``c``: last logits and the written cache within 1e-4."""
    (jb, jp), (tb, tp) = jax_model, torch_model
    prompt = _prompt()
    ds = jeng.abstract_decode_state(jb, 1, MAX_LEN, jnp.float32)
    jstate = jeng.DecodeState(
        jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                               ds.caches), jnp.zeros((1,), jnp.int32), {})
    japp = jax.jit(jeng.build_append(jb, MAX_LEN))
    jl, jstate = _append_chunks(lambda s, t, n: japp(jp, s, t, n), jstate,
                                prompt, c, jnp.asarray)
    tapp = engine.build_append(tb, MAX_LEN)
    tl, tstate = _append_chunks(
        lambda s, t, n: tapp(tp, s, t, n),
        init_pool(tb, 1, MAX_LEN, torch.float32, "cpu"), prompt, c,
        torch.from_numpy)
    _close(tl, jl)
    assert int(tstate.lengths[0]) == int(jstate.lengths[0]) == P_LEN
    for t, j in zip(tstate.caches["seg0_dense"],
                    jstate.caches["seg0_dense"]):
        _close(t[:, :, :P_LEN], np.asarray(j)[:, :, :P_LEN])


def test_chunked_append_matches_own_prefill(torch_model):
    """Every chunk width (width 1 runs padded to 2) gives one-shot
    prefill's logits and cache within 1e-5; positions past the prompt are
    never written."""
    tb, tp = torch_model
    prompt = _prompt()
    want_l, want = engine.build_prefill(tb, MAX_LEN)(
        tp, {"tokens": torch.from_numpy(prompt)[None]})
    tapp = engine.build_append(tb, MAX_LEN)
    for c in range(1, P_LEN + 2):
        logits, state = _append_chunks(
            lambda s, t, n: tapp(tp, s, t, n),
            init_pool(tb, 1, MAX_LEN, torch.float32, "cpu"), prompt, c,
            torch.from_numpy)
        torch.testing.assert_close(logits, want_l, rtol=0, atol=1e-5)
        for got, ref in zip(state.caches["seg0_dense"],
                            want.caches["seg0_dense"]):
            torch.testing.assert_close(got[:, :, :P_LEN],
                                       ref[:, :, :P_LEN], rtol=0, atol=1e-5)
            assert not got[:, :, P_LEN:].any(), c
        assert int(state.lengths[0]) == P_LEN


# ---------------------------------------------------------------------------
# The paged scheduler against the reference's
# ---------------------------------------------------------------------------

# (name, scheduler keywords, request-set keywords, rounds): radix hits on
# a shared prefix (tests/test_paged.py::test_paged_token_identical_to_slot);
# a pool too small for the offered concurrency, admitted optimistically,
# so slots preempt each other (::test_paged_parity_under_eviction_and_
# preemption); and three rounds of shared-prefix traffic through an
# 18-block pool, where admission evicts radix leaves
# (::test_allocator_accounts_after_random_admit_retire)
SCHED_CASES = [
    ("radix_hits", dict(num_slots=4, max_len=64, block_size=8,
                        prefill_chunk=8),
     dict(seed=3, n=12, shared=24), 1),
    ("preemption", dict(num_slots=3, max_len=20, block_size=4,
                        num_blocks=12, prefill_chunk=4,
                        reserve_decode=False),
     dict(seed=4, n=4, lo=8, hi=9, new_lo=12, new_hi=13), 1),
    ("radix_eviction", dict(num_slots=4, max_len=48, block_size=8,
                            num_blocks=18, prefill_chunk=8),
     dict(seed=1, n=7, shared=16), 3),
]


@pytest.mark.parametrize("name,kw,req_kw,rounds", SCHED_CASES,
                         ids=[c[0] for c in SCHED_CASES])
def test_paged_scheduler_matches_reference(jax_model, torch_model, name, kw,
                                           req_kw, rounds):
    (jb, jp), (tb, tp) = jax_model, torch_model
    jsched = jpaged.PagedScheduler(jb, jp, dtype=jnp.float32, **kw)
    tsched = paged.PagedScheduler(tb, tp, dtype=torch.float32, device="cpu",
                                  **kw)
    for r in range(rounds):
        rk = dict(req_kw, seed=req_kw["seed"] + 10 * r)
        want = {c.rid: c.tokens for c in jsched.run(_reqs(JRequest, **rk))}
        got = {c.rid: c.tokens for c in tsched.run(_reqs(Request, **rk))}
        assert got == want
        assert tsched.stats == jsched.stats
        tsched.alloc.check()
        held = tsched.radix.cached_blocks()
        assert sorted(held) == sorted(jsched.radix.cached_blocks())
        assert tsched.alloc.free_blocks == tsched.alloc.usable_blocks \
            - len(held)
        for b in held:
            assert int(tsched.alloc.refcount[b]) == 1
        tsched.completed, jsched.completed = [], []
    stat = {"radix_hits": "radix_hit_blocks", "preemption": "preemptions",
            "radix_eviction": "radix_evictions"}[name]
    assert tsched.stats[stat] > 0
    assert all(s.free for s in tsched.slots)


def test_prefix_hit_blocks_match_cold_prefill(torch_model):
    """A radix-hit request maps blocks holding what a cold one-shot
    prefill of the prefix writes (within 1e-5): shared blocks are never
    written again."""
    tb, tp = torch_model
    blk = 8
    rng = np.random.default_rng(5)
    shared = rng.integers(1, V, size=2 * blk).astype(np.int32)
    prompt_b = np.concatenate([shared, rng.integers(1, V, size=5)
                               .astype(np.int32)])
    sched = paged.PagedScheduler(tb, tp, num_slots=2, max_len=48,
                                 block_size=blk, prefill_chunk=8,
                                 dtype=torch.float32, device="cpu")
    sched.run([Request(rid=0, tokens=shared.tolist(), max_new_tokens=2)])
    hits0 = sched.stats["radix_hit_blocks"]
    sched.run([Request(rid=1, tokens=prompt_b.tolist(), max_new_tokens=2)])
    assert sched.stats["radix_hit_blocks"] - hits0 == 2
    matched = sched.radix.match(prompt_b)
    _, cold = engine.build_prefill(tb, 2 * blk)(
        tp, {"tokens": torch.from_numpy(shared)[None]})
    for pool, ref in zip(sched.caches["seg0_dense"],
                         cold.caches["seg0_dense"]):
        got = pool[:, matched].reshape(pool.shape[0], 2 * blk,
                                       *pool.shape[3:])
        torch.testing.assert_close(got, ref[:, 0], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Paged against slot, admission, backend selection
# ---------------------------------------------------------------------------

def test_paged_doubles_concurrency_at_fixed_memory(torch_model):
    """Short requests: the slot pool burns max_len of KV per request, the
    paged pool blocks for actual lengths, so at the same pool bytes and
    twice the slots it runs >= 2x the concurrent requests, with the slot
    scheduler's tokens."""
    tb, tp = torch_model
    max_len, blk = 64, 8
    reqs = _reqs(Request, 7, 8, lo=4, hi=10, new_lo=4, new_hi=7)
    slot = Scheduler(tb, tp, num_slots=4, max_len=max_len,
                     dtype=torch.float32, device="cpu")
    want = {c.rid: c.tokens for c in slot.run(reqs)}
    sched = make_scheduler(tb, tp, num_slots=8, max_len=max_len,
                           block_size=blk,
                           num_blocks=4 * (max_len // blk) + 1,
                           prefill_chunk=16, dtype=torch.float32,
                           device="cpu")
    slot_bytes = sum(t.numel() * t.element_size()
                     for t in slot.pool.caches["seg0_dense"])
    assert sched.pool_bytes() <= slot_bytes * (1 + 1 / (4 * max_len // blk))
    got = {c.rid: c.tokens for c in sched.run(
        _reqs(Request, 7, 8, lo=4, hi=10, new_lo=4, new_hi=7))}
    assert got == want
    assert sched.stats["max_concurrent"] >= 2 * slot.num_slots
    assert all(c.t_first >= c.t_admit > 0 and c.latency >= c.ttft
               for c in sched.completed)


def test_submit_queues_when_pool_momentarily_full(jax_model, torch_model):
    """A request that fits the pool but not right now queues and
    completes once blocks free up; only can-never-fit requests raise,
    with the reference's messages."""
    (jb, jp), (tb, tp) = jax_model, torch_model
    rng = np.random.default_rng(6)
    sched = paged.PagedScheduler(tb, tp, num_slots=3, max_len=32,
                                 block_size=8, num_blocks=9,
                                 prefill_chunk=8, dtype=torch.float32,
                                 device="cpu", use_radix=False)
    for i in range(2):
        sched.submit(Request(rid=i, tokens=rng.integers(1, V, size=20)
                             .astype(np.int32).tolist(), max_new_tokens=10))
    late = Request(rid=9, tokens=rng.integers(1, V, size=10)
                   .astype(np.int32).tolist(), max_new_tokens=4)
    # drive until both hold their 4th block (pool saturated): a slot
    # stays free but no block does, so the latecomer defers on blocks
    for _ in range(40):
        sched.step()
        if sched.alloc.free_blocks == 0:
            break
    assert sched.alloc.free_blocks == 0
    sched.submit(late)
    while sched.step():
        pass
    assert {c.rid for c in sched.completed} == {0, 1, 9}
    assert sched.stats["admission_blocked"] > 0
    sched.alloc.check()

    small = dict(num_slots=1, max_len=32, block_size=8, num_blocks=3,
                 prefill_chunk=8)
    for big, req in ((dict(small, num_blocks=9), dict(
            rid=10, tokens=[1] * 30, max_new_tokens=10)),
            (small, dict(rid=11, tokens=[1] * 20, max_new_tokens=10))):
        with pytest.raises(ValueError) as want:
            jpaged.PagedScheduler(jb, jp, dtype=jnp.float32, **big).submit(
                JRequest(**req))
        with pytest.raises(ValueError, match="window|never fit") as got:
            paged.PagedScheduler(tb, tp, dtype=torch.float32, device="cpu",
                                 **big).submit(Request(**req))
        assert str(got.value) == str(want.value)


def test_make_scheduler_picks_backend(torch_model):
    tb, tp = torch_model
    assert engine.append_ok(tb)
    kw = dict(num_slots=2, max_len=32, dtype=torch.float32, device="cpu",
              block_size=8, prefill_chunk=8)
    assert type(make_scheduler(tb, tp, **kw)) is paged.PagedScheduler
    assert type(make_scheduler(tb, tp, backend="paged", **kw)) \
        is paged.PagedScheduler
    assert type(make_scheduler(tb, tp, backend="slot", **kw)) is Scheduler
    with pytest.raises(ValueError, match="unknown serving backend"):
        make_scheduler(tb, tp, backend="pages", **kw)
