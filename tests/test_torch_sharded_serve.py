"""Sharded serving (``repro_torch.serve.shard``'s runtime) on gloo ranks,
on the CPU: the pool split over ranks with the weights replicated, and
tensor-parallel serving.

The reference's own sharded-serving tests fail on the CPU
(``tests/test_distributed.py``: ``test_sharded_decode_runs``,
``test_sharded_cache_pool_continuous_decode``,
``test_sharded_paged_pool_continuous_decode``), so the port is held to
what they assert against yardsticks that pass: on llama-60m smoke at f32,
the sharded slot and paged schedulers on (2, 1), (1, 2) and (2, 2) give
the reference's unsharded ``Scheduler``'s and ``PagedScheduler``'s tokens,
run live on the same INT8 codes, and the paged one hits the radix cache.
Also: the held-keys attention against the whole window's (1e-6), the
MoE's placed slot pool and a tensor-parallel bundle against the one
process's tokens (the latter with its cache on the rank's kv heads),
sampling alike on every rank, and each refusal by name."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_serve_ranks as sr
import torch_tp_ranks as tr
from repro.config import QGaLoreConfig
from repro.models import model_zoo as jzoo
from repro.serve.paged import PagedScheduler as JPaged
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.train import step as jstep
from repro_torch.distributed.comm import MeshComms
from repro_torch.distributed.spawn import run_ranks
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model_zoo
from repro_torch.serve import engine, shard
from repro_torch.serve.paged import PagedScheduler
from repro_torch.serve.params import from_jax_params, quantize_leaf
from repro_torch.serve.scheduler import Scheduler
from test_torch_serve import _to_numpy
from torch_one_thread import one_thread  # noqa: F401

MESHES = [(2, 1), (1, 2), (2, 2)]
HELD_TOL = 1e-6


def _jrun(sched, reqs):
    return {c.rid: c.tokens for c in sched.run(
        [JRequest(rid=r, tokens=t, max_new_tokens=n) for r, t, n in reqs])}


@pytest.fixture(scope="module")
def served():
    """The reference's unsharded tokens, live, on its INT8 codes; the
    port's tensor-parallel test model drawn whole and its one-process
    tokens; every mesh's ranks."""
    jb = jzoo.build_arch("llama-60m", smoke=True, dtype=jnp.float32)
    jp = jstep.prepare_params(jb.init_params(jax.random.PRNGKey(0)),
                              QGaLoreConfig(), jnp.float32)
    want = {
        "slot": _jrun(JScheduler(jb, jp, dtype=jnp.float32, **sr.SLOT),
                      sr.requests(0)),
        "paged": _jrun(JPaged(jb, jp, dtype=jnp.float32, **sr.PAGED),
                       sr.requests(1, shared=8))}
    params = from_jax_params(_to_numpy(jp), device="cpu")
    tb = model_zoo.build(tr.config(), device="cpu", dtype=torch.float32)
    tp_params = tb.init_params(torch.Generator().manual_seed(0),
                               leaf_fn=lambda _, t: quantize_leaf(t))
    tp_reqs = sr.requests(3, vocab=tr.config().vocab_size, shared=8)
    kw = dict(dtype=torch.float32, device="cpu")
    want["tp_slot"] = sr._run(Scheduler(tb, tp_params, **sr.SLOT, **kw),
                              tp_reqs)
    want["tp_paged"] = sr._run(PagedScheduler(tb, tp_params, **sr.PAGED,
                                              **kw), tp_reqs)
    moe = sr.moe_bundle()
    moe_params = moe.init_params(torch.Generator().manual_seed(1),
                                 leaf_fn=lambda _, t: quantize_leaf(t))
    want["moe_slot"] = sr._run(Scheduler(moe, moe_params, **sr.SLOT, **kw),
                               sr.requests(5, vocab=moe.cfg.vocab_size))
    ranks = {mesh: run_ranks(sr.serve_mesh, mesh[0] * mesh[1], mesh, params,
                             tp_params, tp_reqs, moe_params)
             for mesh in MESHES}
    return want, ranks, params


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_schedulers_give_the_reference_unsharded_tokens(served,
                                                                mesh):
    """Every rank emits the reference's unsharded tokens through the slot
    and the paged scheduler, the paged one with radix hits; each rank
    holds its share of the pool (the slots or blocks over data, KV time
    over model)."""
    want, ranks, _ = served
    D, t = mesh
    for r in ranks[mesh]:
        assert r["slot"] == want["slot"], (mesh, r["rank"])
        assert r["paged"] == want["paged"], (mesh, r["rank"])
        assert r["paged_stats"]["radix_hit_blocks"] > 0
        assert r["slot_pool"] == [(2, 4 // D, 32 // t, 4, 16)] * 2
        whole = 2 * 2 * 18 * 8 * 4 * 16 * 4
        assert r["paged_bytes"] == whole // (D * t)


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_moe_slot_pool_gives_the_one_process_tokens(served, mesh):
    """The MoE (a bundle of K/V windows too) through the slot scheduler
    with its pool placed by the rules: the one process's tokens."""
    for r in served[1][mesh]:
        assert r["moe_slot"] == served[0]["moe_slot"], (mesh, r["rank"])


@pytest.mark.parametrize("mesh", MESHES)
def test_held_keys_attention_against_the_whole_window(served, mesh):
    """``decode_attention`` and ``append_attention`` over a window split
    among the ranks give the whole window's within 1e-6; row 0's keys sit
    on one rank, the others add exactly zero to it."""
    for r in served[1][mesh]:
        h = r["held"]
        assert h["row0_on_one_rank"]
        assert h["decode"] <= HELD_TOL and h["append"] <= HELD_TOL, h


@pytest.mark.parametrize("mesh", MESHES)
def test_sampling_alike_on_every_rank(served, mesh):
    """At temperature 0.8 from generators seeded alike, every rank draws
    the same tokens (the same logits on every rank)."""
    runs = [r["sampled"] for r in served[1][mesh]]
    assert all(x == runs[0] for x in runs) and len(runs[0]) == 6


@pytest.mark.parametrize("mesh", MESHES)
def test_tensor_parallel_serving_gives_the_one_process_tokens(served, mesh):
    """The test model of the tensor-parallel tests (its attention splits
    at t = 2) served on the rank's heads: the one process's tokens through
    both schedulers, the cache holding the rank's kv heads and, where D >
    1, its share of the slots."""
    want = served[0]
    D, t = mesh
    KH = tr.config().num_kv_heads
    for r in served[1][mesh]:
        assert r["tp_slot"] == want["tp_slot"], (mesh, r["rank"])
        assert r["tp_paged"] == want["tp_paged"], (mesh, r["rank"])
        assert r["tp_cache"] == (tr.config().num_layers, 4 // D, 32,
                                 KH // t, tr.config().resolved_head_dim)


def _one_rank():
    """The (1, 1) mesh's groups: nothing splits, so no collective runs."""
    one = SimpleNamespace(rank=0, world=1)
    return MeshComms(one, one, one, (1, 1))


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_one_rank_placement_is_the_unsharded_run(served, backend):
    """A placed pool on the (1, 1) mesh runs the held-keys path with
    nothing split, and gives the unsharded scheduler's tokens."""
    params = served[2]
    b = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                             dtype=torch.float32)
    m = make_mesh((1, 1))
    kw = dict(dtype=torch.float32, device="cpu")
    if backend == "slot":
        sh = shard.pool_sharding(b, 4, 32, m, torch.float32)
        placed = Scheduler(b, params, **sr.SLOT, **kw, shardings=sh,
                           group=_one_rank())
        plain = Scheduler(b, params, **sr.SLOT, **kw)
        assert isinstance(placed.pool.caches["seg0_dense"][0],
                          shard.SlotLeaf)
    else:
        sh = shard.paged_pool_sharding(b, 18, 8, m, torch.float32)
        placed = PagedScheduler(b, params, **sr.PAGED, **kw, shardings=sh,
                                group=_one_rank())
        plain = PagedScheduler(b, params, **sr.PAGED, **kw)
    reqs = sr.requests(4, shared=8)
    assert sr._run(placed, reqs) == sr._run(plain, reqs)


def test_engine_decodes_a_placed_state(served):
    """The counterpart of ``test_sharded_decode_runs``: a prefill's state
    placed by ``decode_state_sharding``'s partitions decodes through
    ``engine.build_decode`` (and appends through ``build_append``) to the
    whole state's logits."""
    params = served[2]
    b = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                             dtype=torch.float32)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        1, sr.V, size=(4, 8)).astype(np.int32))
    _, state = engine.build_prefill(b, 32)(params, {"tokens": toks})
    parts = shard.decode_state_sharding(
        engine.abstract_decode_state(b, 4, 32, torch.float32), make_mesh(
            (1, 1)))
    placed = shard.place_state(b, state, parts, _one_rank())
    decode = engine.build_decode(b)
    step = torch.ones((4, 1), dtype=torch.int32)
    want, _ = decode(params, state, step)
    got, placed = decode(params, placed, step)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    chunk = torch.full((4, 3), 7, dtype=torch.int32)
    n = torch.tensor([3, 1, 2, 3], dtype=torch.int32)
    append = engine.build_append(b, 32)
    want, _ = append(params, state._replace(lengths=state.lengths + 1),
                     chunk, n)
    got, _ = append(params, placed, chunk, n)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


REFUSED = [("deepseek-v3-671b", "MLA latents"),
           ("xlstm-125m", "recurrent states"),
           ("zamba2-2.7b", "recurrent states"),
           ("seamless-m4t-medium", "encoder-decoder's extras")]


@pytest.mark.parametrize("arch,why", REFUSED, ids=[a for a, _ in REFUSED])
def test_families_without_kv_windows_are_refused_by_name(arch, why):
    b = model_zoo.build_arch(arch, smoke=True, device="cpu",
                             dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=why + ".*5c follow-up"):
        Scheduler(b, {}, num_slots=4, max_len=32, device="cpu",
                  shardings={}, group=_one_rank())
    with pytest.raises(NotImplementedError, match="5c follow-up"):
        shard.check_bundle(b)


def test_unhandled_placements_are_refused_by_name():
    """Model on another dim than KV time, a pod axis, an expert-parallel
    bundle, and a tensor-parallel unit's cache with model off its heads:
    each raises naming the follow-up, never serves unsharded."""
    b = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                             dtype=torch.float32)
    groups = MeshComms(*(SimpleNamespace(rank=0, world=2),) * 3, (1, 2))
    for part, what in (((None, None, None, None, "model"), "dim 4"),
                       ((None, None, None, "model", None), "kv heads"),
                       (("model",), "dim 0"),
                       ((None, ("pod", "data")), "axes")):
        with pytest.raises(NotImplementedError, match=f"{what}.*5c follow"):
            Scheduler(b, {}, num_slots=4, max_len=32, device="cpu",
                      shardings={"seg0_dense": (part, part)}, group=groups)
    moe = model_zoo.get_config("qwen3-moe-30b-a3b", smoke=True)
    ep = model_zoo.build(moe, device="cpu", dtype=torch.float32,
                         ep_group=SimpleNamespace(world=2))
    with pytest.raises(NotImplementedError, match="expert-parallel.*5c"):
        shard.check_bundle(ep)
    with pytest.raises(NotImplementedError, match="ep_group trains only.*"
                       "5c follow-up"):
        ep.segments[0].prefill(None, None, None)
    tb = model_zoo.build(tr.config(), device="cpu", dtype=torch.float32,
                         tp_group=SimpleNamespace(world=2))
    time_on_model = shard.pool_sharding(
        model_zoo.build(tr.config(), device="cpu", dtype=torch.float32), 4,
        32, make_mesh((1, 2)))
    with pytest.raises(NotImplementedError, match="kv heads.*5c follow-up"):
        Scheduler(tb, {}, num_slots=4, max_len=32, device="cpu",
                  shardings=time_on_model, group=groups)
    with pytest.raises(ValueError, match="groups"):
        Scheduler(b, {}, num_slots=4, max_len=32, device="cpu",
                  shardings=shard.pool_sharding(b, 4, 32, make_mesh((1, 2))))
