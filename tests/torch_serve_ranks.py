"""Rank functions of the port's sharded-serving CPU tests
(``test_torch_sharded_serve.py``), started on gloo ranks by
``repro_torch.distributed.spawn.run_ranks``: importable by name in a
fresh process, and importing neither jax nor the JAX package."""
import numpy as np
import torch

import torch_tp_ranks as tr
from repro_torch.distributed import tp
from repro_torch.distributed.comm import mesh_comms
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, model_zoo
from repro_torch.serve import shard
from repro_torch.serve.paged import PagedScheduler
from repro_torch.serve.scheduler import Request, Scheduler

V = 512                  # llama-60m smoke vocabulary
SLOT = dict(num_slots=4, max_len=32, prompt_bucket=8)
PAGED = dict(num_slots=4, max_len=32, block_size=8, num_blocks=18,
             prefill_chunk=8)


def requests(seed: int, vocab: int = V, shared: int = 0) -> list:
    """The reference's sharded-pool traffic (``tests/test_distributed.py``):
    6 prompts of 3-9 tokens, 2-5 new each; with ``shared``, every other
    prompt behind a shared prefix of that many tokens. Plain tuples, so
    both packages' ``Request`` take them."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=shared)
    out = []
    for r in range(6):
        p = rng.integers(1, vocab, size=int(rng.integers(3, 10)))
        if shared and r % 2 == 0:
            p = np.concatenate([prefix, p])
        out.append((r, p.astype(np.int32).tolist(), int(rng.integers(2, 6))))
    return out


def _run(sched, reqs) -> dict:
    return {c.rid: c.tokens for c in sched.run(
        [Request(rid=r, tokens=t, max_new_tokens=n) for r, t, n in reqs])}


def held_attention_check(groups, seed: int = 0) -> dict:
    """``decode_attention`` and ``append_attention`` over a window split
    as the slot pool splits it (rows over data, positions over model),
    against the same calls on the whole window: the largest difference of
    each. Row 0's keys all sit on the first model rank (its length is
    within the first share of positions)."""
    D, t = groups.shape
    B, T, H, KH, dh, C = 4, 32, 4, 2, 16, 4
    g = torch.Generator().manual_seed(seed)
    k, v = (torch.randn((B, T, KH, dh), generator=g) for _ in range(2))
    q1 = torch.randn((B, 1, H, dh), generator=g)
    qc = torch.randn((B, C, H, dh), generator=g)
    length = torch.tensor([T // t - 3, T - 1, 9, 20], dtype=torch.int32)
    R, W = B // D, T // t
    r0, p0 = groups.data.rank * R, groups.model.rank * W
    comm = shard._comm(shard._Split(D > 1, t > 1), groups)
    rows = torch.arange(r0, r0 + R)
    pos = (p0 + torch.arange(W, dtype=torch.int32)).expand(R, W)
    hk = attention.HeldWindow(k[r0:r0 + R, p0:p0 + W].clone(), rows, pos,
                              comm)
    hv = attention.HeldWindow(v[r0:r0 + R, p0:p0 + W].clone(), rows, pos,
                              comm)
    got_d = attention.decode_attention(q1, hk, hv, length)
    want_d = attention.decode_attention(q1, k, v, length)
    positions = (length - C)[:, None] + torch.arange(C, dtype=torch.int32)
    got_a = attention.append_attention(qc, hk, hv, positions)
    want_a = attention.append_attention(qc, k, v, positions)
    return {"decode": float((got_d - want_d).abs().max()),
            "append": float((got_a - want_a).abs().max()),
            "row0_on_one_rank": int(length[0]) <= W}


def moe_bundle():
    """qwen3-moe-30b-a3b's smoke config: the slot scheduler, one
    unpadded request a prefill, decode at the drop-free capacity."""
    return model_zoo.build_arch("qwen3-moe-30b-a3b", smoke=True,
                                device="cpu", dtype=torch.float32)


def serve_mesh(comm, mesh, params, tp_params, tp_reqs, moe_params) -> dict:
    """One rank of a ``mesh``: the held-keys attention check; the sharded
    slot and paged schedulers on llama-60m smoke (f32, the weights
    replicated, ``params`` the whole tree) over the reference's traffic;
    the paged one again at temperature 0.8 from a generator seeded alike
    on every rank; then tensor-parallel serving of the test model of
    ``torch_tp_ranks`` (``tp_params`` whole, cut to the rank's slices)
    through both schedulers, the pool split over data too where D > 1;
    and the MoE's slot pool placed by the rules (``moe_params`` whole)."""
    torch.set_num_threads(1)
    groups = mesh_comms(comm, mesh)
    m = make_mesh(mesh)
    out = {"rank": comm.rank, "held": held_attention_check(groups)}
    b = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                             dtype=torch.float32)
    kw = dict(dtype=torch.float32, device="cpu", group=groups)
    slot = Scheduler(b, params, shardings=shard.pool_sharding(
        b, SLOT["num_slots"], SLOT["max_len"], m, torch.float32),
        **SLOT, **kw)
    out["slot"] = _run(slot, requests(0))
    out["slot_pool"] = [tuple(shard.local_tensor(x).shape)
                        for x in slot.pool.caches["seg0_dense"]]
    pk = shard.paged_pool_sharding(b, PAGED["num_blocks"],
                                   PAGED["block_size"], m, torch.float32)
    paged = PagedScheduler(b, params, shardings=pk, **PAGED, **kw)
    out["paged"] = _run(paged, requests(1, shared=8))
    out["paged_stats"] = dict(paged.stats)
    out["paged_bytes"] = paged.pool_bytes()
    paged.alloc.check()
    hot = PagedScheduler(b, params, shardings=pk, temperature=0.8,
                         generator=torch.Generator().manual_seed(7),
                         **PAGED, **kw)
    out["sampled"] = _run(hot, requests(2, shared=8))
    moe = moe_bundle()
    out["moe_slot"] = _run(Scheduler(
        moe, moe_params, shardings=shard.pool_sharding(
            moe, SLOT["num_slots"], SLOT["max_len"], m, torch.float32),
        **SLOT, **kw), requests(5, vocab=moe.cfg.vocab_size))

    tb = model_zoo.build(tr.config(), device="cpu", dtype=torch.float32,
                         tp_group=groups.model if mesh[1] > 1 else None)
    local = tp.serving_params(tp_params, tr.config(), mesh,
                              groups.model.rank)
    split = {} if mesh[0] == 1 else {"group": groups}
    tslot = Scheduler(tb, local, **SLOT, dtype=torch.float32, device="cpu",
                      shardings=shard.pool_sharding(
                          tb, SLOT["num_slots"], SLOT["max_len"], m,
                          torch.float32) if split else None, **split)
    out["tp_slot"] = _run(tslot, tp_reqs)
    out["tp_cache"] = tuple(shard.local_tensor(
        tslot.pool.caches["seg0_dense"][0]).shape)
    tpaged = PagedScheduler(tb, local, **PAGED, dtype=torch.float32,
                            device="cpu",
                            shardings=shard.paged_pool_sharding(
                                tb, PAGED["num_blocks"], PAGED["block_size"],
                                m, torch.float32) if split else None,
                            **split)
    out["tp_paged"] = _run(tpaged, tp_reqs)
    return out
