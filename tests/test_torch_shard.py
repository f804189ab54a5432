"""The port's serving-state rules (``repro_torch.serve.shard``) against the
JAX package's (``repro.serve.shard``) on device-free meshes
(``jax.sharding.AbstractMesh``): every cache leaf (and the
encoder-decoder's ``memory`` extra) of all fifteen architectures at full
size, as a decode state at the decode cells' sizes, as a slot pool and as
a block pool, on six meshes, the 2 x 16 x 16 pod mesh among them."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config import cells_for_arch as jcells
from repro.models import model_zoo as jzoo
from repro.serve import engine as jengine
from repro.serve import shard as jshard
from repro_torch.distributed import sharding as sh
from repro_torch.models import model_zoo
from repro_torch.serve import engine, shard
from torch_one_thread import one_thread  # noqa: F401

MESHES = [((1, 2), ("data", "model")), ((2, 1), ("data", "model")),
          ((2, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
# (slots, window) of the slot pool and (blocks, block size) of the paged
# one: the scheduler's sizes in the tests and on the card, a divisible
# block count and the default's odd one (num_slots * MB + 1)
SLOT_POOLS = [(4, 32), (4, 528), (8, 576), (16, 4096)]
BLOCK_POOLS = [(18, 8), (132, 16), (133, 16), (256, 16), (1024, 64)]


def _parts(tree_ns, leaves):
    """A reference sharding tree's specs as padded partition tuples, in
    leaf order."""
    flat = jax.tree_util.tree_leaves(tree_ns)
    assert len(flat) == len(leaves)
    return [tuple(ns.spec) + (None,) * (len(leaf.shape) - len(ns.spec))
            for ns, leaf in zip(flat, leaves)]


def _pad(part, ndim):
    return tuple(part) + (None,) * (ndim - len(part))


def _port_leaves(caches):
    return [leaf for key in caches for leaf in caches[key]]


@pytest.mark.parametrize("arch", model_zoo.ARCH_IDS)
def test_partitions_match_reference(arch):
    jb = jzoo.build_arch(arch, smoke=False, dtype=jnp.bfloat16)
    tb = model_zoo.build_arch(arch, smoke=False, device="meta",
                              dtype=torch.bfloat16)
    decode_sizes = [(c.global_batch, c.seq_len) for c in jcells(arch)
                    if c.kind == "decode"]
    checked = 0
    for B, T in decode_sizes + SLOT_POOLS:
        jst = jengine.abstract_decode_state(jb, B, T, jnp.bfloat16)
        tst = engine.abstract_decode_state(tb, B, T, torch.bfloat16)
        # the layout itself: the same leaves, shapes and dtypes in order
        jl = jax.tree_util.tree_leaves(jst.caches)
        tl = _port_leaves(tst.caches)
        assert [tuple(x.shape) for x in jl] == [tuple(x.shape) for x in tl]
        assert [str(x.dtype) for x in jl] == \
            [str(x.dtype).replace("torch.", "") for x in tl]
        assert all(x.is_meta for x in tl)
        assert set(jst.extras) == set(tst.extras)
        for k in jst.extras:
            assert tuple(jst.extras[k].shape) == tuple(tst.extras[k].shape)
        for shape, axes in MESHES:
            jm, tm = AbstractMesh(shape, axes), sh.Mesh(shape, axes)
            jsd = jshard.decode_state_sharding(jst, jm)
            tsd = shard.decode_state_sharding(tst, tm)
            want = _parts(jsd.caches, jl)
            got = [_pad(p, len(x.shape))
                   for p, x in zip(_port_leaves(tsd.caches), tl)]
            assert got == want, (arch, B, T, shape)
            assert tuple(jsd.lengths.spec) == tsd.lengths == ()
            for k, v in tst.extras.items():
                assert _pad(tsd.extras[k], v.ndim) == _parts(
                    jsd.extras[k], [v])[0], (arch, k, shape)
            if (B, T) in SLOT_POOLS:
                jp = jshard.pool_sharding(jb, B, T, jm)
                tp = shard.pool_sharding(tb, B, T, tm)
                assert [_pad(p, len(x.shape)) for p, x in
                        zip(_port_leaves(tp.caches), tl)] == \
                    _parts(jp.caches, jl), (arch, B, T, shape)
            checked += len(tl)
    for NB, blk in BLOCK_POOLS:
        tl = _port_leaves(engine.abstract_decode_state(
            tb, NB, blk, torch.bfloat16).caches)
        for shape, axes in MESHES:
            jp = jshard.paged_pool_sharding(jb, NB, blk,
                                            AbstractMesh(shape, axes))
            tp = shard.paged_pool_sharding(tb, NB, blk,
                                           sh.Mesh(shape, axes))
            assert [_pad(p, len(x.shape)) for p, x in
                    zip(_port_leaves(tp), tl)] == _parts(jp, tl), \
                (arch, NB, blk, shape)
            checked += len(tl)
    assert checked > 0


def test_leaf_spec_picks_the_later_dim_on_a_tie():
    """The heuristic's tie-break and its batch rule, leaf for leaf against
    the reference's ``_leaf_spec``: equal dims take the later one, a batch
    of 1 is never split, a batch the data axes do not divide stays whole,
    and ``batch_dim=0`` (the extras)."""
    cases = [(2, 4, 16, 4, 16), (24, 1, 64, 8, 128), (24, 3, 64, 8, 128),
             (2, 8, 8, 8, 8), (4, 16, 1024), (8, 6, 6)]
    for shape, axes in MESHES:
        jm, tm = AbstractMesh(shape, axes), sh.Mesh(shape, axes)
        for leaf in cases:
            for bd in (0, 1):
                want = jshard._leaf_spec(leaf, jm, batch_dim=bd)
                got = shard.leaf_spec(leaf, tm, batch_dim=bd)
                assert _pad(got, len(leaf)) == \
                    tuple(want) + (None,) * (len(leaf) - len(want)), \
                    (leaf, bd, shape)


def test_tensor_parallel_pool_puts_model_on_kv_heads():
    """The recorded deviation: a ``tp_group`` bundle's split attention
    unit caches the rank's kv heads, so the model axis is on dim 3 there
    (the slot or block axis still over data); an unsplit unit keeps the
    reference's rule (KV time on model)."""
    from types import SimpleNamespace
    tm = sh.Mesh((2, 2), ("data", "model"))
    group = SimpleNamespace(world=2)
    nemo = model_zoo.build_arch("mistral-nemo-12b", device="meta",
                                dtype=torch.bfloat16, tp_group=group)
    kv = engine.abstract_decode_state(nemo, 4, 528).caches["seg0_dense"]
    assert tuple(kv[0].shape) == (40, 4, 528, 4, 128)
    assert shard.pool_sharding(nemo, 4, 528, tm).caches["seg0_dense"] == \
        ((None, "data", None, "model", None),) * 2
    assert shard.paged_pool_sharding(nemo, 132, 16, tm)["seg0_dense"] == \
        ((None, "data", None, "model", None),) * 2
    # llama-60m's smoke attention (64 columns) does not split at t = 2
    small = model_zoo.build_arch("llama-60m", smoke=True, device="meta",
                                 dtype=torch.float32, tp_group=group)
    assert shard.pool_sharding(small, 4, 32, tm).caches["seg0_dense"] == \
        ((None, "data", "model", None, None),) * 2
