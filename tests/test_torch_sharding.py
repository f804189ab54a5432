"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``) on device-free meshes
(``jax.sharding.AbstractMesh``): every parameter and optimizer-state leaf
of all fifteen architectures at full size, on five meshes, with and
without ZeRO."""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.config import QGaLoreConfig as JQGaLoreConfig
from repro.config import ShapeCell as JShapeCell
from repro.core import adam8bit as jadam
from repro.core import optimizers as jopt
from repro.core import qgalore as jqg
from repro.core import quant as jq
from repro.data import synthetic as jsyn
from repro.distributed import sharding as jsh
from repro.models import model_zoo as jzoo
from repro.train import step as jstep
from repro_torch.config import QGaLoreConfig
from repro_torch.core import qgalore
from repro_torch.core.optimizers import preset
from repro_torch.distributed import sharding as sh
from repro_torch.models import model_zoo
from repro_torch.train import step
from torch_one_thread import one_thread  # noqa: F401

MESHES = [(2, 1), (4, 1), (8, 1), (2, 4), (16, 16)]
AXES = ("data", "model")
BATCHES = (1, 6, 8, 16, 256)


def _spec(ns, ndim):
    """A reference NamedSharding as the port's partition tuple."""
    parts = tuple(ns.spec)
    return parts + (None,) * (ndim - len(parts))


def _pad(part, ndim):
    return tuple(part) + (None,) * (ndim - len(part))


def _leaf_parts(ref, port, shape_of):
    """[(ref partition, port partition)] of one leaf (QTensor-aware)."""
    if ref is None or port is None:
        assert ref is None and port is None
        return []
    if isinstance(ref, jq.QTensor):
        assert isinstance(port, sh.QSpec)
        nd = shape_of
        out = [(_spec(ref.q, nd[0]), _pad(port.q, nd[0])),
               (_spec(ref.scale, nd[1]), _pad(port.scale, nd[1]))]
        assert (ref.zero is None) == (port.zero is None)
        if ref.zero is not None:
            out.append((_spec(ref.zero, nd[1]), _pad(port.zero, nd[1])))
        return out
    return [(_spec(ref, shape_of), _pad(port, shape_of))]


def _ndims(leaf):
    if isinstance(leaf, qgalore.QTensor):
        return (leaf.q.ndim, leaf.scale.ndim)
    return leaf.ndim


@pytest.mark.parametrize("arch", model_zoo.ARCH_IDS)
def test_rules_match_reference(arch):
    jcfg = jopt.preset("qgalore", JQGaLoreConfig(rank=128))
    tcfg = preset("qgalore", QGaLoreConfig(rank=128))
    jb = jzoo.build_arch(arch, smoke=False, dtype=jnp.bfloat16)
    jst = jstep.abstract_state(jb, jcfg, jnp.bfloat16)
    jspecs = jqg.leaf_specs(jst.params, jcfg)
    tb = model_zoo.build_arch(arch, smoke=False, device="meta",
                              dtype=torch.bfloat16)
    tst = step.abstract_state(tb, tcfg, torch.bfloat16)
    tspecs = qgalore.leaf_specs(tst.params, tcfg)
    assert [s.path for s in tspecs] == [s.path for s in jspecs]
    tflat = [leaf for _, leaf in qgalore.flatten(tst.params)]
    jflat = jax.tree_util.tree_flatten_with_path(
        jst.params, is_leaf=lambda x: isinstance(x, jq.QTensor))[0]

    # logical axes per parameter leaf (mesh-free)
    for (path, jleaf), tleaf in zip(jflat, tflat):
        p = jsh.norm_path(path)
        assert sh._norm_path_str(jax.tree_util.keystr(path)) == p
        assert sh.logical_axes(p, len(tleaf.shape)) == \
            jsh.logical_axes(p, len(jleaf.shape)), p

    batch_abs = {b: jax.eval_shape(lambda b=b: jsyn.batch_for_bundle(
        jb, JShapeCell("t", 256, b, "train"), 0)) for b in BATCHES}
    checked = 0
    for shape in MESHES:
        jmesh = AbstractMesh(shape, AXES)
        tmesh = sh.Mesh(shape, AXES)
        # parameters: spec_for through param_sharding, QTensor-aware
        jp = jax.tree_util.tree_leaves(
            jsh.param_sharding(jst.params, jmesh),
            is_leaf=lambda x: isinstance(x, jq.QTensor))
        tp = [leaf for _, leaf in qgalore.flatten(
            sh.param_sharding(tst.params, tmesh))]
        assert len(jp) == len(tp) == len(tflat)
        for r, t, leaf in zip(jp, tp, tflat):
            for a, b in _leaf_parts(r, t, _ndims(leaf)):
                assert a == b, (arch, shape)
                checked += 1
        # TP annotation
        for a, b in zip(jsh.annotate_tp(jspecs, jmesh),
                        sh.annotate_tp(tspecs, tmesh)):
            assert (a.shard_dim, a.tp) == (b.shard_dim, b.tp), (arch, a.path)
        for zero in ((), ("data",)):
            jo = jsh.opt_state_sharding(jst.params, jst.opt, jcfg, jmesh,
                                        zero_axes=zero, specs=jspecs)
            to = sh.opt_state_sharding(tst.params, tst.opt, tcfg, tmesh,
                                       zero_axes=zero, specs=tspecs)
            ji = jax.tree_util.tree_flatten(
                jo.inner, is_leaf=jqg._is_inner_leaf)[0]
            jpr = jax.tree_util.tree_flatten(
                jo.proj, is_leaf=lambda x: isinstance(x, jq.QTensor)
                or x is None)[0]
            for idx, spec in enumerate(tspecs):
                inner = tst.opt.inner[idx]
                if ji[idx] is None:
                    assert to.inner[idx] is None
                else:
                    assert isinstance(ji[idx], jadam.Adam8bitState)
                    for f in ("m", "v"):
                        for a, b in _leaf_parts(
                                getattr(ji[idx], f), getattr(to.inner[idx], f),
                                _ndims(getattr(inner, f))):
                            assert a == b, (arch, shape, zero, spec.path, f)
                            checked += 1
                P = tst.opt.proj[idx]
                for a, b in _leaf_parts(jpr[idx], to.proj[idx],
                                        None if P is None else _ndims(P)):
                    assert a == b, (arch, shape, zero, spec.path, "proj")
                    checked += 1
            assert sh.zero2_scatter_dims(to, tspecs, zero) == \
                jsh.zero2_scatter_dims(jo, jspecs, zero), (arch, shape, zero)
            jl = jsh.lowrank_shardings(jspecs, jmesh, zero)
            tl = sh.lowrank_shardings(tspecs, tmesh, zero)
            assert set(jl) == set(tl)
            for k in jl:
                nd = len(next(s for s in tspecs if s.path == k).low_shape)
                assert _spec(jl[k], nd) == _pad(tl[k], nd), (arch, k)
        assert sh.zero_axes_for(tmesh) == jsh.zero_axes_for(jmesh)
        for b, babs in batch_abs.items():
            jd = jsh.data_sharding(babs, jmesh)
            td = sh.data_sharding({k: v.shape for k, v in babs.items()},
                                  tmesh)
            for k in babs:
                nd = len(babs[k].shape)
                assert _spec(jd[k], nd) == _pad(td[k], nd), (arch, b, k)
    assert checked > 0


def test_meshes_of_the_port():
    """Data and tensor parallelism: ``(D, t)`` meshes; a tensor-parallel
    degree that does not divide the devices is refused, as the
    reference's ``make_tp_mesh`` refuses it."""
    from repro_torch.launch import mesh
    m = mesh.make_dp_mesh(4)
    assert m.axis_names == AXES and m.shape == {"data": 4, "model": 1}
    assert mesh.parse_mesh("2x1").shape == {"data": 2, "model": 1}
    assert mesh.parse_mesh("2x2").shape == {"data": 2, "model": 2}
    assert mesh.make_mesh((1, 2)).shape == {"data": 1, "model": 2}
    assert mesh.make_tp_mesh(2, 8).shape == {"data": 4, "model": 2}
    assert mesh.make_tp_mesh(2).shape == {"data": 1, "model": 2}
    for bad in (lambda: mesh.make_tp_mesh(3, 4),
                lambda: mesh.make_tp_mesh(0, 4)):
        with pytest.raises(ValueError, match="positive divisor"):
            bad()
    with pytest.raises(ValueError, match="DxM"):
        mesh.parse_mesh("4")


@pytest.mark.parametrize("backend", ["slot", "paged"])
def test_sharded_serving_refused(backend):
    """Sharded serving is ported (``serve/shard.py``): a scheduler given
    the rules' partitions and the mesh's groups builds, holds a placed
    pool and serves, here on the (1, 1) mesh, where nothing splits and the
    tokens are the unsharded scheduler's. Multi-rank runs:
    ``tests/test_torch_sharded_serve.py``."""
    from types import SimpleNamespace

    from repro_torch.distributed.comm import MeshComms
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import shard
    from repro_torch.serve.scheduler import Request, make_scheduler
    bundle = model_zoo.build_arch("llama-60m", smoke=True, device="cpu",
                                  dtype=torch.float32)
    params = bundle.init_params(torch.Generator().manual_seed(0))
    mesh = make_mesh((1, 1))
    one = SimpleNamespace(rank=0, world=1)
    parts = shard.pool_sharding(bundle, 2, 32, mesh, torch.float32) \
        if backend == "slot" else \
        shard.paged_pool_sharding(bundle, 9, 8, mesh, torch.float32)
    kw = dict(backend=backend, num_slots=2, max_len=32, block_size=8,
              prefill_chunk=8, dtype=torch.float32, device="cpu")
    sched = make_scheduler(bundle, params, shardings=parts,
                           group=MeshComms(one, one, one, (1, 1)), **kw)
    plain = make_scheduler(bundle, params, **kw)
    leaf = (sched.pool.caches if backend == "slot" else
            sched.caches)["seg0_dense"][0]
    assert isinstance(leaf, (shard.SlotLeaf, shard.PagedLeaf))
    reqs = [Request(rid=i, tokens=[3 + i, 5, 7, 11][: 2 + i],
                    max_new_tokens=3) for i in range(3)]
    got = {c.rid: c.tokens for c in sched.run(reqs)}
    assert got == {c.rid: c.tokens for c in plain.run(reqs)}
    assert all(len(t) == 3 for t in got.values())
