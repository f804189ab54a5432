"""The dry run's counterpart (``repro_torch.launch.dryrun``) on the CPU,
without a device: the artifact's fields, each rank's argument bytes
against the sum of the shard shapes of the reference's partitions
(``repro.distributed.sharding`` and ``repro.serve.shard`` on
``jax.sharding.AbstractMesh``, the JAX package's abstract states), the
analytic FLOPs a chip against the reference's ``analytic``, and the
readers (``roofline.from_artifact`` / ``table``,
``report.dryrun_table``)."""
import json
import math

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh, NamedSharding

from repro.analysis import analytic as janalytic
from repro.config import cells_for_arch as jcells
from repro.distributed import sharding as jsh
from repro.launch.dryrun import QCFG as JQCFG
from repro.models import model_zoo as jzoo
from repro.serve import engine as jengine
from repro.serve import shard as jshard
from repro.train import step as jstep
from repro_torch.analysis import report, roofline
from repro_torch.launch import dryrun
from torch_one_thread import one_thread  # noqa: F401

CASES = [("llama-1b", "decode_32k", "16x16"),
         ("llama-1b", "train_4k", "16x16"),
         ("yi-9b", "prefill_32k", "16x16"),
         ("seamless-m4t-medium", "decode_32k", "2x16x16"),
         ("qwen3-moe-30b-a3b", "train_4k", "2x16x16"),
         ("zamba2-2.7b", "long_500k", "2x4")]
KEYS = {"arch", "cell", "mesh", "kind", "refresh", "compress", "params",
        "active_params", "model_flops", "chips", "ok", "memory_analysis",
        "cost_analysis"}


def _jmesh(name):
    if name in dryrun.PRODUCTION:
        return AbstractMesh(*dryrun.PRODUCTION[name])
    return AbstractMesh(tuple(int(x) for x in name.split("x")),
                        ("data", "model"))


def _rank_bytes(tree, shardings):
    """Bytes of one rank's shards of every array of ``tree``."""
    arrays = jax.tree_util.tree_leaves(tree)
    parts = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(arrays) == len(parts)
    return sum(math.prod(ns.shard_shape(tuple(a.shape))) * a.dtype.itemsize
               for a, ns in zip(arrays, parts))


def _reference_argument_bytes(arch, cell_name, mesh_name):
    jm = _jmesh(mesh_name)
    jb = jzoo.build_arch(arch, dtype=jnp.bfloat16)
    cell = next(c for c in jcells(arch) if c.name == cell_name)
    batch = jb.input_specs(cell)
    if cell.kind == "train":
        st = jstep.abstract_state(jb, JQCFG, jnp.bfloat16)
        o = jsh.opt_state_sharding(st.params, st.opt, JQCFG, jm)
        # the step count lives on the port's host, not among its arrays
        return (_rank_bytes(st.params, jsh.param_sharding(st.params, jm))
                + _rank_bytes((st.opt.inner, st.opt.proj),
                              (o.inner, o.proj))
                + _rank_bytes(batch, jsh.data_sharding(batch, jm)))
    params = jax.eval_shape(lambda k: jstep.prepare_params(
        jb.init_params(k), JQCFG), jax.random.PRNGKey(0))
    total = _rank_bytes(params, jsh.param_sharding(params, jm))
    if cell.kind == "prefill":
        return total + _rank_bytes(batch, jsh.data_sharding(batch, jm))
    st = jengine.abstract_decode_state(jb, cell.global_batch, cell.seq_len,
                                       jnp.bfloat16)
    tok = {"t": jax.ShapeDtypeStruct((cell.global_batch, 1), jnp.int32)}
    return (total + _rank_bytes(st, jshard.decode_state_sharding(st, jm))
            + _rank_bytes(tok, jsh.data_sharding(tok, jm)))


@pytest.mark.parametrize("arch,cell,mesh", CASES,
                         ids=["-".join(c) for c in CASES])
def test_artifact_against_the_reference_partitions(tmp_path, arch, cell,
                                                   mesh):
    assert dryrun.main(["--arch", arch, "--cell", cell, "--mesh", mesh,
                        "--out", str(tmp_path)]) == 0
    art = json.loads((tmp_path / mesh / f"{arch}__{cell}.json").read_text())
    assert KEYS <= set(art) and art["ok"]
    assert not {"compile_s", "hlo_ops", "hlo_chars"} & set(art)
    assert art["memory_analysis"]["argument_size_in_bytes"] == \
        _reference_argument_bytes(arch, cell, mesh)
    jcfg = jzoo.get_config(arch)
    jcell = next(c for c in jcells(arch) if c.name == cell)
    chips = math.prod(_jmesh(mesh).axis_sizes)
    assert art["chips"] == chips
    assert art["params"] == jzoo.count_params_analytic(jcfg)
    assert art["active_params"] == jzoo.count_active_params(jcfg)
    assert art["cost_analysis"]["flops"] == pytest.approx(
        janalytic.cell_flops(jcfg, jcell) / chips, rel=1e-12)
    tokens = jcell.global_batch * (jcell.seq_len if jcell.kind != "decode"
                                   else 1)
    assert art["model_flops"] == (6.0 if jcell.kind == "train" else 2.0) \
        * art["active_params"] * tokens
    if jcell.kind == "train":
        coll = art["collectives"]
        assert coll["analytic"] and coll["total"]["bytes"] > 0
    r = roofline.from_artifact(art)
    assert r.bound_s > 0 and r.dominant in ("compute", "memory",
                                            "collective")
    assert r.mfu == 0.0 and r.share == 0.0          # nothing measured
    rendered = report.dryrun_table(str(tmp_path / mesh))
    assert f"| {arch}__{cell} | {jcell.kind} |" in rendered
    assert rendered.endswith("| ok |")
    assert f"| {arch}__{cell} |" in roofline.table(str(tmp_path / mesh))


def test_compressed_train_payload_and_refusals(tmp_path):
    """``--compress``: the data group's payload is the low-rank one (below
    the full-rank gradients); a family the port does not split over the
    model axis records the refusal instead of a number; a failed cell is
    written with ``ok: False`` and rendered as failed."""
    full = dryrun.run_cell("yi-9b", "train_4k", "16x16")
    low = dryrun.run_cell("yi-9b", "train_4k", "16x16", compress=True)
    assert 0 < low["collectives"]["data"]["all-reduce"] < \
        full["collectives"]["data"]["all-reduce"]
    assert low["collectives"]["model"]["bytes"] > 0
    moe = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", "16x16")
    assert moe["collectives"]["model"]["bytes"] is None
    assert "5b follow-up" in moe["collectives"]["model"]["refused"]
    with pytest.raises(StopIteration):
        dryrun.run_and_write("llama-1b", "long_500k", "16x16", False,
                             str(tmp_path))
    bad = json.loads((tmp_path / "16x16" / "llama-1b__long_500k.json")
                     .read_text())
    assert bad["ok"] is False and roofline.from_artifact(bad) is None
    assert "FAILED" in report.dryrun_table(str(tmp_path / "16x16"))
