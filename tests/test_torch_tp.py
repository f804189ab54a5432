"""The port's tensor parallelism (``distributed/tp.py``, the TP shard
helpers of ``core/projector.py``, the trainer on a ``(D, t)`` mesh) on
gloo ranks on the CPU.

* The projector's shard helpers against the reference's on the same
  numpy inputs (the counterpart of ``tests/test_tp.py``'s
  ``test_projection_shard_reassemble_and_project`` and
  ``test_tp_sharded_subspace_collectives``): a shard of the INT4 P is
  bit-exact against the reference's shard and against quantizing the
  float slice; ``sharded_subspace`` spans the reference's subspace.
* The whole-block rule on llama-1b's smoke and full shapes.
* Two ranks on a ``(1, 2)`` mesh, float32, a model whose slices hold whole
  blocks (d 512, 4 heads x 128, d_ff 1024, vocab 1024, 4 layers), held
  against the live reference's one-device run on the same init, batches
  and SR draws (``tests/torch_tp_reference.py``, a process of its own):
  one refresh then two steady steps, losses within 1e-3, the
  similarities within 1e-3, under 2% of the INT4 P codes differing, and
  the GaLore weights' codes as ``test_torch_dp.py`` holds them. The
  full-rank Adam leaves (the embedding, the norm scales) differ in more
  entries, as the one-process port's do on the same inputs: Adam turns a
  gradient entry near zero into a full step of the sign its rounding
  gives it. The model group's bytes of a steady step equal
  ``qgalore.tp_payload_bytes``.
* The trainer on ``(1, 2)``, and four ranks on ``(2, 2)`` with ZeRO-2,
  against one process (1e-3); a ``(1, 2)`` checkpoint restored into one
  process and into ``(2, 1)``: the next loss within 1e-6.
* The families tensor parallelism does not cover refuse by name.
* ``step.abstract_params`` (shapes alone) lays out what the meta-device
  draw did; ``step.init_state(cut=)`` (a rank's slices or experts, cut
  leaf by leaf as they are drawn) equals cutting the whole init.
"""
import os
import pickle
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_ranks as tr
from test_torch_dp import _flat
from repro.core import projector as jproj
from repro_torch.config import QGaLoreConfig
from repro_torch.core import projector, qgalore, quant
from repro_torch.distributed import tp
from repro_torch.distributed.spawn import run_ranks
from repro_torch.models import model_zoo
from repro_torch.serve.params import quantize_leaf
from repro_torch.train import checkpoint, step
from torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the share of a weight's INT8 codes more than one quantum from the
# reference's after the three steps, measured on the CPU: GaLore leaves at
# most 7.6e-6 (wo), as test_torch_dp.py bounds them; the full-rank Adam
# leaves (the embedding, the stacked norm scales) 7.8e-4 and 2.4e-3, where
# the one-process port gives 6.7e-4 and 1.5e-3 on the same inputs
LEAF_OFF = 1e-4
FULL_RANK_OFF = 5e-3
SIDES = [(side, sd) for side in ("right", "left") for sd in (0, 1)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's one-device run, started at once in a process of its
    own and read when a test first needs it."""
    path = tmp_path_factory.mktemp("tp_ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_tp_reference.py"),
         str(path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{out}\n{err}"
        with open(path, "rb") as f:
            return pickle.load(f)
    yield SimpleNamespace(path=str(path), result=result)
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    """One spawn of two ranks for every (1, 2) and (2, 1) check; they run
    the checks that need no reference beside its process."""
    save = str(tmp_path_factory.mktemp("tp_ckpt"))
    got = run_ranks(tr.tp_runs, 2, reference.path, save,
                    rendezvous_dir=str(tmp_path_factory.mktemp("tp_ranks")))
    return got, save


@pytest.fixture(scope="module")
def one_process():
    return tr.dp.run(tr.trainer())


# ---------------------------------------------------------------------------
# the projector's shard helpers against the reference's
# ---------------------------------------------------------------------------

def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("side,shard_dim", SIDES)
def test_projection_shards_bit_exact(reference, side, shard_dim):
    """A rank's INT4 P is a slice of the whole quantization (codes and
    scales), the reference's slice, and the quantization of the float
    slice; reassembled it is the whole P."""
    reference     # start the reference's run now, beside these
    world, d, r = 2, 64, 16
    P = _rand((3, d, r), 0)
    whole = projector.quantize_projection(torch.from_numpy(P), 4, 256)
    jwhole = jproj.quantize_projection(jnp.asarray(P), 4, 256)
    shards = [projector.shard_projection(whole, side, shard_dim, i, world)
              for i in range(world)]
    sliced = projector.proj_dim_sharded(side, shard_dim)
    assert sliced == jproj.proj_dim_sharded(side, shard_dim)
    for i, s in enumerate(shards):
        js = jproj.shard_projection(jwhole, side, shard_dim, i, world)
        for a, b in ((s.q, js.q), (s.scale, js.scale), (s.zero, js.zero)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if sliced:
            part = projector.quantize_projection(
                torch.from_numpy(P[:, i * d // world:(i + 1) * d // world]),
                4, 256)
            for a, b in ((s.q, part.q), (s.scale, part.scale)):
                assert torch.equal(a, b)
    back = projector.reassemble_projection(shards, side, shard_dim)
    assert torch.equal(back.q, whole.q) and torch.equal(back.scale,
                                                        whole.scale)


@pytest.mark.parametrize("side,shard_dim", SIDES)
def test_project_and_ratio_sharded(side, shard_dim):
    """The low-rank product and the explained-variance profile from the
    ranks' shards (``sum`` as the reducer) equal the whole gradient's and
    the reference's."""
    world, m, n, r = 2, 48, 40, 6
    if side == "left":
        m, n = n, m
    G = _rand((m, n), 1)
    d = n if side == "right" else m
    P = np.linalg.qr(_rand((d, r), 2))[0].astype(np.float32)
    Gs = [projector.shard_matrix(torch.from_numpy(G), shard_dim, i, world)
          for i in range(world)]
    Ps = [projector.shard_projection(torch.from_numpy(P), side, shard_dim,
                                     i, world) for i in range(world)]
    jGs = [jproj.shard_matrix(jnp.asarray(G), shard_dim, i, world)
           for i in range(world)]
    jPs = [jproj.shard_projection(jnp.asarray(P), side, shard_dim, i, world)
           for i in range(world)]
    whole = projector.project(torch.from_numpy(G), torch.from_numpy(P), side)
    lows = [projector.project_sharded(g, p, side, shard_dim,
                                      lambda x: x) for g, p in zip(Gs, Ps)]
    if projector.proj_dim_sharded(side, shard_dim):
        got = sum(lows)
    else:
        got = torch.cat(lows, dim=-2 if side == "right" else -1)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5)
    # the profile: a first pass records each rank's partials (no reducer
    # input depends on an earlier reducer's output), a second sums them
    def lockstep(fn, shards):
        calls = [[] for _ in shards]
        for (g, p), c in zip(shards, calls):
            fn(g, p, lambda x, c=c: c.append(x) or x)
        sums = [iter([sum(c[j] for c in calls) for j in range(len(c))])
                for c in calls]
        return [fn(g, p, lambda x, it=it: next(it))
                for (g, p), it in zip(shards, sums)]
    ratios = lockstep(lambda g, p, ps: projector.explained_ratio_sharded(
        g, p, side, shard_dim, ps), list(zip(Gs, Ps)))
    jratios = lockstep(lambda g, p, ps: np.asarray(
        jproj.explained_ratio_sharded(g, p, side, shard_dim, ps)),
        list(zip(jGs, jPs)))
    want = projector.explained_ratio(torch.from_numpy(G),
                                     torch.from_numpy(P), side)
    for a, b in zip(ratios, jratios):
        np.testing.assert_allclose(a.numpy(), want.numpy(), atol=1e-5)
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5)


@pytest.mark.parametrize("side,shard_dim", SIDES)
def test_sharded_subspace_spans_the_reference(side, shard_dim):
    """The Gram route's subspace (from the ranks' shards, a psum of the
    Gram) spans the whole gradient's top subspace and the reference's."""
    world, m, n, r = 2, 32, 24, 4
    if side == "left":
        m, n = n, m
    G = _rand((m, n), 3) + 4 * np.outer(_rand((m,), 4), _rand((n,), 5))
    Gs = [projector.shard_matrix(torch.from_numpy(G), shard_dim, i, world)
          for i in range(world)]
    jGs = [jproj.shard_matrix(jnp.asarray(G), shard_dim, i, world)
           for i in range(world)]
    key = "mn" if (side == "right") == (
        not projector.proj_dim_sharded(side, shard_dim)) else "nm"
    gram = lambda g: (g.T @ g) if key == "mn" else (g @ g.T)
    C = sum(gram(g.to(torch.float64)).to(torch.float32) for g in Gs)
    jC = sum(gram(np.asarray(g, np.float64)).astype(np.float32) for g in jGs)
    got = [projector.sharded_subspace(g, r, side, shard_dim, lambda _x: C)
           for g in Gs]
    jgot = [np.asarray(jproj.sharded_subspace(g, r, side, shard_dim,
                                              lambda _x: jnp.asarray(jC)))
            for g in jGs]
    if projector.proj_dim_sharded(side, shard_dim):
        P, jP = torch.cat(got, dim=0), np.concatenate(jgot, axis=0)
    else:
        P, jP = got[0], jgot[0]
    exact = projector.compute_subspace(torch.from_numpy(G), r, side)
    for Q in (torch.from_numpy(jP), exact):
        sim = float(projector.subspace_similarity(P, Q))
        assert sim > 0.99, (side, shard_dim, sim)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _plan(arch, smoke, t=2):
    b = model_zoo.build_arch(arch, smoke=smoke, device="cpu",
                             dtype=torch.float32)
    q = QGaLoreConfig(rank=8, min_dim=32)
    specs = qgalore.leaf_specs(step.abstract_params(b, q), q)
    return {s.path.split("'")[-2]: s.shard_dim
            for s in tp.plan_specs(specs, t, b.cfg)}


def test_whole_block_rule_on_llama_1b():
    """Full shapes: attention shards (wq/wk/wv on columns, wo on rows), the
    FFN (d_ff 5461) and the head (32000 = 125 blocks) stay replicated, the
    embedding (d 2048) splits on d. Smoke shapes (d 64): only the head
    (vocab 512, two blocks) holds whole blocks a rank."""
    full = _plan("llama-1b", False)
    assert {k: full[k] for k in ("wq", "wk", "wv", "wo")} == \
        {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    assert full["wi"] is full["wg"] is full["wd"] is full["head"] is None
    assert full["embedding"] == 1
    smoke = _plan("llama-1b", True)
    assert smoke.pop("head") == 1 and set(smoke.values()) == {None}
    nemo = _plan("mistral-nemo-12b", False)
    assert all(v is not None for k, v in nemo.items() if "norm" not in k)


@pytest.mark.parametrize("arch", ["gemma-7b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b", "xlstm-125m",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_uncovered_families_refuse_by_name(arch):
    with pytest.raises(NotImplementedError, match="5b follow-up: TP for the "
                       "other families"):
        model_zoo.build_arch(arch, smoke=True, device="cpu",
                             tp_group=SimpleNamespace(world=2))


@pytest.mark.parametrize("arch", list(model_zoo.ARCH_IDS))
def test_abstract_params_lay_out_the_meta_draw(arch):
    """``abstract_params`` from shapes alone gives the layout the meta
    device's draws and quantization gave: every leaf's (and QTensor
    array's) shape and dtype, and so the same specs and templates."""
    b = model_zoo.build_arch(arch, smoke=True, device="cpu",
                             dtype=torch.float32)
    q = QGaLoreConfig(rank=8, min_dim=32)
    got = qgalore.flatten(step.abstract_params(b, q))
    # the draw on the CPU, at the smoke shapes, quantized as prepared
    want = qgalore.flatten(b.init_params(
        torch.Generator().manual_seed(0), device_="cpu",
        leaf_fn=lambda keys, t: step.prepare_params(t, q, torch.float32,
                                                    keys)))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        arrays = (lambda x: [x.q, x.scale, x.zero] if isinstance(
            x, quant.QTensor) else [x])
        assert type(g) is type(w), k
        for a, c in zip(arrays(g), arrays(w)):
            assert (a is None) == (c is None), k
            if a is not None:
                assert a.is_meta and a.shape == c.shape and \
                    a.dtype == c.dtype, k
    tree = lambda flat: qgalore.unflatten([k for k, _ in flat],
                                          [x for _, x in flat])
    assert qgalore.leaf_specs(tree(got), q) == \
        qgalore.leaf_specs(tree(want), q)


@pytest.mark.parametrize("kind,rank", [("tp", 0), ("tp", 1), ("ep", 1)])
def test_init_cut_leaf_by_leaf_equals_cutting_the_whole(kind, rank):
    """``step.init_state(cut=)`` (each leaf cut as it is drawn, so a rank
    never holds the whole state) gives what cutting the whole init does:
    a tensor-parallel rank's slices (``tp.shard_params`` /
    ``tp.shard_opt``) of the test model at t = 2, or an expert-parallel
    rank's experts of the MoE (axis -3 of every array of an expert
    stack), bit for bit."""
    if kind == "tp":
        b, q = tr.bundle(), tr.qcfg()
        specs = tp.plan_specs(qgalore.leaf_specs(
            step.abstract_params(b, q), q), 2, b.cfg)

        def cut(i, x):
            return tp.shard_opt_leaf(specs[i], *x, rank) \
                if type(x) is tuple else tp.shard_leaf(x, specs[i], rank)
    else:
        b = model_zoo.build_arch(tr.EP_ARCH, smoke=True, device="cpu",
                                 dtype=torch.float32)
        q = tr.qcfg()
        specs = qgalore.leaf_specs(step.abstract_params(b, q), q)

        def cut(i, x):
            if type(x) is tuple:
                return tuple(tp.expert_cut(specs[i], y, rank, 2) for y in x)
            return tp.expert_cut(specs[i], x, rank, 2)
    whole = step.init_state(b, q, 3, specs=specs)
    got = checkpoint.state_arrays(step.init_state(b, q, 3, specs=specs,
                                                  cut=cut))
    if kind == "tp":
        want = checkpoint.state_arrays(step.TrainState(
            tp.shard_params(whole.params, specs, (1, 2), rank),
            tp.shard_opt(whole.opt, specs, rank)))
        assert any(got[k].shape != v.shape for k, v in
                   checkpoint.state_arrays(whole).items())
    else:
        want = {k: np.take(v, range(v.shape[-3] // 2 * rank,
                                    v.shape[-3] // 2 * (rank + 1)),
                           axis=-3) if "experts_" in k else v
                for k, v in checkpoint.state_arrays(whole).items()}
        assert any("experts_" in k for k in want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_quantize_leaf_on_meta_is_a_layout():
    x = torch.empty(3, 300, device="meta")
    got = quantize_leaf(x)
    want = quantize_leaf(torch.zeros(3, 300))
    assert got.q.shape == want.q.shape and got.scale.shape == \
        want.scale.shape and got.orig_last == want.orig_last == 300


def test_zero2_on_a_2x2_mesh(one_process, tmp_path):
    """Four ranks: two data shards of two tensor-parallel ranks, ZeRO-2
    splitting each rank's slices over the data group."""
    four = run_ranks(tr.zero_run, 4, rendezvous_dir=str(tmp_path))
    for r in four[1:]:
        assert r["losses"] == four[0]["losses"]
    assert four[0]["zero2"] > 0
    assert four[0]["svd"] == one_process["svd"] > 0
    np.testing.assert_allclose(four[0]["losses"], one_process["losses"],
                               rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# two ranks against the reference; the trainer; checkpoints
# ---------------------------------------------------------------------------

def test_matches_the_reference_one_device(reference, two_ranks):
    ref = reference.result()
    got = [r["reference"] for r in two_ranks[0]]
    assert got[0]["losses"] == got[1]["losses"]
    port = got[0]
    # every matrix of the model shards; attention's columns and rows land on
    # the contracted dim (their low-rank products are summed)
    assert len(port["sharded"]) == 9 and port["psum"] != []
    assert port["dist_refresh"] == []      # refreshed after the clip
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-3,
                               atol=1e-3)
    assert set(port["sims"]) == set(ref["sims"])
    for k in ref["sims"]:
        np.testing.assert_allclose(port["sims"][k], ref["sims"][k],
                                   atol=1e-3, err_msg=k)
    ref_proj = {k: v for k, v in _flat(ref["proj"]) if v is not None}
    assert set(port["proj"]) == set(ref_proj)
    for k, q in port["proj"].items():
        assert (q != ref_proj[k][0]).mean() < 0.02, k
    ref_codes = {k: v[0] for k, v in _flat(ref["final"])
                 if isinstance(v, tuple)}
    assert set(port["codes"]) == set(ref_codes)
    for k, q in port["codes"].items():
        diff = np.abs(q.astype(np.int32) - ref_codes[k].astype(np.int32))
        if k == "['embedding']" or k.endswith("_norm']"):
            # full-rank Adam leaves: sign steps (module docstring)
            assert (diff > 1).mean() <= FULL_RANK_OFF, k
        else:
            assert (diff > 1).mean() <= LEAF_OFF and diff.max() <= 2, k


def test_model_group_bytes_equal_the_payload(two_ranks):
    for r in two_ranks[0]:
        got = r["reference"]
        assert got["model_bytes"] == got["payload"] > 0
        assert set(got["model_calls"]) == {"all_reduce", "all_gather",
                                           "all_reduce_max",
                                           "all_reduce_min"}


def test_randomized_subspace_from_shards(two_ranks):
    """The range finder on the ranks' shards gives the whole gradient's
    randomized subspace, up to the order of the sums."""
    for r in two_ranks[0]:
        for side, got in r["routes"].items():
            assert got["max_abs_diff"] < 1e-4, side
            assert got["similarity"] > 0.9999, side


def test_randomized_trainer_against_one_process(two_ranks):
    one = tr.dp.run(tr.trainer(method="randomized"))
    got = [r["randomized"] for r in two_ranks[0]]
    assert got[0]["losses"] == got[1]["losses"]
    assert got[0]["svd"] == one["svd"] > 0
    np.testing.assert_allclose(got[0]["losses"], one["losses"], rtol=1e-3,
                               atol=1e-3)


def test_trainer_against_one_process(two_ranks, one_process):
    plain = [r["plain"] for r in two_ranks[0]]
    assert plain[0]["losses"] == plain[1]["losses"]
    assert plain[0]["dist_refresh"] != []    # the combined front
    assert plain[0]["svd"] == one_process["svd"] > 0
    assert plain[0]["masks"] == one_process["masks"]
    np.testing.assert_allclose(plain[0]["losses"], one_process["losses"],
                               rtol=1e-3, atol=1e-3)


def test_checkpoint_restores_into_one_process_and_dp(two_ranks):
    ranks, save = two_ranks
    want = ranks[0]["next_loss"]
    assert ranks[0]["saved"].keys() == ranks[1]["saved"].keys()
    for k, v in ranks[0]["saved"].items():
        np.testing.assert_array_equal(v, ranks[1]["saved"][k])
    t = tr.trainer(steps=3, checkpoint_dir=save)
    assert t.maybe_restore() == 2
    t.mgr = None
    assert checkpoint.state_arrays(t.state).keys() == ranks[0]["saved"].keys()
    one = t.run(3)[-1]["loss"]
    for got in (one, ranks[0]["restored_dp_loss"]):
        assert abs(got - want) <= 1e-6 * abs(want), (got, want)
