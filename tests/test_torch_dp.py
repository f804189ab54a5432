"""The port's compressed data-parallel training on gloo ranks on the CPU
(``Trainer(group=...)``, ``train/step.py``): llama-60m smoke at 8 layers,
f32, rank 8.

* D = 1, 2 and 4 give the same 5-step trajectory (refreshes at steps 0
  and 3) within 1e-3, as the reference's ``test_dp_compress_parity``; at
  D = 3 (a batch of 6) no leaf's 8 layers split, so every leaf refreshes
  replicated, and the trajectory agrees with D = 1's replicated refresh
  on that batch (the distributed refresh clips the low-rank payload, so
  the two refreshes differ by the clip, as the reference's do).
* Every rank hands out the same refresh masks and SVD counts.
* D = 2 against the live reference's compressed data-parallel run at D =
  2 (``tests/torch_dp_reference.py``, a process of its own with two host
  devices), grad_clip 1.0: one refresh step then two steady ones from
  its init, batches and SR draws, within its tolerances (loss 1e-3,
  similarities 1e-3, INT4 codes under 2% differing). Each weight's INT8
  codes lie within one quantum of the reference's but in at most 1e-4 of
  its entries, and those within two; the embedding's in all but 5e-4.
  Not all within one: each package differentiates its own rows here, and
  Adam turns a gradient entry near zero into a full step of the sign its
  rounding gives it, which the embedding's full-rank moments do to a few
  entries; elsewhere an entry one quantum apart after a step can take a
  second stochastic rounding apart on the next.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import torch_dp_ranks as ranks
from repro_torch.distributed.spawn import run_ranks
from torch_one_thread import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the share of a weight's INT8 codes more than one quantum from the
# reference's after the three steps: 29 of the embedding's 131,072 (2.2e-4)
# and 1 of wq's (2 quanta) were measured on the CPU
EMBEDDING_OFF = 5e-4
LEAF_OFF = 1e-4


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's run, started at once in a process of its own and
    read when a test first needs it."""
    path = tmp_path_factory.mktemp("dp_ref") / "ref.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_dp_reference.py"),
         str(path)], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)

    def result():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{out}\n{err}"
        with open(path, "rb") as f:
            return pickle.load(f)
    yield result
    if proc.poll() is None:
        proc.kill()


def _equal_ranks(runs, keys=("losses", "masks", "svd", "transitions",
                             "codes")):
    for r in runs[1:]:
        for k in keys:
            if k == "codes":
                assert r[k].keys() == runs[0][k].keys()
                for p in r[k]:
                    np.testing.assert_array_equal(r[k][p], runs[0][k][p])
            else:
                assert r[k] == runs[0][k], k


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """D = 1: the batch of 8 (distributed refresh) and of 6 (replicated)."""
    return run_ranks(ranks.trajectories, 1, (8, True), (6, False),
                     rendezvous_dir=str(tmp_path_factory.mktemp("one")))[0]


def test_trajectory_across_world_sizes(reference, one_rank, tmp_path):
    reference   # start the reference's run now, beside these
    runs = {d: run_ranks(ranks.trajectory, d, rendezvous_dir=str(tmp_path))
            for d in (2, 4)}
    runs[1] = [one_rank[0]]
    for d, rs in runs.items():
        _equal_ranks(rs)
        # every stacked leaf splits its 8 layers over 1, 2 and 4 ranks
        assert rs[0]["dist_refresh"] == runs[1][0]["dist_refresh"] != []
        assert [s for s, m in rs[0]["masks"] if m] == [0, 3]
    base = runs[1][0]["losses"]
    for d in (2, 4):
        np.testing.assert_allclose(runs[d][0]["losses"], base, rtol=1e-3,
                                   atol=1e-3)
        assert runs[d][0]["svd"] == runs[1][0]["svd"] > 0


def test_replicated_refresh_when_layers_do_not_split(one_rank, tmp_path):
    three = run_ranks(ranks.trajectory, 3, 6, rendezvous_dir=str(tmp_path))
    one = one_rank[1]
    _equal_ranks(three)
    assert three[0]["dist_refresh"] == one["dist_refresh"] == []
    assert three[0]["svd"] == one["svd"] > 0
    np.testing.assert_allclose(three[0]["losses"], one["losses"],
                               rtol=1e-3, atol=1e-3)


def test_matches_reference_dp(reference, tmp_path):
    ref = reference()
    got = run_ranks(ranks.reference_steps, 2, ref,
                    rendezvous_dir=str(tmp_path))
    assert got[0]["losses"] == got[1]["losses"]
    port = got[0]
    assert port["dist_refresh"] != []
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
        if k == "['embedding']":    # full-rank Adam: sign steps (docstring)
            assert (diff > 1).mean() <= EMBEDDING_OFF, k
        else:
            assert (diff > 1).mean() <= LEAF_OFF and diff.max() <= 2, k
    for a, b in zip(got[0]["codes"].values(), got[1]["codes"].values()):
        np.testing.assert_array_equal(a, b)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree
