"""The port's expert parallelism (``models/moe.py`` ``moe_apply_ep`` /
``moe_ep_sharded``, the trainer with an ``ep_group``) on two gloo ranks
on the CPU, at qwen3-moe-30b-a3b's smoke config (E 8, top-2), float32.

* ``moe_apply_ep`` against the reference's ``moe_apply`` on the same
  tokens, drop-free (the counterpart of ``tests/test_moe_ep.py``): each
  rank's output rows, and the gradients of ``jax.grad`` of the mean loss
  over all ranks' tokens. Each rank's loss is the mean over its own
  tokens, as the reference's step takes it, so an owned expert stack's
  gradient (the sum over the ranks that reached it) is D times the one
  device's: the trainer divides it by D (``train/step.py`` ``_reduce``).
* A training run expert-parallel against the same run plain
  data-parallel (the same data-parallel semantics: steps 0 and 1 within
  1e-5; then 1e-3, because the plain run refreshes the expert stacks
  distributed and clips their low-rank payload, where the owned experts
  refresh in the optimizer after a full-rank clip, as the reference
  keeps expert leaves out of the distributed refresh) and against the
  one process: step 0 within 1e-4, where only the routers' aux loss
  differs (each rank takes it on its own tokens, as the reference's
  expert-parallel step does), and the trajectory within the reference's
  band, 2e-3 (``tests/test_golden.py``), which that aux gradient moves
  it across (1.6e-3 at step 2, measured; the plain data-parallel run
  moves as far). Step 0's owned expert gradients, as the reduction
  leaves them, equal the one process's slices within 1e-3 of their
  largest entry (the aux losses' gradients reach the earlier layer's
  experts through the residual stream), so the division by D is held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_ranks as tr
from repro.models import model_zoo as jzoo
from repro.models import moe as jmoe
from repro_torch.core import qgalore
from repro_torch.distributed.spawn import run_ranks
from torch_one_thread import one_thread  # noqa: F401

WORLD = 2


@pytest.fixture(scope="module")
def layer():
    cfg = jzoo.get_config(tr.EP_ARCH, smoke=True)
    p = jmoe.moe_init(jax.random.PRNGKey(3), cfg, jnp.float32)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32)

    def loss(p, x):
        out, _ = jmoe.moe_apply(p, x, cfg, dtype=jnp.float32)
        return jnp.sum(out * w) / (x.shape[0] * x.shape[1])
    out, _ = jmoe.moe_apply(p, jnp.asarray(x), cfg, dtype=jnp.float32)
    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))
    p_np = {k: np.asarray(v) for k, v in p.items()}
    return cfg, p_np, x, w, np.asarray(out), gp, np.asarray(gx)


def test_moe_apply_ep_matches_the_reference(layer, tmp_path):
    cfg, p, x, w, want, gp, gx = layer
    got = run_ranks(tr.ep_layer, WORLD, p, x, w,
                    rendezvous_dir=str(tmp_path))
    E = cfg.moe.num_experts
    e_loc = E // WORLD
    assert cfg.moe.top_k * 2 * 8 <= 4096          # drop-free on a rank
    for r, g in enumerate(got):
        lo, hi = g["rows"]
        np.testing.assert_allclose(g["out"], want[lo:hi], atol=1e-5)
        # the rank's loss is its tokens' mean: D times the global mean's
        np.testing.assert_allclose(g["dx"] / WORLD, gx[lo:hi], atol=1e-6)
        for k, v in g["grads"].items():
            ref = np.asarray(gp[k])
            if k.startswith("experts_"):
                ref = ref[r * e_loc:(r + 1) * e_loc]
                # owned: every rank's tokens summed here, D x the one
                # device's; the trainer divides by D
                np.testing.assert_allclose(v / WORLD, ref, atol=1e-6,
                                           err_msg=k)
                assert np.abs(v).max() > 0, k
    # the router is replicated: the ranks' gradients sum to the reference's
    router = sum(g["grads"]["router"] for g in got) / WORLD
    np.testing.assert_allclose(router, np.asarray(gp["router"]), atol=1e-6)


def test_ep_training_against_dp_and_one_process(tmp_path):
    ranks = run_ranks(tr.ep_runs, WORLD, rendezvous_dir=str(tmp_path))
    one_grads, vg = {}, tr.step.accumulated_value_and_grad

    def capture(*args):
        out = vg(*args)
        if not one_grads:
            one_grads.update({qgalore.keystr(k): g.detach().numpy().copy()
                              for k, g in qgalore.flatten(out[1])})
        return out
    tr.step.accumulated_value_and_grad = capture
    try:
        one = tr.dp.run(tr.ep_trainer())
    finally:
        tr.step.accumulated_value_and_grad = vg
    for r in ranks[1:]:
        assert r["ep"]["losses"] == ranks[0]["ep"]["losses"]
        assert r["ep"]["masks"] == ranks[0]["ep"]["masks"]
    ep, dp = ranks[0]["ep"], ranks[0]["dp"]
    assert all(s[-3] == 4 for s in ranks[0]["experts"])   # 4 of 8 a rank
    assert ep["svd"] == dp["svd"] == one["svd"] > 0
    np.testing.assert_allclose(ep["losses"][:2], dp["losses"][:2], rtol=1e-5)
    np.testing.assert_allclose(ep["losses"], dp["losses"], rtol=1e-3)
    assert abs(ep["losses"][0] - one["losses"][0]) <= 1e-4 * one["losses"][0]
    # step 0's owned expert gradients (full rank: a refresh step) are the
    # one process's slices, so the trainer's division by D is held here
    for r, g in enumerate(ranks):
        assert g["grads"], r
        for path, v in g["grads"].items():
            e_loc = v.shape[-3]
            want = np.take(one_grads[path],
                           range(r * e_loc, (r + 1) * e_loc), axis=-3)
            np.testing.assert_allclose(v, want, rtol=0,
                                       atol=1e-3 * np.abs(want).max(),
                                       err_msg=path)
    np.testing.assert_allclose(ep["losses"], one["losses"], rtol=2e-3)
