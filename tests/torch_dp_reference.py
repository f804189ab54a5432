"""The reference's compressed data-parallel run at D = 2, for
``test_torch_dp.py``: run as a script in a process of its own, whose two
host devices the XLA flag fixes before jax starts, it writes to the path
it is given (a pickle) the init state, the batches, the losses, the
refresh step's similarities, the projections it made and the weights'
codes after the last step, all as numpy."""
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import QGaLoreConfig, ShapeCell, TrainConfig  # noqa: E402
from repro.config import replace as cfg_replace  # noqa: E402
from repro.core import adam8bit, quant  # noqa: E402
from repro.core.optimizers import preset  # noqa: E402
from repro.data.synthetic import batch_for_bundle  # noqa: E402
from repro.models.model_zoo import build, get_config  # noqa: E402
from repro.train import step as step_lib  # noqa: E402

LAYERS, BATCH, SEQ, STEPS, LR = 8, 8, 32, 3, 1e-2


def _np_leaf(x):
    if isinstance(x, quant.QTensor):
        return (np.asarray(x.q), np.asarray(x.scale),
                None if x.zero is None else np.asarray(x.zero), x.bits,
                x.block, x.orig_last, x.dtype)
    return np.asarray(x)


def state_np(state):
    is_q = lambda x: isinstance(x, quant.QTensor)
    return {
        "params": jax.tree_util.tree_map(_np_leaf, state.params,
                                         is_leaf=is_q),
        "inner": jax.tree_util.tree_map(
            lambda a: (_np_leaf(a.m), _np_leaf(a.v)), state.opt.inner,
            is_leaf=lambda x: isinstance(x, adam8bit.Adam8bitState)),
        "proj": jax.tree_util.tree_map(
            lambda p: None if p is None else _np_leaf(p), state.opt.proj,
            is_leaf=lambda x: x is None or is_q(x)),
        "count": int(state.opt.count)}


def main(out_path):
    cfg = cfg_replace(get_config("llama-60m", smoke=True), num_layers=LAYERS)
    bundle = build(cfg, dtype=jnp.float32)
    qcfg = preset("qgalore", QGaLoreConfig(rank=8, min_dim=32,
                                           compress_dp_grads=True))
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, grad_clip=1.0)
    cell = ShapeCell("t", SEQ, BATCH, "train")
    mesh = jax.make_mesh((2, 1), ("data", "model"))
    raw, specs = step_lib.build_train_step(
        bundle, qcfg, tcfg, impl="fused", param_dtype=jnp.float32,
        mesh=mesh, dp_compress=True)
    state = jax.jit(lambda k: step_lib.init_state(
        bundle, qcfg, k, jnp.float32))(jax.random.PRNGKey(0))
    out = {"init": state_np(state), "batches": [], "losses": []}
    masks = {i: jnp.ones((s.nbatch,), bool)
             for i, s in enumerate(specs) if s.galore}
    fr = jax.jit(lambda st, b, rng, m: raw(st, b, LR, rng, refresh_masks=m,
                                           refresh=True))
    fn = jax.jit(lambda st, b, rng: raw(st, b, LR, rng, refresh_masks=None,
                                        refresh=False))
    with mesh:
        for s in range(STEPS):
            batch = batch_for_bundle(bundle, cell, s)
            out["batches"].append({k: np.asarray(v)
                                   for k, v in batch.items()})
            rng = jax.random.fold_in(jax.random.PRNGKey(17), s)
            if s == 0:
                state, met, om = fr(state, batch, rng, masks)
                out["sims"] = {k: np.asarray(v)
                               for k, v in om["sims"].items()}
                out["proj"] = state_np(state)["proj"]
            else:
                state, met, _ = fn(state, batch, rng)
            out["losses"].append(float(met["loss"]))
    out["final"] = state_np(state)["params"]
    with open(out_path, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1])
