"""The reference's one-device run of the tensor-parallel test model, for
``test_torch_tp.py``: run as a script in a process of its own, it writes
to the path it is given (a pickle, renamed into place when whole) the
init state, the batches, the losses, the refresh step's similarities and
projections and the weights' codes after the last step, all as numpy; a
failure writes its traceback beside it (``<path>.err``), so that ranks
waiting for the run stop. The reference's own TP gate
compares a TP run with one device, so one device is the yardstick here
too (its ``(2, 4)`` parity test is red on some hosts)."""
import os
import pickle
import sys
import traceback

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.config import QGaLoreConfig, ShapeCell, TrainConfig  # noqa: E402
from repro.config import replace as cfg_replace  # noqa: E402
from repro.core.optimizers import preset  # noqa: E402
from repro.data.synthetic import batch_for_bundle  # noqa: E402
from repro.models.model_zoo import build, get_config  # noqa: E402
from repro.train import step as step_lib  # noqa: E402
from torch_dp_reference import state_np  # noqa: E402

# slices of whole blocks at t = 2: d 512, 4 heads x 128 (and 4 KV heads),
# d_ff 1024, vocab 1024
SHAPE = dict(d_model=512, num_heads=4, num_kv_heads=4, head_dim=128,
             d_ff=1024, vocab_size=1024, num_layers=4)
BATCH, SEQ, STEPS, LR, RANK = 4, 16, 3, 1e-2, 8


def main(out_path):
    cfg = cfg_replace(get_config("llama-60m", smoke=True), **SHAPE)
    bundle = build(cfg, dtype=jnp.float32)
    qcfg = preset("qgalore", QGaLoreConfig(rank=RANK, min_dim=32))
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, grad_clip=1.0)
    cell = ShapeCell("t", SEQ, BATCH, "train")
    raw, specs = step_lib.build_train_step(
        bundle, qcfg, tcfg, impl="fused", param_dtype=jnp.float32)
    state = jax.jit(lambda k: step_lib.init_state(
        bundle, qcfg, k, jnp.float32))(jax.random.PRNGKey(0))
    out = {"init": state_np(state), "batches": [], "losses": []}
    masks = {i: jnp.ones((s.nbatch,), bool)
             for i, s in enumerate(specs) if s.galore}
    fr = jax.jit(lambda st, b, rng, m: raw(st, b, LR, rng, refresh_masks=m,
                                           refresh=True))
    fn = jax.jit(lambda st, b, rng: raw(st, b, LR, rng, refresh_masks=None,
                                        refresh=False))
    for s in range(STEPS):
        batch = batch_for_bundle(bundle, cell, s)
        out["batches"].append({k: np.asarray(v) for k, v in batch.items()})
        rng = jax.random.fold_in(jax.random.PRNGKey(17), s)
        if s == 0:
            state, met, om = fr(state, batch, rng, masks)
            out["sims"] = {k: np.asarray(v) for k, v in om["sims"].items()}
            out["proj"] = state_np(state)["proj"]
        else:
            state, met, _ = fn(state, batch, rng)
        out["losses"].append(float(met["loss"]))
    out["final"] = state_np(state)["params"]
    with open(out_path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(out_path + ".tmp", out_path)


if __name__ == "__main__":
    try:
        main(sys.argv[1])
    except BaseException:
        with open(sys.argv[1] + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
