"""Rank functions of the port's data-parallel CPU tests
(``test_torch_dp.py``, ``test_torch_zero.py``), started on gloo ranks by
``repro_torch.distributed.spawn.run_ranks``: importable by name in a
fresh process, and importing neither jax nor the JAX package at module
level (only :func:`reference_steps` imports jax, for the reference's
uniform draws)."""
import numpy as np
import torch

from repro_torch.config import QGaLoreConfig, TrainConfig, replace
from repro_torch.core import qgalore, quant
from repro_torch.core.optimizers import preset
from repro_torch.models import model_zoo
from repro_torch.train import checkpoint, step
from repro_torch.train.trainer import Trainer

LAYERS, SEQ = 8, 32


def bundle(layers: int = LAYERS):
    cfg = replace(model_zoo.get_config("llama-60m", smoke=True),
                  num_layers=layers)
    return model_zoo.build(cfg, device="cpu", dtype=torch.float32)


def qcfg(**kw):
    base = dict(rank=8, min_dim=32, compress_dp_grads=True)
    base.update(kw)
    return preset("qgalore", QGaLoreConfig(**base))


def trainer(comm, batch=8, steps=5, zero=False, zero2=None,
            checkpoint_dir="", q=None, layers=LAYERS):
    """llama-60m smoke, f32, a fixed interval of 3 (refreshes at steps 0
    and 3) unless ``q`` says otherwise."""
    torch.set_num_threads(1)
    tcfg = TrainConfig(global_batch=batch, seq_len=SEQ, steps=steps,
                       learning_rate=1e-2, warmup_steps=1, grad_clip=1.0,
                       log_every=0, checkpoint_dir=checkpoint_dir,
                       async_checkpoint=False)
    return Trainer(bundle(layers), tcfg,
                   q or qcfg(update_interval=3, adaptive=False),
                   param_dtype=torch.float32, group=comm, zero_shard=zero,
                   zero2=zero2)


def codes(state) -> dict:
    """The INT8 codes of every quantized weight, by path."""
    return {qgalore.keystr(k): leaf.q.numpy().copy()
            for k, leaf in qgalore.flatten(state.params)
            if isinstance(leaf, quant.QTensor)}


def run(t: Trainer) -> dict:
    """Train, recording the refresh masks the controller hands out."""
    masks = []
    orig = t.controller.masks_for_step

    def record(s):
        m = orig(s)
        masks.append((s, {i: v.tolist() for i, v in sorted(m.items())}))
        return m
    t.controller.masks_for_step = record
    hist = t.run()
    return {"losses": [h["loss"] for h in hist], "masks": masks,
            "transitions": t.controller.rank_transition_summary(),
            "ranks": [s.rank for s in t.specs], "codes": codes(t.state),
            "bytes": t.opt_state_bytes(),
            "svd": t.controller.total_svd_count(),
            "dist_refresh": t._step.dist_refresh}


def trajectory(comm, batch=8, dist_refresh=True, **kw) -> dict:
    q = qcfg(update_interval=3, adaptive=False, dist_refresh=dist_refresh)
    return run(trainer(comm, batch=batch, q=q, **kw))


def trajectories(comm, *cases) -> list:
    """:func:`trajectory` of each ``(batch, dist_refresh)``, in turn."""
    return [trajectory(comm, b, d) for b, d in cases]


def zero_runs(comm, save_dir=None, restore_dir=None) -> dict:
    """In one group: the plain compressed run, ZeRO with ZeRO-2, ZeRO
    without it, and a ZeRO run with a rank transition at its first
    refresh beside the plain run of the same recipe; then, with
    ``save_dir``, a ZeRO run saved after step 1 (its whole state
    returned), and with ``restore_dir``, that checkpoint restored under
    ZeRO (the whole state gathered back)."""
    out = {"plain": trajectory(comm),
           "zero2": trajectory(comm, zero=True),
           "zero": trajectory(comm, zero=True, zero2=False)}
    adarank = qcfg(update_interval=2, adaptive=False, adaptive_rank=True,
                   explained_ratio_threshold=0.0, rank_patience=1,
                   rank_ladder=(4,), min_rank=4)
    out["adarank_plain"] = run(trainer(comm, steps=4, q=adarank))
    out["adarank_zero"] = run(trainer(comm, steps=4, q=adarank, zero=True))
    if save_dir:
        t = trainer(comm, steps=2, zero=True, checkpoint_dir=save_dir)
        t.run()
        out["saved"] = checkpoint.state_arrays(t.whole_state())
    if restore_dir:
        t = trainer(comm, steps=2, zero=True, checkpoint_dir=restore_dir)
        assert t.maybe_restore() == 2
        out["restored"] = checkpoint.state_arrays(t.whole_state())
        out["held"] = t.opt_state_bytes()
    return out


def _jax_uniforms(seed: int):
    """The reference's SR draws, ``fold_in`` by step, leaf and layer
    (``tests/test_torch_train.py::jax_uniforms``)."""
    import jax
    import jax.numpy as jnp
    base_key = jax.random.PRNGKey(seed + 17)

    def draw(step_idx, leaf_idx, layer, shape):
        k = jax.random.fold_in(jax.random.fold_in(base_key, step_idx),
                               leaf_idx)
        if layer is not None:
            k = jax.random.fold_in(k, layer)
        return torch.from_numpy(np.array(
            jax.random.uniform(k, shape, jnp.float32)))
    return draw


def reference_steps(comm, ref: dict) -> dict:
    """The reference's compressed data-parallel steps (one refresh with
    every layer masked, then steady ones) from its init, on its batches
    (this rank's rows) and SR draws, fresh singular vectors signed as its
    refreshed projections."""
    from repro_torch.serve.params import from_jax_state
    torch.set_num_threads(1)
    b = bundle()
    q = qcfg()
    tcfg = TrainConfig(global_batch=8, seq_len=SEQ, grad_clip=1.0)
    state = from_jax_state(ref["init"], device="cpu")
    specs = qgalore.leaf_specs(state.params, q)
    ref_p = {s.path: P for s, (_, P) in zip(
        specs, qgalore.flatten(ref["proj"]))}

    def align(path, g, P_new, units):
        want = quant.dequantize(quant.from_numpy(ref_p[path], "cpu"),
                                torch.float32)
        want = want.reshape((-1,) + tuple(want.shape[-2:]))[units]
        sign = torch.sign((P_new * want).sum(dim=-2, keepdim=True))
        return P_new * torch.where(sign == 0, 1.0, sign)
    qgalore.SUBSPACE_HOOK = align
    fn = step.build_train_step(b, q, tcfg, specs, group=comm)
    draw = _jax_uniforms(0)
    rows = 8 // comm.world
    lo = comm.rank * rows
    out = {"losses": [], "dist_refresh": fn.dist_refresh}
    for s, batch in enumerate(ref["batches"]):
        local = {k: torch.from_numpy(v[lo:lo + rows]) for k, v in
                 batch.items()}
        masks = {i: np.ones((sp.nbatch,), bool)
                 for i, sp in enumerate(specs) if sp.galore} if s == 0 \
            else None
        state, met, om = fn(state, local, 1e-2, s, draw, masks)
        out["losses"].append(float(met["loss"]))
        if s == 0:
            out["sims"] = om["sims"]
            out["proj"] = {sp.path: P.q.numpy().copy()
                           for sp, P in zip(specs, state.opt.proj)
                           if P is not None}
    out["codes"] = codes(state)
    return out


def steady_step(comm, device="cpu", seed=0) -> dict:
    """One steady step of llama-60m smoke from its seeded init (the random
    projections), compressed data-parallel over ``comm``'s ranks on this
    rank's rows of a seeded batch of 4: the loss, the weights' codes and
    the kernel launches."""
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    from repro_torch.kernels import LAUNCHES
    torch.set_num_threads(1)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
    b = model_zoo.build_arch("llama-60m", smoke=True, device=device,
                             dtype=torch.float32)
    q = qcfg()
    tcfg = TrainConfig(global_batch=4, seq_len=SEQ, grad_clip=1.0)
    state = step.init_state(b, q, seed)
    specs = qgalore.leaf_specs(state.params, q)
    batch = SyntheticLM(DataConfig(vocab_size=512, seq_len=SEQ,
                                   global_batch=4)).batch_at(0)
    world, rank = (1, 0) if comm is None else (comm.world, comm.rank)
    rows = 4 // world
    local = {k: v[rank * rows:(rank + 1) * rows].to(device)
             for k, v in batch.items()}
    fn = step.build_train_step(b, q, tcfg, specs, group=comm)
    LAUNCHES.clear()
    state, met, _ = fn(state, local, 1e-2, 0,
                       step.generator_uniforms(seed, device))
    return {"loss": float(met["loss"]),
            "codes": {k: v for k, v in codes_on_host(state).items()},
            "launches": dict(LAUNCHES)}


def codes_on_host(state) -> dict:
    return {qgalore.keystr(k): leaf.q.cpu().numpy()
            for k, leaf in qgalore.flatten(state.params)
            if isinstance(leaf, quant.QTensor)}
