"""Rank functions of the port's tensor-parallel CPU tests
(``test_torch_tp.py``), started on gloo ranks by
``repro_torch.distributed.spawn.run_ranks``: importable by name in a
fresh process, and importing neither jax nor the JAX package at module
level (the reference's draws come through ``torch_dp_ranks``)."""
import numpy as np
import torch

import torch_dp_ranks as dp
from repro_torch.config import QGaLoreConfig, TrainConfig, replace
from repro_torch.core import qgalore, quant
from repro_torch.core.optimizers import preset
from repro_torch.distributed import tp
from repro_torch.distributed.comm import mesh_comms
from repro_torch.models import model_zoo
from repro_torch.train import checkpoint, step
from repro_torch.train.trainer import Trainer

# the reference script's model (tests/torch_tp_reference.py)
SHAPE = dict(d_model=512, num_heads=4, num_kv_heads=4, head_dim=128,
             d_ff=1024, vocab_size=1024, num_layers=4)
BATCH, SEQ, LR, RANK = 4, 16, 1e-2, 8


def config():
    return replace(model_zoo.get_config("llama-60m", smoke=True), **SHAPE)


def qcfg(**kw):
    base = dict(rank=RANK, min_dim=32, compress_dp_grads=True)
    base.update(kw)
    return preset("qgalore", QGaLoreConfig(**base))


def bundle(groups=None):
    return model_zoo.build(config(), device="cpu", dtype=torch.float32,
                           tp_group=None if groups is None or groups.tp == 1
                           else groups.model)


def trainer(groups=None, zero=False, steps=4, checkpoint_dir="",
            method="svd"):
    """The test model, f32, refreshes at steps 0 and 3."""
    torch.set_num_threads(1)
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, steps=steps,
                       learning_rate=LR, warmup_steps=1, grad_clip=1.0,
                       log_every=0, checkpoint_dir=checkpoint_dir,
                       async_checkpoint=False)
    return Trainer(bundle(groups), tcfg,
                   qcfg(update_interval=3, adaptive=False,
                        subspace_method=method),
                   param_dtype=torch.float32, group=groups, zero_shard=zero)


def randomized_routes(groups) -> dict:
    """The randomized subspace of a (3, 96, 160) gradient sharded on its
    surviving dim, from the shards (``projector.randomized_sharded``)
    against the whole gradient's (``compute_subspace``), both sides: a
    spectrum falling by halves, so the top 8 directions are well apart,
    and each column signed as the whole's before the entries compare."""
    from repro_torch.core import projector
    out = {}
    for side, shard_dim in (("left", 1), ("right", 0)):
        m, n = (96, 160) if side == "left" else (160, 96)
        g = torch.Generator().manual_seed(7)
        k = min(m, n)
        U = torch.linalg.qr(torch.randn((3, m, k), generator=g))[0]
        V = torch.linalg.qr(torch.randn((3, n, k), generator=g))[0]
        s = 0.5 ** torch.arange(k, dtype=torch.float32)
        G = (U * s) @ V.transpose(-1, -2)
        omega = torch.randn((3,) + projector.omega_shape((m, n), 8, side),
                            generator=g)
        whole = projector.compute_subspace(G, 8, side, "randomized", omega)
        mine = projector.randomized_sharded(
            projector.shard_matrix(G, shard_dim, groups.model.rank, 2)
            .contiguous(), 8, side, shard_dim, omega, groups.model.rank,
            groups.model.all_reduce_sum,
            lambda t: groups.model.all_gather(t, t.ndim - 1))
        sign = torch.sign((mine * whole).sum(-2, keepdim=True))
        out[side] = {"max_abs_diff": float((mine * sign - whole).abs().max()),
                     "similarity": projector.subspace_similarity(
                         mine, whole).min().item()}
    return out


def reference_steps(groups, ref: dict) -> dict:
    """The reference's one-device steps (a refresh with every layer masked,
    then steady ones) from its init, on its batches and SR draws, on this
    rank's slices; fresh singular vectors signed as the reference's. The
    model group's bytes of the last (steady) step are counted. Without
    ``compress_dp_grads`` every sharded leaf refreshes after the clip on
    its gathered gradient, as the reference's one device does (the
    distributed refresh clips the low-rank payload instead, the
    reference's ``dp_compress`` mode)."""
    from repro_torch.serve.params import from_jax_state
    q = qcfg(compress_dp_grads=False)
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, grad_clip=1.0)
    whole = from_jax_state(ref["init"], device="cpu")
    specs = tp.plan_specs(qgalore.leaf_specs(whole.params, q), groups.tp,
                          config())
    local = tp.local_specs(specs)
    rank = groups.model.rank
    state = step.TrainState(
        tp.shard_params(whole.params, specs, groups.shape, rank),
        tp.shard_opt(whole.opt, specs, rank))
    ref_p = {s.path: P for s, (_, P) in zip(
        specs, qgalore.flatten(ref["proj"]))}

    def align(path, g, P_new, units):
        want = quant.dequantize(quant.from_numpy(ref_p[path], "cpu"),
                                torch.float32)
        want = want.reshape((-1,) + tuple(want.shape[-2:]))[units]
        sign = torch.sign((P_new * want).sum(dim=-2, keepdim=True))
        return P_new * torch.where(sign == 0, 1.0, sign)
    qgalore.SUBSPACE_HOOK = align
    fn = step.build_train_step(bundle(groups), q, tcfg, local, group=groups)
    draw = dp._jax_uniforms(0)
    out = {"losses": [], "dist_refresh": fn.dist_refresh,
           "psum": fn.psum_leaves,
           "sharded": [s.path for s in specs if s.shard_dim is not None]}
    for s, batch in enumerate(ref["batches"]):
        masks = {i: np.ones((sp.nbatch,), bool)
                 for i, sp in enumerate(specs) if sp.galore} if s == 0 \
            else None
        groups.model.reset_stats()
        state, met, om = fn(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                            LR, s, draw, masks)
        out["losses"].append(float(met["loss"]))
        if s == 0:
            out["sims"] = om["sims"]
            P = tp.gather_opt(state.opt, local, groups.model).proj
            out["proj"] = {sp.path: p.q.numpy().copy()
                           for sp, p in zip(specs, P) if p is not None}
    qgalore.SUBSPACE_HOOK = None
    out["model_bytes"] = sum(v[1] for v in groups.model.stats.values())
    out["model_calls"] = {k: int(v[0]) for k, v in groups.model.stats.items()}
    out["payload"] = qgalore.tp_payload_bytes(config(), specs, BATCH, SEQ,
                                              act_bytes=4)
    out["codes"] = dp.codes(step.TrainState(
        tp.gather_params(state.params, local, groups.model), state.opt))
    return out


def wait_for(path: str, timeout_s: float = 600.0) -> dict:
    """The reference's run, once its process has written it (or raised)."""
    import os
    import pickle
    import time
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if os.path.exists(path + ".err"):
            with open(path + ".err") as f:
                raise RuntimeError("the reference's run failed:\n" + f.read())
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference run at {path}")
        time.sleep(0.2)
    with open(path, "rb") as f:
        return pickle.load(f)


def tp_runs(comm, ref_path: str, save_dir: str) -> dict:
    """On two ranks, while the reference's process runs: the randomized
    subspace from shards; the trainer's 4-step (1, 2) runs (exact and
    randomized); a (1, 2) run saved after step 1 and run on to step 2,
    that checkpoint restored on the (2, 1) mesh and its step 2; then the
    reference's steps on the (1, 2) mesh, once its run is written."""
    torch.set_num_threads(1)
    groups = mesh_comms(comm, (1, 2))
    out = {"routes": randomized_routes(groups)}
    out["plain"] = dp.run(trainer(groups))
    out["randomized"] = dp.run(trainer(groups, method="randomized"))
    t = trainer(groups, steps=2, checkpoint_dir=save_dir)
    t.run()
    out["saved"] = checkpoint.state_arrays(t.whole_state())
    t.mgr = None
    out["next_loss"] = t.run(3)[-1]["loss"]
    dp_groups = mesh_comms(comm, (2, 1))
    r = trainer(dp_groups, steps=3, checkpoint_dir=save_dir)
    assert r.maybe_restore() == 2
    r.mgr = None
    out["restored_dp_loss"] = r.run(3)[-1]["loss"]
    out["reference"] = reference_steps(groups, wait_for(ref_path))
    return out


def zero_run(comm) -> dict:
    """Four ranks on the (2, 2) mesh, ZeRO with ZeRO-2."""
    torch.set_num_threads(1)
    t = trainer(mesh_comms(comm, (2, 2)), zero=True)
    out = dp.run(t)
    out["zero2"] = len(t._step.zero2_dims)
    return out


# ---------------------------------------------------------------------------
# expert parallelism (test_torch_ep.py)
# ---------------------------------------------------------------------------

EP_ARCH = "qwen3-moe-30b-a3b"


def ep_trainer(comm=None, ep=False, steps=3):
    """The MoE's smoke config (E 8, top-2), f32, rank 8, a refresh at
    steps 0 and 2; with ``ep`` its experts split over ``comm``."""
    torch.set_num_threads(1)
    b = model_zoo.build_arch(EP_ARCH, smoke=True, device="cpu",
                             dtype=torch.float32,
                             ep_group=comm if ep else None)
    tcfg = TrainConfig(global_batch=4, seq_len=16, steps=steps,
                       learning_rate=LR, warmup_steps=1, grad_clip=1.0,
                       log_every=0)
    q = preset("qgalore", QGaLoreConfig(rank=8, min_dim=16,
                                        compress_dp_grads=True,
                                        update_interval=2, adaptive=False))
    return Trainer(b, tcfg, q, param_dtype=torch.float32, group=comm)


def ep_layer(comm, p: dict, x: np.ndarray, w: np.ndarray) -> dict:
    """``moe_apply_ep`` on this rank's rows of ``x`` (its experts of the
    float layer ``p``), the loss ``sum(out * w) / tokens`` of its rows,
    and the gradients of its expert stacks and rows."""
    from repro_torch.models import moe
    torch.set_num_threads(1)
    cfg = model_zoo.get_config(EP_ARCH, smoke=True)
    rows = x.shape[0] // comm.world
    lo = comm.rank * rows
    local = moe.expert_slice({k: torch.from_numpy(v) for k, v in p.items()},
                             comm.rank, comm.world)
    local = {k: v.clone().requires_grad_(True) for k, v in local.items()}
    xl = torch.from_numpy(x[lo:lo + rows]).requires_grad_(True)
    out, aux = moe.moe_apply_ep(local, xl, cfg, comm, dtype=torch.float32)
    wl = torch.from_numpy(w[lo:lo + rows])
    loss = (out * wl).sum() / (out.shape[0] * out.shape[1])
    loss.backward()
    return {"out": out.detach().numpy(), "aux": float(aux),
            "grads": {k: v.grad.numpy() for k, v in local.items()},
            "dx": xl.grad.numpy(), "rows": (lo, lo + rows)}


def ep_runs(comm) -> dict:
    """The MoE trained expert-parallel over ``comm``, then plain
    data-parallel in the same group; ``grads``: the owned expert stacks'
    gradients as step 0's reduction leaves them, by path."""
    ep = ep_trainer(comm, ep=True)
    grads, reduce = {}, step._reduce

    def capture(comm_, specs, loss, metrics, g_flat, *args):
        out = reduce(comm_, specs, loss, metrics, g_flat, *args)
        if not grads:
            grads.update({specs[i].path: g_flat[i].numpy().copy()
                          for i in out[2]})
        return out
    step._reduce = capture
    try:
        out = {"ep": dp.run(ep), "grads": grads,
               "experts": [s.shape for s in ep.local_specs
                           if tp.is_expert(s.path)]}
    finally:
        step._reduce = reduce
    out["dp"] = dp.run(ep_trainer(comm))
    return out


def card_run(comm, which: str) -> dict:
    """On the card: the tensor-parallel test model (on the (1, 2) mesh
    over ``comm``) or the MoE's smoke config (expert-parallel over
    ``comm``), 4 steps in bf16; None trains one process. Its losses and
    the launches of each kernel and plain version."""
    from repro_torch.kernels import LAUNCHES
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    tcfg = TrainConfig(global_batch=BATCH, seq_len=SEQ, steps=4,
                       learning_rate=LR, warmup_steps=1, grad_clip=1.0,
                       log_every=0)
    if which == "tp":
        groups = None if comm is None else mesh_comms(comm, (1, 2))
        b = model_zoo.build(config(), device="cuda", dtype=torch.bfloat16,
                            tp_group=None if groups is None
                            else groups.model)
        q = qcfg(update_interval=3, adaptive=False)
    else:
        groups = comm
        b = model_zoo.build_arch(EP_ARCH, smoke=True, device="cuda",
                                 dtype=torch.bfloat16, ep_group=comm)
        q = preset("qgalore", QGaLoreConfig(rank=8, min_dim=16,
                                            compress_dp_grads=True,
                                            update_interval=3,
                                            adaptive=False))
    t = Trainer(b, tcfg, q, group=groups)
    LAUNCHES.clear()
    return {"losses": [h["loss"] for h in t.run()],
            "launches": dict(LAUNCHES)}


def card_runs(comm) -> dict:
    return {"tp": card_run(comm, "tp"), "ep": card_run(comm, "ep")}
