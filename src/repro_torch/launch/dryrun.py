"""The dry run of every (architecture × cell × mesh), without a device: the
counterpart of ``repro/launch/dryrun.py``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama-1b \\
        --cell decode_32k --mesh 16x16 [--compress] [--out build/dryrun]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all

The reference lowers and compiles each cell for a 256- or 512-chip mesh
and reads XLA's memory and cost analysis and the collectives of its HLO.
Torch has no such compiler, so this run allocates nothing and compiles
nothing: sizes come from shapes (``meta`` tensors and
``distributed/sharding.py``'s and ``serve/shard.py``'s partitions), work
from ``analysis.analytic``. Each artifact has the reference's keys where
the port can compute them:

* ``arch``, ``cell``, ``mesh``, ``kind``, ``refresh``, ``compress``,
  ``ok``; ``params`` and ``active_params`` (``model_zoo.count_params`` /
  ``count_active_params``); ``model_flops`` (6·N_active·tokens to train,
  2·N_active·tokens to prefill, 2·N_active·batch to decode);
* ``memory_analysis.argument_size_in_bytes``: the bytes one rank holds of
  the step's inputs, each leaf cut by its partition: for a train cell the
  state (``param_sharding``, ``opt_state_sharding``) and the batch
  (``data_sharding``); for a prefill cell the INT8 parameters and the
  batch; for a decode cell the parameters, the decode state
  (``serve.shard.decode_state_sharding``) and the tokens;
* ``cost_analysis``: ``flops`` and ``bytes accessed`` a chip, the cell's
  ``analytic.cell_flops`` and ``cell_bytes`` over the mesh's chips;
* ``collectives`` for a train cell, analytic and labelled so: the data
  group's all-reduce a replica (``qgalore.dp_payload_bytes`` with
  ``--compress``, else every trained gradient in float32) and the model
  group's bytes a rank (``qgalore.tp_payload_bytes`` on the tensor-parallel
  plan, for the families the port splits; another family's refusal is
  recorded instead).

It leaves out ``compile_s``, ``hlo_ops`` and ``hlo_chars``, and
``memory_analysis``'s temp, output and generated-code sizes: they read
XLA's compiled program, which the port has none of. The collective counts
of real runs come from ``distributed.comm.Comm``'s counters.
``analysis.roofline.from_artifact`` / ``table`` and
``analysis.report.dryrun_table`` read the artifacts with the H100's rates.
``--all`` runs every cell of every architecture but the LLaMA configs on
both production meshes, in this process (no device flag to isolate).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import traceback
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from repro_torch.analysis import analytic
from repro_torch.config import QGaLoreConfig, cells_for_arch
from repro_torch.core import qgalore
from repro_torch.core.adam8bit import Adam8bitState
from repro_torch.core.quant import QTensor
from repro_torch.distributed import sharding as shard_lib
from repro_torch.distributed import tp as tp_lib
from repro_torch.distributed.sharding import axes_of
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model_zoo
from repro_torch.serve import engine, shard
from repro_torch.train import step as step_lib

QCFG = QGaLoreConfig(rank=128)    # the paper's production optimizer settings
PRODUCTION = {"16x16": ((16, 16), ("data", "model")),
              "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def mesh_for(name: str):
    """``16x16``, ``2x16x16`` (the reference's production meshes) or any
    ``DxM``."""
    if name in PRODUCTION:
        return make_mesh(*PRODUCTION[name])
    try:
        d, m = (int(x) for x in name.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {name!r}: expected 16x16, 2x16x16 or "
                         "DxM") from None
    return make_mesh((d, m))


def _cut(arr, part, mesh) -> int:
    """Bytes of one rank's shard of ``arr`` under partition ``part``."""
    shape = list(arr.shape)
    for i, p in enumerate(part or ()):
        n = math.prod(mesh.shape[a] for a in axes_of(p))
        if shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(arr.shape)} does not split "
                             f"over {n} ranks ({part})")
        shape[i] //= n
    return math.prod(shape) * arr.element_size()


def leaf_bytes(leaf, part, mesh) -> int:
    """A leaf's bytes on one rank: a QTensor's codes, scales and zeros
    each by its own partition (a ``QSpec``), an 8-bit Adam state's two
    moments."""
    if leaf is None:
        return 0
    if isinstance(leaf, Adam8bitState):
        return leaf_bytes(leaf.m, part.m, mesh) + \
            leaf_bytes(leaf.v, part.v, mesh)
    if isinstance(leaf, QTensor):
        return _cut(leaf.q, part.q, mesh) + \
            _cut(leaf.scale, part.scale, mesh) + \
            (0 if leaf.zero is None else _cut(leaf.zero, part.zero, mesh))
    return _cut(leaf, part, mesh)


def tree_bytes(tree, parts, mesh) -> int:
    """Every leaf of a nested dict against a like tree of partitions."""
    return sum(leaf_bytes(leaf, part, mesh) for (_, leaf), (_, part) in
               zip(qgalore.flatten(tree), qgalore.flatten(parts)))


def batch_bytes(specs: Dict[str, tuple], mesh) -> int:
    parts = shard_lib.data_sharding({k: s for k, (s, _) in specs.items()},
                                    mesh)
    return sum(leaf_bytes(torch.empty(s, dtype=dt, device="meta"), parts[k],
                          mesh) for k, (s, dt) in specs.items())


def _dp_tp(mesh):
    dp = math.prod(mesh.shape[a] for a in shard_lib.batch_axes(mesh))
    return dp, mesh.shape.get("model", 1)


def train_collectives(cfg, cell, specs, mesh, compress: bool) -> dict:
    """The analytic bytes of a train step's collectives a rank."""
    D, t = _dp_tp(mesh)
    if compress:
        dp = qgalore.dp_payload_bytes(specs)
    else:
        dp = 4 * sum(math.prod(s.shape) for s in specs if not s.frozen)
    out = {"analytic": True,
           "data": {"all-reduce": dp if D > 1 else 0,
                    "source": "qgalore.dp_payload_bytes" if compress else
                    "every trained gradient, float32"}}
    model = 0
    if t > 1:
        try:
            model_zoo.check_parallel(cfg, SimpleNamespace(world=t))
            model = qgalore.tp_payload_bytes(
                cfg, tp_lib.plan_specs(specs, t, cfg),
                max(cell.global_batch // D, 1), cell.seq_len)
            out["model"] = {"bytes": model,
                            "source": "qgalore.tp_payload_bytes"}
        except NotImplementedError as e:
            out["model"] = {"bytes": None, "refused": str(e)}
    out["total"] = {"count": None, "bytes": out["data"]["all-reduce"]
                    + (model or 0)}
    return out


def run_cell(arch: str, cell_name: str, mesh_name: str = "16x16",
             compress: bool = False) -> dict:
    """One (arch × cell × mesh)'s artifact."""
    mesh = mesh_for(mesh_name)
    cfg = model_zoo.get_config(arch)
    cell = next(c for c in cells_for_arch(arch) if c.name == cell_name)
    shard_lib.set_ep_full_mesh(
        compress and cell.kind == "train" and cfg.moe is not None
        and cfg.moe.num_experts % mesh.shape["data"] == 0)
    bundle = model_zoo.build(cfg, device="meta", dtype=torch.bfloat16)
    art = {"arch": arch, "cell": cell_name, "mesh": mesh_name,
           "kind": cell.kind, "refresh": False, "compress": compress,
           "params": model_zoo.count_params(cfg),
           "active_params": model_zoo.count_active_params(cfg),
           "chips": mesh.size, "ok": False}
    qcfg = QCFG
    try:
        if cell.kind == "train":
            state = step_lib.abstract_state(bundle, qcfg, torch.bfloat16)
            specs = qgalore.leaf_specs(state.params, qcfg)
            o_sh = shard_lib.opt_state_sharding(state.params, state.opt,
                                                qcfg, mesh, specs=specs)
            arg = tree_bytes(state.params, shard_lib.param_sharding(
                state.params, mesh), mesh)
            arg += sum(leaf_bytes(x, p, mesh) for x, p in zip(
                state.opt.inner + state.opt.proj, o_sh.inner + o_sh.proj))
            arg += batch_bytes(bundle.input_specs(cell), mesh)
            art["collectives"] = train_collectives(cfg, cell, specs, mesh,
                                                   compress)
            art["model_flops"] = 6.0 * art["active_params"] \
                * cell.global_batch * cell.seq_len
        else:
            params = step_lib.abstract_params(bundle, qcfg, torch.bfloat16)
            arg = tree_bytes(params, shard_lib.param_sharding(params, mesh),
                             mesh)
            if cell.kind == "prefill":
                arg += batch_bytes(bundle.input_specs(cell), mesh)
                art["model_flops"] = 2.0 * art["active_params"] \
                    * cell.global_batch * cell.seq_len
            else:
                st = engine.abstract_decode_state(
                    bundle, cell.global_batch, cell.seq_len, torch.bfloat16)
                sd = shard.decode_state_sharding(st, mesh)
                for k, leaves in st.caches.items():
                    arg += sum(leaf_bytes(x, p, mesh)
                               for x, p in zip(leaves, sd.caches[k]))
                arg += sum(leaf_bytes(v, sd.extras[k], mesh)
                           for k, v in st.extras.items())
                arg += leaf_bytes(st.lengths, sd.lengths, mesh)
                arg += batch_bytes({"t": ((cell.global_batch, 1),
                                          torch.int32)}, mesh)
                art["model_flops"] = 2.0 * art["active_params"] \
                    * cell.global_batch
        art["memory_analysis"] = {"argument_size_in_bytes": int(arg)}
        art["cost_analysis"] = {
            "flops": analytic.cell_flops(cfg, cell) / mesh.size,
            "bytes accessed": analytic.cell_bytes(cfg, cell) / mesh.size,
            "analytic": True}
        art["ok"] = True
    finally:
        shard_lib.set_ep_full_mesh(False)
    return art


def out_path(out_dir: str, arch: str, cell: str, mesh: str) -> str:
    return os.path.join(out_dir, mesh, f"{arch}__{cell}.json")


def write(art: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(art, f, indent=1)


def run_and_write(arch: str, cell: str, mesh: str, compress: bool,
                  out: str) -> Optional[dict]:
    """One cell's artifact written to ``out``; a failing cell writes
    ``ok: False`` with its traceback, and the error is raised."""
    path = out_path(out, arch, cell, mesh)
    try:
        art = run_cell(arch, cell, mesh, compress)
    except Exception:
        write({"arch": arch, "cell": cell, "mesh": mesh, "ok": False,
               "error": traceback.format_exc()[-3000:]}, path)
        raise
    write(art, path)
    print("wrote", path)
    return art


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--cell")
    ap.add_argument("--mesh", default="16x16",
                    help="16x16, 2x16x16 or DxM")
    ap.add_argument("--compress", action="store_true",
                    help="the data group's compressed low-rank payload")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--all", action="store_true",
                    help="every cell of every architecture but the LLaMA "
                         "configs, on both production meshes")
    ap.add_argument("--skip-existing", type=int, default=1)
    args = ap.parse_args(argv)
    if not args.all:
        if not (args.arch and args.cell):
            ap.error("--arch and --cell (or --all)")
        run_and_write(args.arch, args.cell, args.mesh, args.compress,
                      args.out)
        return 0
    failures = []
    for mesh in PRODUCTION:
        for arch in model_zoo.ARCH_IDS:
            if arch.startswith("llama-"):
                continue
            for cell in cells_for_arch(arch):
                path = out_path(args.out, arch, cell.name, mesh)
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {path}")
                    continue
                try:
                    run_and_write(arch, cell.name, mesh, args.compress,
                                  args.out)
                except Exception as e:          # noqa: BLE001 — recorded
                    failures.append((arch, cell.name, mesh))
                    print(f"[failed] {path}: {e}", file=sys.stderr)
    print(f"done; {len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
