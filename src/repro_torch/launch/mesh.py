"""Meshes of the port (the counterpart of ``repro/launch/mesh.py``): a
:class:`~repro_torch.distributed.sharding.Mesh` names the axes over which
the ranks of a process group split the work.

A ``(D, t)`` ``("data", "model")`` mesh runs data parallelism over D
shards and, where t is above 1, tensor parallelism over t ranks a shard;
``distributed.comm.mesh_comms`` lays the ranks out ``rank = d·t + m`` and
makes the groups. Expert parallelism runs on the data axis (an MoE bundle
built with ``ep_group=``). The reference's ``force_host_device_count``
has no counterpart: a CPU run is D·t gloo processes (``launch/train.py
--devices N``).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.distributed.sharding import Mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model")
              ) -> Mesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh {shape}: every axis needs at least one rank")
    return Mesh(shape, axes)


def make_dp_mesh(world: int) -> Mesh:
    """The ``(world, 1)`` data-parallel mesh."""
    if world < 1:
        raise ValueError(f"a data-parallel mesh needs at least one rank, "
                         f"got {world}")
    return make_mesh((world, 1))


def make_tp_mesh(tp: int, num_devices: int = 0) -> Mesh:
    """The 2-D ``(N/tp, tp)`` mesh over ``("data", "model")``: ``tp``-way
    tensor parallelism, data parallelism over the rest. ``tp`` must divide
    the device count (default ``tp``): a ragged split would drop ranks."""
    n = num_devices or tp
    if tp <= 0 or n % tp != 0:
        raise ValueError(
            f"tensor-parallel degree {tp} must be a positive divisor of "
            f"the device count {n} (got remainder {n % tp if tp > 0 else n})")
    return make_mesh((n // tp, tp))


def parse_mesh(text: str) -> Mesh:
    """``"4x1"`` → the (4, 1) ``("data", "model")`` mesh; ``"1x2"`` → two
    tensor-parallel ranks."""
    try:
        d, m = (int(x) for x in text.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 4x1") from None
    return make_mesh((d, m))
