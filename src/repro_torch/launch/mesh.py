"""Meshes of the port (the counterpart of ``repro/launch/mesh.py``): a
:class:`~repro_torch.distributed.sharding.Mesh` names the axes over which
the ranks of a process group split the work.

The port runs data parallelism only: a ``(D, 1)`` ``("data", "model")``
mesh, one rank a data shard. A mesh whose ``model`` axis is above 1
(tensor or expert parallelism) is refused by name: ROADMAP queue 1
sub-slice 5b. The reference's ``force_host_device_count`` has no
counterpart: a CPU run is D gloo processes (``launch/train.py
--devices D``).
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.distributed.sharding import Mesh

TP_REFUSAL = ("tensor and expert parallelism (a mesh whose model axis is "
              "above 1) are not ported: ROADMAP queue 1 sub-slice 5b")


def make_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model")
              ) -> Mesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    mesh = Mesh(shape, axes)
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(f"mesh {mesh.shape}: {TP_REFUSAL}")
    return mesh


def make_dp_mesh(world: int) -> Mesh:
    """The ``(world, 1)`` data-parallel mesh."""
    if world < 1:
        raise ValueError(f"a data-parallel mesh needs at least one rank, "
                         f"got {world}")
    return make_mesh((world, 1))


def make_tp_mesh(tp: int, num_devices: int = 0) -> Mesh:
    raise NotImplementedError(f"--tp {tp}: {TP_REFUSAL}")


def parse_mesh(text: str) -> Mesh:
    """``"4x1"`` → the (4, 1) ``("data", "model")`` mesh."""
    try:
        d, m = (int(x) for x in text.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DxM, e.g. 4x1") from None
    return make_mesh((d, m))
