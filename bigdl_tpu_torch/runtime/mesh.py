"""The process mesh — the port of ``bigdl_tpu.runtime.mesh`` over
``torch.distributed``.

The JAX package lays its logical axes (``dcn_data``, ``data``,
``model``, ``seq``, ``expert``, ``pipe``) over ``jax.devices()``; here
one process drives one device, so the mesh is the process group: its
world size, this process's rank and device, and the data axis's size
and group.  Only the ``data`` axis may exceed 1 so far: the other axes
raise, naming the ROADMAP item that brings them, and ``dcn_data = 0``
(auto) resolves to 1 (no slice topology here)."""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the JAX package's axis names
AXIS_DATA = "data"
AXIS_MODEL = "model"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"
AXIS_DCN = "dcn_data"

# axes that may not exceed 1 yet, and the ROADMAP item of each
_LATER = {
    AXIS_DCN: "ROADMAP A.2 (hierarchical DCN hop)",
    AXIS_MODEL: "ROADMAP A.2 (layout: parallel/layout.py, mesh_policy.py, "
                "gspmd.py)",
    AXIS_SEQ: "ROADMAP A.4 (sequence parallelism)",
    AXIS_EXPERT: "ROADMAP A.6.6 (parallel/moe.py)",
    AXIS_PIPE: "ROADMAP A.6.6 (parallel/pp.py)",
}


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape, as in the JAX package: ``data=-1`` fills the
    processes left after the other axes; ``dcn_data=0`` is the slice
    count (1 here)."""

    data: int = -1
    model: int = 1
    seq: int = 1
    expert: int = 1
    pipe: int = 1
    dcn_data: int = 0

    def resolve(self, n_devices: int, n_slices: int = 1) -> Dict[str, int]:
        dcn = self.dcn_data if self.dcn_data > 0 else n_slices
        fixed = {AXIS_MODEL: self.model, AXIS_SEQ: self.seq,
                 AXIS_EXPERT: self.expert, AXIS_PIPE: self.pipe}
        prod = int(np.prod(list(fixed.values()))) * dcn
        if self.data == -1:
            if n_devices % prod != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"dcn_data*model*seq*expert*pipe={prod}")
            data = n_devices // prod
        else:
            data = self.data
            if data * prod > n_devices:
                raise ValueError(
                    f"mesh {data}x{prod} exceeds device count {n_devices}")
        return {AXIS_DCN: dcn, AXIS_DATA: data, **fixed}


@dataclass
class Mesh:
    """The processes one training run spans: ``world_size`` processes,
    this one ``rank`` on ``device``; ``group`` is the data axis's process
    group (None without ``torch.distributed``); ``shape`` the resolved
    axis sizes."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    shape: Dict[str, int] = field(default_factory=dict)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def data_size(self) -> int:
        return self.shape.get(AXIS_DATA, 1)


def build_mesh(spec: Optional[MeshSpec] = None,
               device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the default process group (one process alone when
    ``torch.distributed`` is not initialized).  Every axis but ``data``
    must be 1, and the data axis spans every process."""
    spec = spec or MeshSpec()
    if dist.is_available() and dist.is_initialized():
        world, rank, group = (dist.get_world_size(), dist.get_rank(),
                              dist.group.WORLD)
    else:
        world, rank, group = 1, 0, None
    for axis, item in _LATER.items():
        size = getattr(spec, axis)
        if size > 1:
            raise ValueError(f"mesh axis {axis}={size}: not ported yet "
                             f"({item}); only the data axis may exceed 1")
    sizes = spec.resolve(world)
    if sizes[AXIS_DATA] != world:
        raise ValueError(
            f"mesh data={sizes[AXIS_DATA]} over {world} processes: the "
            f"data axis spans every process (one device a process)")
    return Mesh(world, rank, torch.device(device or "cpu"), group, sizes)


def mesh_fingerprint(mesh: Mesh) -> str:
    """The topology a process runs on: process count, platform, device
    kind and the axis sizes (the JAX fingerprint's fields)."""
    if mesh.device.type == "cuda":
        platform, kind = "gpu", torch.cuda.get_device_name(mesh.device)
    else:
        platform, kind = "cpu", "cpu"
    axes = "x".join(f"{a}={n}" for a, n in mesh.shape.items())
    return ":".join([str(mesh.world_size), platform, kind, axes])


def data_axis_size(mesh: Mesh) -> int:
    return mesh.data_size


def local_batch_slice(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """(this process's batch start, size) of a global batch."""
    if global_batch % mesh.world_size != 0:
        raise ValueError(f"global batch {global_batch} % processes "
                         f"{mesh.world_size} != 0")
    per = global_batch // mesh.world_size
    return mesh.rank * per, per
