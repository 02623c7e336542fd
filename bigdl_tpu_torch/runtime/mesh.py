"""The process mesh — the port of ``bigdl_tpu.runtime.mesh`` over
``torch.distributed``.

The JAX package lays its logical axes (``dcn_data``, ``data``,
``model``, ``seq``, ``expert``, ``pipe``) over ``jax.devices()``; here
one process drives one device, so the mesh is the process group: its
world size, this process's rank and device, and the sizes and groups of
the two data axes.  ``dcn_data`` (the slice count of a multislice job)
is the outer one: ranks are laid out ``(dcn_data, data)`` row-major, so
rank ``r`` is JAX device ``r`` of ``build_mesh`` (the DCN axis
outermost) and its data replica index is ``r`` itself.  The ICI group
holds the ranks of one slice, the DCN group the ranks with the same
data index; every rank creates every group, in one order.  The other
axes may not exceed 1 here: each raises, naming the ROADMAP item that
brings it (the declarative ``tp`` axis lives on another mesh,
``parallel.mesh_policy``), and ``dcn_data = 0`` (auto) resolves to 1
(no slice topology here; ``BIGDL_TPU_DCN_SLICES`` sets it)."""

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
    AXIS_MODEL: "ROADMAP A.6.6 (parallel/tp.py, the manual tensor "
                "parallelism; the declarative tp axis is "
                "parallelism='tp:N')",
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
    this one ``rank`` on ``device``; ``group`` spans every process (None
    without ``torch.distributed``), ``ici_group`` the ranks of this
    rank's slice (the ``data`` axis) and ``dcn_group`` the ranks of its
    data index across slices (None with one slice); ``shape`` the
    resolved axis sizes."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    shape: Dict[str, int] = field(default_factory=dict)
    ici_group: Optional[Any] = None
    dcn_group: Optional[Any] = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def data_size(self) -> int:
        """Ranks on the ICI data axis (one slice)."""
        return self.shape.get(AXIS_DATA, 1)

    @property
    def dcn_size(self) -> int:
        return self.shape.get(AXIS_DCN, 1)

    @property
    def data_index(self) -> int:
        """This rank's index on the data axis (within its slice)."""
        return self.rank % self.data_size

    @property
    def dcn_index(self) -> int:
        return self.rank // self.data_size


def build_mesh(spec: Optional[MeshSpec] = None,
               device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the default process group (one process alone when
    ``torch.distributed`` is not initialized).  Every axis but
    ``dcn_data`` and ``data`` must be 1, and the two span every process;
    with ``dcn_data > 1`` every rank creates the ICI and DCN groups."""
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
    data, dcn = sizes[AXIS_DATA], sizes[AXIS_DCN]
    if data * dcn != world:
        raise ValueError(
            f"mesh dcn_data={dcn} x data={data} over {world} processes: "
            f"the data axes span every process (one device a process)")
    ici, across = group, None
    if dcn > 1:
        # one order on every rank: the slices' groups, then the groups
        # of each data index across slices
        for d in range(dcn):
            g = dist.new_group(list(range(d * data, (d + 1) * data)))
            if d == rank // data:
                ici = g
        for i in range(data):
            g = dist.new_group(list(range(i, world, data)))
            if i == rank % data:
                across = g
    return Mesh(world, rank, torch.device(device or "cpu"), group, sizes,
                ici_group=ici, dcn_group=across)


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
    """The data-parallel degree over both data axes (dcn_data x data),
    the JAX step's ``_batch_axes``."""
    return mesh.data_size * mesh.dcn_size


def local_batch_slice(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """(this process's batch start, size) of a global batch: replica
    ``data_index + data * dcn_index``, which is the rank."""
    n = data_axis_size(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} % data replicas "
                         f"{n} != 0")
    per = global_batch // n
    return (mesh.data_index + mesh.data_size * mesh.dcn_index) * per, per
