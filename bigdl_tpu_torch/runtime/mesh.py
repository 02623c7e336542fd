"""The process mesh — the port of ``bigdl_tpu.runtime.mesh`` over
``torch.distributed``.

The JAX package lays its logical axes (``dcn_data``, ``data``,
``model``, ``seq``, ``expert``, ``pipe``) over ``jax.devices()``; here
one process drives one device, so the mesh is the process group: its
world size, this process's rank and device, and the sizes and groups of
the data and sequence axes.  Ranks lie in the JAX axis order, row-major:
``(dcn_data, data, seq)``, so rank ``r = (dcn_index * data +
data_index) * seq + seq_index`` is JAX device ``r`` of ``build_mesh``
and holds its shards.  The ICI group holds the ranks of one slice with
this rank's sequence index (the ``data`` axis, the ZeRO-1 cycle), the
DCN group the ranks with this data and sequence index across slices,
the sequence group the ranks of this rank's data replica (the ``seq``
axis: ring and Ulysses attention); every rank creates every group, in
one order.  The ``model``, ``expert`` and ``pipe`` axes may not exceed
1 here: each raises, naming the ROADMAP item that brings it (the
declarative ``tp`` axis lives on another mesh,
``parallel.mesh_policy``), and ``dcn_data = 0`` (auto) resolves to 1
(no slice topology here; ``BIGDL_TPU_DCN_SLICES`` sets it).

:func:`seq_axis` is the port's counterpart of a ``shard_map`` carrying
the ``seq`` axis: the sequence-parallel step enters it around the
model's forward, and :func:`bound_seq_axis` is how a layer asks whether
it runs inside one (JAX's ``_axis_bound``)."""

import threading
from contextlib import contextmanager
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
    rank's slice and sequence index (the ``data`` axis), ``dcn_group``
    the ranks of its data and sequence index across slices (None with
    one slice) and ``seq_group`` the ranks of its data replica (None
    without a ``seq`` axis); ``shape`` the resolved axis sizes."""

    world_size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None
    shape: Dict[str, int] = field(default_factory=dict)
    ici_group: Optional[Any] = None
    dcn_group: Optional[Any] = None
    seq_group: Optional[Any] = None

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
    def seq_size(self) -> int:
        return self.shape.get(AXIS_SEQ, 1)

    @property
    def seq_index(self) -> int:
        """This rank's index on the seq axis (its sequence block)."""
        return self.rank % self.seq_size

    @property
    def data_index(self) -> int:
        """This rank's index on the data axis (within its slice)."""
        return (self.rank // self.seq_size) % self.data_size

    @property
    def dcn_index(self) -> int:
        return self.rank // (self.data_size * self.seq_size)

    @property
    def data_replicas(self) -> int:
        """The data-parallel degree (dcn_data x data)."""
        return self.data_size * self.dcn_size

    @property
    def replica_index(self) -> int:
        """This rank's data replica, ``data_index + data * dcn_index``:
        the batch plan a rank trains on (the ranks of one replica share
        it and split its sequence)."""
        return self.data_index + self.data_size * self.dcn_index


def build_mesh(spec: Optional[MeshSpec] = None,
               device: Optional[torch.device] = None) -> Mesh:
    """The mesh over the default process group (one process alone when
    ``torch.distributed`` is not initialized).  Every axis but
    ``dcn_data``, ``data`` and ``seq`` must be 1, and the three span
    every process; with ``dcn_data > 1`` or ``seq > 1`` every rank
    creates the ICI, DCN and sequence groups."""
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
                             f"({item}); only the data and seq axes may "
                             f"exceed 1")
    sizes = spec.resolve(world)
    data, dcn, seq = sizes[AXIS_DATA], sizes[AXIS_DCN], sizes[AXIS_SEQ]
    if data * dcn * seq != world:
        raise ValueError(
            f"mesh dcn_data={dcn} x data={data} x seq={seq} over {world} "
            f"processes: the data and seq axes span every process (one "
            f"device a process)")
    ici, across, seq_g = group, None, None
    if dcn > 1 or seq > 1:
        # one order on every rank: the data-axis groups of each (slice,
        # sequence index), then the groups across slices of each (data
        # index, sequence index), then each replica's sequence group
        mine = rank // (data * seq), (rank // seq) % data, rank % seq
        for d in range(dcn):
            for s in range(seq):
                g = dist.new_group([(d * data + i) * seq + s
                                    for i in range(data)])
                if (d, s) == (mine[0], mine[2]):
                    ici = g
        if dcn > 1:
            for i in range(data):
                for s in range(seq):
                    g = dist.new_group([(d * data + i) * seq + s
                                        for d in range(dcn)])
                    if (i, s) == mine[1:]:
                        across = g
        if seq > 1:
            for r in range(dcn * data):
                g = dist.new_group(list(range(r * seq, (r + 1) * seq)))
                if r == rank // seq:
                    seq_g = g
    return Mesh(world, rank, torch.device(device or "cpu"), group, sizes,
                ici_group=ici, dcn_group=across, seq_group=seq_g)


@dataclass(frozen=True)
class SeqAxis:
    """A bound ``seq`` axis: its name, the process group of the ranks
    that hold one sequence's blocks (None: this process alone), this
    rank's block index and the block count."""

    name: str
    group: Optional[Any]
    index: int
    size: int


_seq_axes = threading.local()


@contextmanager
def seq_axis(group, index: int, size: int, name: str = AXIS_SEQ):
    """Bind the ``seq`` axis ``name`` for the calling thread: inside,
    sequence-parallel layers (``nn.attention``) see their block as block
    ``index`` of ``size`` and exchange with ``group``."""
    stack = getattr(_seq_axes, "stack", None)
    if stack is None:
        stack = _seq_axes.stack = []
    stack.append(SeqAxis(name, group, int(index), int(size)))
    try:
        yield stack[-1]
    finally:
        stack.pop()


def bound_seq_axis(name: str = AXIS_SEQ) -> Optional[SeqAxis]:
    """The innermost bound axis called ``name``, or None outside one."""
    for ax in reversed(getattr(_seq_axes, "stack", None) or ()):
        if ax.name == name:
            return ax
    return None


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
    return mesh.data_replicas


def local_batch_slice(mesh: Mesh, global_batch: int) -> Tuple[int, int]:
    """(this process's batch start, size) of a global batch: its
    replica's rows (``Mesh.replica_index``; the rank without a seq
    axis)."""
    n = data_axis_size(mesh)
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} % data replicas "
                         f"{n} != 0")
    per = global_batch // n
    return mesh.replica_index * per, per
