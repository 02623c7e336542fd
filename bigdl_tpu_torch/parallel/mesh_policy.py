"""``parallelism=`` policy strings -> a named layout mesh and a
SpecLayout — the port of ``bigdl_tpu.parallel.mesh_policy``.

The same combo-string grammar as the JAX package (the Estimator and
keras ``parallelism=`` key, ``EngineConfig.parallelism`` and
``BIGDL_TPU_PARALLELISM``), resolved against the live device set into a
``torch.distributed`` ``DeviceMesh`` with dims ``("data", "fsdp", "seq",
"tp")``, outer to inner, whose axes the layout tables (``parallel.
layout``) name.  One process drives one device, so the live devices are
the world's ranks: rank ``r`` sits at the mesh coordinate of JAX device
``r`` (a row-major layout).  Without a process group the world is this
process alone, and the mesh opens a group of one over an in-process
store (gloo on the CPU, NCCL on the card).

Grammar::

    spec     := axis ("," axis)*
    axis     := name (":" factor)?        # no factor = fill remaining
    name     := dp|data | fsdp | tp|mp|model | sp|seq

Errors are early and name everything: an unknown axis lists the valid
axis names; an over-subscribed product names the live device count."""

import logging
from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist

from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.parallel.layout import (
    AXIS_DATA, AXIS_FSDP, AXIS_SEQ, AXIS_TP, LAYOUT_AXES, ModelLayout,
    SpecLayout, layout_for_model, path_str, spec_to_placements)

log = logging.getLogger("bigdl_tpu_torch.parallel.mesh_policy")

# accepted spellings -> canonical axis name
AXIS_ALIASES: Dict[str, str] = {
    "dp": AXIS_DATA, "data": AXIS_DATA,
    "fsdp": AXIS_FSDP,
    "tp": AXIS_TP, "mp": AXIS_TP, "model": AXIS_TP,
    "sp": AXIS_SEQ, "seq": AXIS_SEQ,
}

# the DeviceMesh's dims, outer to inner (the JAX mesh's order)
MESH_ORDER = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ, AXIS_TP)

_FILL = -1  # "no factor": absorb the remaining devices


def _valid_axes() -> str:
    return ("dp/data, fsdp, tp (aliases mp/model), seq (alias sp)")


def parse_parallelism(spec: str) -> Dict[str, int]:
    """Combo string -> {canonical axis: factor}, ``-1`` marking the one
    fill axis.  Syntax only; :func:`resolve_parallelism` checks counts."""
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(
            f"parallelism spec must be a non-empty string like 'dp' or "
            f"'dp:4,tp:2', got {spec!r}")
    out: Dict[str, int] = {}
    fill_axis = None
    for token in spec.split(","):
        token = token.strip().lower()
        if not token:
            raise ValueError(
                f"parallelism {spec!r}: empty axis token (stray comma?)")
        name, _, factor = token.partition(":")
        axis = AXIS_ALIASES.get(name.strip())
        if axis is None:
            raise ValueError(
                f"parallelism {spec!r}: unknown axis {name.strip()!r} — "
                f"valid axes: {_valid_axes()}")
        if axis in out:
            raise ValueError(
                f"parallelism {spec!r}: axis {axis!r} given twice")
        if factor:
            try:
                f = int(factor)
            except ValueError:
                raise ValueError(
                    f"parallelism {spec!r}: factor {factor!r} for axis "
                    f"{axis!r} is not an integer") from None
            if f < 1:
                raise ValueError(
                    f"parallelism {spec!r}: factor {f} for axis {axis!r} "
                    "must be >= 1")
            out[axis] = f
        else:
            if fill_axis is not None:
                raise ValueError(
                    f"parallelism {spec!r}: only one axis may omit its "
                    f"factor (both {fill_axis!r} and {axis!r} did)")
            fill_axis = axis
            out[axis] = _FILL
    return out


def resolve_parallelism(spec: str, n_devices: int) -> Dict[str, int]:
    """{axis: size} for all four axes against ``n_devices`` live devices:
    the fill axis takes the rest; explicit factors over the count fail
    here, naming it; a sub-mesh warns that devices stay idle."""
    parsed = parse_parallelism(spec)
    explicit = int(np.prod([f for f in parsed.values() if f != _FILL])) \
        if parsed else 1
    if explicit > n_devices:
        named = ",".join(f"{a}:{f}" for a, f in parsed.items()
                         if f != _FILL)
        raise ValueError(
            f"parallelism {spec!r} over-subscribes the device set: "
            f"{named} needs {explicit} devices but only {n_devices} are "
            f"live (valid axes: {_valid_axes()})")
    sizes = {a: 1 for a in LAYOUT_AXES}
    fill = None
    for a, f in parsed.items():
        if f == _FILL:
            fill = a
        else:
            sizes[a] = f
    if fill is not None:
        if n_devices % explicit != 0:
            raise ValueError(
                f"parallelism {spec!r}: {n_devices} devices not divisible "
                f"by the explicit factors' product {explicit}, so the "
                f"fill axis {fill!r} has no integer size")
        sizes[fill] = n_devices // explicit
    elif explicit < n_devices:
        log.warning(
            "parallelism %r uses %d of %d live devices; %d device(s) "
            "stay idle (leave one axis unfactored to absorb the "
            "remainder)", spec, explicit, n_devices,
            n_devices - explicit)
    return sizes


def world_size() -> int:
    """The live devices: the world's ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _ensure_group(device: torch.device) -> None:
    """A process group of one over an in-process store when none is up
    (a mesh needs a group; one process needs no rendezvous)."""
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            store=dist.HashStore(), world_size=1, rank=0)


def build_layout_mesh(sizes: Dict[str, int], device=None):
    """The ``DeviceMesh`` over the layout axes, ordered (data, fsdp,
    seq, tp) outer to inner, over ranks ``0 .. prod(sizes) - 1``; every
    rank of the world builds it (it creates the dims' groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    _ensure_group(dev)
    shape = tuple(int(sizes.get(a, 1)) for a in MESH_ORDER)
    total = int(np.prod(shape))
    world = dist.get_world_size()
    if total > world:
        raise ValueError(
            f"layout mesh {dict(zip(MESH_ORDER, shape))} needs {total} "
            f"devices, {world} live")
    return DeviceMesh(dev.type, torch.arange(total).reshape(shape),
                      mesh_dim_names=MESH_ORDER)


def live_mesh(mesh, sizes: Dict[str, int], named=()):
    """The sub-mesh of the axes larger than 1 or ``named`` by the policy
    (the first axis when none is): DTensor's sharding propagation prices
    every mesh dim, and an unnamed size-1 one places nothing.  A named
    axis stays at size 1, so one device runs the policy's own placements
    (its ``Shard``s, each the whole tensor) through the same ops and
    ``local_map`` calls as a wider mesh."""
    live = tuple(a for a in MESH_ORDER if sizes.get(a, 1) > 1 or a in named)
    return mesh[live or MESH_ORDER[:1]]


@dataclass(frozen=True)
class ResolvedLayout:
    """A ``parallelism=`` policy resolved against the world: the mesh
    (all four axes), its live sub-mesh (the axes larger than 1 or named
    by the policy, where the DTensors live), the axis sizes and the
    SpecLayout."""

    parallelism: str
    mesh: Any
    spec_layout: SpecLayout
    sizes: Dict[str, int]
    dtensor_mesh: Any = None

    def table_for(self, model) -> ModelLayout:
        return layout_for_model(model, self.spec_layout)

    def shard_params(self, model, variables=None):
        """Make ``model``'s parameters DTensors on the mesh per its
        table, in place (after loading ``variables``, a JAX-keyed
        ``{"params", "state"}`` tree, when given); audited: silent
        replication sets the ``parallel.layout.replicated_params`` gauge
        and logs the paths.  Returns the model."""
        if variables is not None:
            from bigdl_tpu_torch.utils.convert import load_jax_variables

            load_jax_variables(model, variables)
        table = self.table_for(model)
        table.audit(model).export()
        return place_module(model, self.dtensor_mesh, table.spec_for)

    @property
    def n_batch_shards(self) -> int:
        """data x fsdp: what the global batch must divide by."""
        return int(self.sizes.get(AXIS_DATA, 1)
                   * self.sizes.get(AXIS_FSDP, 1))

    @property
    def model_sharded(self) -> bool:
        """True when parameters are split across devices (tp or fsdp)."""
        return (self.sizes.get(AXIS_TP, 1) > 1
                or self.sizes.get(AXIS_FSDP, 1) > 1)

    def describe(self) -> str:
        live = {a: n for a, n in self.sizes.items() if n > 1}
        return f"{self.parallelism!r} -> {live or {AXIS_DATA: 1}}"


def place_module(model, mesh, spec_for):
    """Replace ``model``'s parameters by DTensors on ``mesh`` in place:
    each one split per ``spec_for(path, ndim)[0]`` (its JAX path, as
    ``layout.path_str``), its buffers replicated; every rank takes its
    own shard of the same whole tensor, with no communication.  Returns
    the model."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")
    placed: Dict[int, torch.nn.Parameter] = {}   # a tied one once
    with torch.no_grad():
        for prefix, mod in model.named_modules():
            for name, p in list(mod.named_parameters(recurse=False)):
                if id(p) not in placed:
                    spec, _ = spec_for(path_str(
                        f"{prefix}.{name}" if prefix else name), p.ndim)
                    placed[id(p)] = torch.nn.Parameter(distribute_tensor(
                        p.detach().to(dev), mesh,
                        spec_to_placements(spec, mesh, tuple(p.shape)),
                        src_data_rank=None), requires_grad=p.requires_grad)
                setattr(mod, name, placed[id(p)])
            for name, b in list(mod.named_buffers(recurse=False)):
                if b is not None:
                    mod._buffers[name] = distribute_tensor(
                        b.to(dev), mesh, [Replicate()] * mesh.ndim,
                        src_data_rank=None)
    return model


def mesh_and_layout(parallelism: str, device=None) -> ResolvedLayout:
    """The entry point: combo string + the world's ranks ->
    ResolvedLayout (every rank calls it, in the same order)."""
    dev = resolve_device(device)
    _ensure_group(dev)
    sizes = resolve_parallelism(parallelism, world_size())
    mesh = build_layout_mesh(sizes, dev)
    return ResolvedLayout(parallelism=parallelism, mesh=mesh,
                          spec_layout=SpecLayout(), sizes=sizes,
                          dtensor_mesh=live_mesh(
                              mesh, sizes, parse_parallelism(parallelism)))
