"""Parallelism over ``torch.distributed`` — the port of
``bigdl_tpu.parallel``: the ZeRO-1 wire layer (``collectives``) and the
declarative layouts (``layout``, ``mesh_policy``, ``gspmd``: a
``parallelism=`` combo string over a DeviceMesh, the parameters
DTensors) and sequence parallelism on the flash kernels
(``ring_attention``, ``ulysses``).  The manual tp / pp / moe modules
are not ported (ROADMAP A.6.6)."""

from bigdl_tpu_torch.parallel import collectives
from bigdl_tpu_torch.parallel.layout import (ModelLayout, SpecLayout,
                                             layout_for_model,
                                             register_layout)
from bigdl_tpu_torch.parallel.mesh_policy import (ResolvedLayout,
                                                  mesh_and_layout,
                                                  parse_parallelism,
                                                  resolve_parallelism)
from bigdl_tpu_torch.parallel.ring_attention import (ring_attention,
                                                     ring_attention_sharded)
from bigdl_tpu_torch.parallel.ulysses import (ulysses_attention,
                                              ulysses_attention_sharded)

# gspmd imports the driver, which imports the nn modules that import
# this package: its names load on first use
_GSPMD = ("GSPMDTrainStep", "build_param_specs", "fit_layout",
          "tp_spec_for_path")


def __getattr__(name):
    if name in _GSPMD:
        from bigdl_tpu_torch.parallel import gspmd

        return getattr(gspmd, name)
    raise AttributeError(name)


__all__ = [
    "GSPMDTrainStep",
    "build_param_specs",
    "tp_spec_for_path",
    "fit_layout",
    "SpecLayout",
    "ModelLayout",
    "layout_for_model",
    "register_layout",
    "ResolvedLayout",
    "mesh_and_layout",
    "parse_parallelism",
    "resolve_parallelism",
    "collectives",
    "ring_attention",
    "ring_attention_sharded",
    "ulysses_attention",
    "ulysses_attention_sharded",
]
