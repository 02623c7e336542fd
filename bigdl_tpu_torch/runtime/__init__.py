"""The process's runtime configuration and its process mesh — the port
of ``bigdl_tpu.runtime``."""

from bigdl_tpu_torch.runtime.engine import Engine, EngineConfig, init_engine
from bigdl_tpu_torch.runtime.mesh import Mesh, MeshSpec, build_mesh

__all__ = ["Engine", "EngineConfig", "init_engine", "Mesh", "MeshSpec",
           "build_mesh"]
