"""The process's runtime configuration — the single-process part of
``bigdl_tpu.runtime``."""

from bigdl_tpu_torch.runtime.engine import Engine, EngineConfig, init_engine

__all__ = ["Engine", "EngineConfig", "init_engine"]
