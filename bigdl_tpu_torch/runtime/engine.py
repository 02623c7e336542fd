"""Engine — the single-process part of ``bigdl_tpu.runtime.engine``.

``EngineConfig`` holds the knobs the JAX package keeps there rather than
on the ``Optimizer``: the in-run retry bounds, the profiler directory,
the decode pool's width, step bundles and the numerics.  ``from_env``
reads their environment variables; ``Engine.get()`` is the process's
engine, built from the environment at first use; ``init_engine`` sets
another.

The fields of the mesh and the rendezvous, the gradient wire format and
buckets, the metrics endpoint and SLOs, and the peak-FLOPs pin are
there so that a config written for the JAX package reads the same; any
value but the default raises, naming the ROADMAP item that ports it."""

import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Union

from bigdl_tpu_torch.resilience.retry import (FailureCause, FailurePolicy,
                                              RetryPolicy)


@dataclass
class EngineConfig:
    # numerics.  compute_dtype is the JAX field, read nowhere there or
    # here (ROADMAP C.15): the device and tensor.policy's
    # set_compute_dtype decide.  Params live in float32 only.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # the driver's in-run retry: at most failure_retry_times recoveries
    # from the newest checkpoint, failure_retry_interval_s apart;
    # failure_policy, when set, gives per-cause bounds and backoff
    failure_retry_times: int = 5
    failure_retry_interval_s: float = 10.0
    failure_policy: Optional[FailurePolicy] = None
    # set_profile over a warm window of every optimize() when set
    profile_dir: Optional[str] = None
    # the streaming input's decode pool width (None: autotune_workers)
    data_workers: Optional[int] = None
    # step bundles: an int K >= 1 or "auto" (the Optimizer's
    # steps_per_call attribute overrides per run)
    steps_per_call: Union[int, str] = 1
    # not on one process: any other value raises (ROADMAP A.2, A.6.7)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    mesh: Dict[str, int] = field(default_factory=dict)
    grad_comm: str = "fp32"
    comm_bucket_bytes: Optional[int] = None
    metrics_port: Optional[int] = None
    slo_specs: Optional[object] = None
    peak_flops: Optional[float] = None

    def check(self) -> None:
        """Raise on a field this port does not run yet, naming the
        ROADMAP item that brings it."""
        if self.param_dtype != "float32":
            raise ValueError(f"param_dtype {self.param_dtype!r}: params "
                             f"live in float32")
        later = {"coordinator_address": ("A.2", None),
                 "num_processes": ("A.2", None),
                 "process_id": ("A.2", None), "mesh": ("A.2", {}),
                 "grad_comm": ("A.2", "fp32"),
                 "comm_bucket_bytes": ("A.2", None),
                 "metrics_port": ("A.6.7", None),
                 "slo_specs": ("A.6.7", None),
                 "peak_flops": ("A.6.7", None)}
        for name, (item, default) in later.items():
            if getattr(self, name) != default:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: not "
                    f"ported yet (ROADMAP {item}); one process runs with "
                    f"the default {default!r}")

    def resolved_failure_policy(self) -> FailurePolicy:
        """The explicit policy, else one built from the legacy knobs: a
        fixed ``failure_retry_interval_s`` between at most
        ``failure_retry_times`` retries (no jitter, no growth).  Tuned
        legacy knobs override the storage default too."""
        if self.failure_policy is not None:
            return self.failure_policy
        legacy = RetryPolicy(
            max_retries=self.failure_retry_times,
            base_s=self.failure_retry_interval_s, multiplier=1.0,
            jitter=0.0, max_s=self.failure_retry_interval_s)
        by_cause = {}
        if (self.failure_retry_times, self.failure_retry_interval_s) \
                != (5, 10.0):
            by_cause[FailureCause.TRANSIENT_STORAGE] = legacy
        return FailurePolicy(max_restarts=self.failure_retry_times,
                             default_retry=legacy, by_cause=by_cause)

    @staticmethod
    def from_env() -> "EngineConfig":
        """The defaults, with ``BIGDL_TPU_RETRY_TIMES``,
        ``BIGDL_TPU_PROFILE_DIR``, ``BIGDL_TPU_DATA_WORKERS`` and
        ``BIGDL_TPU_STEPS_PER_CALL`` (an int or ``auto``; anything else
        raises ``ValueError``) applied."""
        cfg = EngineConfig()
        env = os.environ
        if env.get("BIGDL_TPU_RETRY_TIMES"):
            cfg.failure_retry_times = int(env["BIGDL_TPU_RETRY_TIMES"])
        if env.get("BIGDL_TPU_PROFILE_DIR"):
            cfg.profile_dir = env["BIGDL_TPU_PROFILE_DIR"]
        if env.get("BIGDL_TPU_DATA_WORKERS"):
            cfg.data_workers = int(env["BIGDL_TPU_DATA_WORKERS"])
        if env.get("BIGDL_TPU_STEPS_PER_CALL"):
            raw = env["BIGDL_TPU_STEPS_PER_CALL"].strip().lower()
            cfg.steps_per_call = "auto" if raw == "auto" else int(raw)
        return cfg


class Engine:
    """The process's engine: its config, checked once."""

    _instance: Optional["Engine"] = None

    def __init__(self, config: EngineConfig):
        config.check()
        self.config = config

    @classmethod
    def get(cls) -> "Engine":
        if cls._instance is None:
            cls._instance = Engine(EngineConfig.from_env())
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None


def init_engine(config: Optional[EngineConfig] = None,
                **mesh_axes) -> Engine:
    """Set the process's engine (from the environment without a
    ``config``).  Mesh axes come with multi-GPU training: any raises."""
    if config is None:
        config = EngineConfig.from_env()
    if mesh_axes:
        config.mesh = dict(config.mesh, **mesh_axes)
    Engine._instance = Engine(config)
    return Engine._instance
