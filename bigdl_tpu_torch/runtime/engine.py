"""Engine — the port of ``bigdl_tpu.runtime.engine`` over
``torch.distributed``.

``EngineConfig`` holds the knobs the JAX package keeps there rather than
on the ``Optimizer``: the rendezvous and the mesh, the gradient wire
format and buckets, the in-run retry bounds, the profiler directory, the
decode pool's width, step bundles and the numerics.  ``from_env`` reads
their environment variables (the JAX package's names); ``Engine.get()``
is the process's engine, built from the environment at first use;
``init_engine`` sets another.

One process drives one device.  With ``coordinator_address`` set, the
engine joins ``num_processes`` processes as rank ``process_id``:
``torch.distributed.init_process_group`` over NCCL on the card
(``cuda:<process_id % device_count>``), or over gloo when the caller
asks for the CPU (``device="cpu"``, as the tests do); an address
without a scheme is ``tcp://<address>``, and a ``file://`` URL is taken
as it is.  An engine built while a process group is already up joins
that group.  The mesh (``runtime.mesh``) is the group; without one it is
this process alone.

The metrics endpoint, the SLOs and the peak-FLOPs pin are there so that
a config written for the JAX package reads the same; any value but the
default raises, naming the ROADMAP item that ports it."""

import dataclasses
import datetime
import os
from dataclasses import dataclass, field
from typing import Optional, Union

import torch
import torch.distributed as dist

from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.parallel.collectives import GRAD_COMM_MODES
from bigdl_tpu_torch.resilience.retry import (FailureCause, FailurePolicy,
                                              RetryPolicy)
from bigdl_tpu_torch.runtime.mesh import Mesh, MeshSpec, build_mesh


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
    # rendezvous: None runs one process (or joins a group already up)
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    # the process group's timeout for the rendezvous and every
    # collective, in seconds (None: torch.distributed's default)
    timeout_s: Optional[float] = None
    # logical mesh: only the dcn_data and data axes may exceed 1
    # (runtime.mesh)
    mesh: MeshSpec = field(default_factory=MeshSpec)
    # the ZeRO-1 gradient wire ("fp32" | "bf16" | "int8") and the
    # largest flat-gradient bytes a collective (None: one collective);
    # the Optimizer's attributes override per run
    grad_comm: str = "fp32"
    comm_bucket_bytes: Optional[int] = None
    # the declarative layout (parallel.mesh_policy: "dp", "fsdp:2,tp:2",
    # ...) the Estimator fits under when its config names none; None
    # keeps the ZeRO-1 driver
    parallelism: Optional[str] = None
    # not ported: any other value raises (ROADMAP A.6.7)
    metrics_port: Optional[int] = None
    slo_specs: Optional[object] = None
    peak_flops: Optional[float] = None

    def check(self) -> None:
        """Raise on a field this port does not run yet, naming the
        ROADMAP item that brings it."""
        if self.param_dtype != "float32":
            raise ValueError(f"param_dtype {self.param_dtype!r}: params "
                             f"live in float32")
        if isinstance(self.mesh, dict):
            self.mesh = MeshSpec(**self.mesh)
        self.grad_comm = str(self.grad_comm).strip().lower()
        if self.grad_comm not in GRAD_COMM_MODES:
            raise ValueError(f"grad_comm {self.grad_comm!r}: one of "
                             f"{GRAD_COMM_MODES}")
        if self.comm_bucket_bytes is not None \
                and int(self.comm_bucket_bytes) <= 0:
            raise ValueError(f"comm_bucket_bytes {self.comm_bucket_bytes}"
                             f": a positive byte count or None")
        if self.coordinator_address is not None and (
                self.num_processes is None or self.process_id is None
                or not 0 <= self.process_id < self.num_processes):
            raise ValueError(
                f"coordinator_address needs num_processes and a process_id "
                f"in [0, num_processes), got {self.num_processes} and "
                f"{self.process_id}")
        later = {"metrics_port": ("A.6.7", None),
                 "slo_specs": ("A.6.7", None),
                 "peak_flops": ("A.6.7", None)}
        for name, (item, default) in later.items():
            if getattr(self, name) != default:
                raise ValueError(
                    f"EngineConfig.{name}={getattr(self, name)!r}: not "
                    f"ported yet (ROADMAP {item}); the port runs with "
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
        """The defaults, with ``BIGDL_TPU_COORDINATOR`` (and
        ``BIGDL_TPU_NUM_PROCESSES``, ``BIGDL_TPU_PROCESS_ID``),
        ``BIGDL_TPU_GRAD_COMM``, ``BIGDL_TPU_COMM_BUCKET_BYTES``,
        ``BIGDL_TPU_RETRY_TIMES``, ``BIGDL_TPU_PROFILE_DIR``,
        ``BIGDL_TPU_DATA_WORKERS``, ``BIGDL_TPU_STEPS_PER_CALL`` (an
        int or ``auto``; anything else raises ``ValueError``),
        ``BIGDL_TPU_PARALLELISM`` (lower-cased) and
        ``BIGDL_TPU_DCN_SLICES`` (the mesh's ``dcn_data``) applied."""
        cfg = EngineConfig()
        env = os.environ
        if env.get("BIGDL_TPU_COORDINATOR"):
            cfg.coordinator_address = env["BIGDL_TPU_COORDINATOR"]
            cfg.num_processes = int(env.get("BIGDL_TPU_NUM_PROCESSES", "1"))
            cfg.process_id = int(env.get("BIGDL_TPU_PROCESS_ID", "0"))
        if env.get("BIGDL_TPU_GRAD_COMM"):
            cfg.grad_comm = env["BIGDL_TPU_GRAD_COMM"].strip().lower()
        if env.get("BIGDL_TPU_COMM_BUCKET_BYTES"):
            cfg.comm_bucket_bytes = int(env["BIGDL_TPU_COMM_BUCKET_BYTES"])
        if env.get("BIGDL_TPU_RETRY_TIMES"):
            cfg.failure_retry_times = int(env["BIGDL_TPU_RETRY_TIMES"])
        if env.get("BIGDL_TPU_PROFILE_DIR"):
            cfg.profile_dir = env["BIGDL_TPU_PROFILE_DIR"]
        if env.get("BIGDL_TPU_DATA_WORKERS"):
            cfg.data_workers = int(env["BIGDL_TPU_DATA_WORKERS"])
        if env.get("BIGDL_TPU_STEPS_PER_CALL"):
            raw = env["BIGDL_TPU_STEPS_PER_CALL"].strip().lower()
            cfg.steps_per_call = "auto" if raw == "auto" else int(raw)
        if env.get("BIGDL_TPU_PARALLELISM"):
            # checked when it resolves against the world's ranks
            cfg.parallelism = env["BIGDL_TPU_PARALLELISM"].strip().lower()
        if env.get("BIGDL_TPU_DCN_SLICES"):
            cfg.mesh = dataclasses.replace(
                cfg.mesh, dcn_data=int(env["BIGDL_TPU_DCN_SLICES"]))
        return cfg


class Engine:
    """The process's engine: its config, checked once, the process group
    it joined and the mesh over it.  ``device`` is where a distributed
    run's tensors live (None: the card, as every entry point)."""

    _instance: Optional["Engine"] = None

    def __init__(self, config: EngineConfig, device=None):
        config.check()
        self.config = config
        self.device: Optional[torch.device] = None
        if config.coordinator_address is not None:
            self.device = self._join(config, device)
        elif dist.is_available() and dist.is_initialized():
            self.device = (torch.device("cpu")
                           if dist.get_backend() == "gloo"
                           else torch.device("cuda",
                                             torch.cuda.current_device()))
        elif device is not None:
            self.device = torch.device(device)
        self.mesh: Mesh = build_mesh(config.mesh, self.device)

    @staticmethod
    def _join(config: EngineConfig, device) -> torch.device:
        """Rendezvous as ``process_id`` of ``num_processes`` (once a
        process; a group already up must have this world size and rank).
        NCCL on the card, gloo on the CPU; never one for the other."""
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda",
                               config.process_id % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        if dist.is_initialized():
            if (dist.get_world_size(), dist.get_rank()) != (
                    config.num_processes, config.process_id):
                raise ValueError(
                    f"a process group of {dist.get_world_size()} (rank "
                    f"{dist.get_rank()}) is up; the config asks for "
                    f"{config.num_processes} (rank {config.process_id})")
            return dev
        addr = config.coordinator_address
        kw = {}
        if config.timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=config.timeout_s)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=addr if "://" in addr else f"tcp://{addr}",
            world_size=config.num_processes, rank=config.process_id, **kw)
        return dev

    @classmethod
    def get(cls) -> "Engine":
        if cls._instance is None:
            cls._instance = Engine(EngineConfig.from_env())
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        """Forget the engine (a process group it joined stays up)."""
        cls._instance = None

    @property
    def node_number(self) -> int:
        """Processes in the run."""
        return self.mesh.world_size

    @property
    def core_number(self) -> int:
        """Devices a process: one."""
        return 1


def init_engine(config: Optional[EngineConfig] = None, device=None,
                **mesh_axes) -> Engine:
    """Set the process's engine (from the environment without a
    ``config``); ``mesh_axes`` resize the logical mesh
    (``init_engine(data=2)``)."""
    if config is None:
        config = EngineConfig.from_env()
    if mesh_axes:
        mesh = (MeshSpec(**config.mesh) if isinstance(config.mesh, dict)
                else config.mesh)
        config.mesh = dataclasses.replace(mesh, **mesh_axes)
    Engine._instance = Engine(config, device)
    return Engine._instance
