"""Deterministic fault injection — the port's copy of
``bigdl_tpu.resilience.faults``.

Failures are injected at named points with deterministic triggers: a run
with the same plan fires the same faults at the same invocations, every
time.  The points instrumented on one process:

- ``step_fail``             — raise inside the train iteration
                              (``Optimizer._one_bundle``: every step of a
                              bundle's range is evaluated at its edge)
- ``checkpoint_write_fail`` — raise after a checkpoint's blobs and before
                              its manifest (``checkpoint.save_checkpoint``)
- ``storage_io_fail``       — raise from the storage seam
                              (``utils.storage.open_file``)
- ``process_kill``          — ``os._exit`` (or raise) in the train iteration
- ``slow_host``             — sleep inside the train iteration

The serving points fire in ``serving.server`` (``serving_predict_fail``,
``serving_worker_kill``, ``serving_slow_batch``) and the fleet points in
the decode engine, the HTTP frontend and the pool's proxy
(``fleet_worker_kill``, ``fleet_handoff_corrupt``,
``fleet_stream_sever``, ``fleet_health_stale``).  The cluster points
parse and carry their exception classes, so every plan of the JAX
package parses here; nothing fires them until multi-host supervision is
ported.  Every fire is a ``fault_injected`` flight line, and an ``exit``
fault dumps an installed flight recorder first.

Triggers per spec: ``at_step`` (fires when the site passes that step),
``every`` (every Nth invocation), ``probability`` (a hash of (seed,
point, invocation count), not a live RNG).  ``max_fires`` bounds the
fires; it is 1 for ``at_step`` specs, so a resumed run that replays the
step does not die on it again.

Config: programmatic (``install([FaultSpec(...)])``) or the environment,

    BIGDL_TPU_FAULTS="step_fail@5;checkpoint_write_fail:p=0.5;slow_host@3:delay=0.2"

entries split on ``;``, each ``point[@step][:key=val[:key=val]...]`` with
keys ``p`` (probability), ``every``, ``max`` (max_fires), ``delay``
(seconds, slow_host), ``seed`` and ``action`` (``raise``/``exit``/
``sleep``).  The environment's plan is read once, at the first
instrumented call."""

import hashlib
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.obs import flight

log = logging.getLogger("bigdl_tpu_torch.resilience")

POINTS = ("step_fail", "checkpoint_write_fail", "storage_io_fail",
          "process_kill", "slow_host",
          "serving_predict_fail", "serving_worker_kill",
          "serving_slow_batch",
          "cluster_host_loss", "cluster_partition", "cluster_slow_peer",
          "cluster_preempt_notice",
          "fleet_worker_kill", "fleet_handoff_corrupt",
          "fleet_stream_sever", "fleet_health_stale")


class InjectedFault(RuntimeError):
    """Base of every injected failure; ``point`` names the site."""

    def __init__(self, point: str, step=None, count: int = 0):
        super().__init__(
            f"injected fault {point!r}"
            + (f" at step {step}" if step is not None else "")
            + f" (invocation {count})")
        self.point = point
        self.step = step
        self.count = count


class InjectedStepFailure(InjectedFault):
    pass


class InjectedCheckpointWriteError(InjectedFault):
    pass


class InjectedStorageError(InjectedFault, OSError):
    """Classified as transient storage by :func:`..retry.classify`."""


class ProcessKilledError(InjectedFault):
    """``process_kill`` in ``action="raise"`` mode (in-process tests)."""


class InjectedPredictError(InjectedFault):
    """``serving_predict_fail``."""


class HostLostError(InjectedFault):
    """``cluster_host_loss``."""


class PartitionError(InjectedFault):
    """``cluster_partition``."""


class PreemptNoticeFault(InjectedFault):
    """``cluster_preempt_notice``."""


class StreamSeveredError(InjectedFault, ConnectionResetError):
    """``fleet_stream_sever``."""


class HandoffCorruptFault(InjectedFault):
    """``fleet_handoff_corrupt``."""


class HealthStaleFault(InjectedFault):
    """``fleet_health_stale``."""


_EXC = {
    "step_fail": InjectedStepFailure,
    "checkpoint_write_fail": InjectedCheckpointWriteError,
    "storage_io_fail": InjectedStorageError,
    "process_kill": ProcessKilledError,
    "slow_host": InjectedFault,
    "serving_predict_fail": InjectedPredictError,
    "serving_worker_kill": ProcessKilledError,
    "serving_slow_batch": InjectedFault,
    "cluster_host_loss": HostLostError,
    "cluster_partition": PartitionError,
    "cluster_slow_peer": InjectedFault,
    "cluster_preempt_notice": PreemptNoticeFault,
    "fleet_worker_kill": ProcessKilledError,
    "fleet_handoff_corrupt": HandoffCorruptFault,
    "fleet_stream_sever": StreamSeveredError,
    "fleet_health_stale": HealthStaleFault,
}

_DEFAULT_ACTION = {"slow_host": "sleep", "serving_slow_batch": "sleep",
                   "cluster_slow_peer": "sleep", "process_kill": "exit",
                   "serving_worker_kill": "exit",
                   "fleet_worker_kill": "exit"}


@dataclass
class FaultSpec:
    point: str
    at_step: Optional[int] = None
    probability: float = 0.0
    every: Optional[int] = None
    max_fires: Optional[int] = None   # None: 1 when at_step set, else ∞
    delay_s: float = 0.2              # slow_host sleep
    action: Optional[str] = None      # raise | exit | sleep (point default)
    seed: int = 0

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; one of {POINTS}")
        if self.action is None:
            self.action = _DEFAULT_ACTION.get(self.point, "raise")
        if self.max_fires is None and self.at_step is not None:
            self.max_fires = 1


def _unit_hash(seed: int, point: str, count: int) -> float:
    """Deterministic pseudo-uniform in [0, 1): depends only on (seed,
    point, invocation index), never on evaluation order."""
    h = hashlib.blake2b(f"{seed}:{point}:{count}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") / 2.0 ** 64


class FaultInjector:
    """Evaluates a fault plan at instrumented points and records every
    fire in ``events`` as ``(point, step, invocation)``."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._invocations: Dict[str, int] = {}
        self._fires: Dict[int, int] = {}
        self.events: List[Tuple[str, Optional[int], int]] = []

    def fire(self, point: str, step: Optional[int] = None) -> None:
        """Called by an instrumented site; raises, sleeps or exits as
        planned."""
        count = self._invocations.get(point, 0)
        self._invocations[point] = count + 1
        for i, spec in enumerate(self.specs):
            if spec.point != point or not self._should_fire(i, spec, step,
                                                            count):
                continue
            self._fires[i] = self._fires.get(i, 0) + 1
            self.events.append((point, step, count))
            log.warning("fault injection: firing %r (step=%s, invocation "
                        "%d)", point, step, count)
            # the postmortem shows the fault before its consequences
            flight.record("fault_injected", point=point, step=step,
                          invocation=count, action=spec.action)
            if spec.action == "sleep":
                time.sleep(spec.delay_s)
            elif spec.action == "exit":
                # os._exit skips excepthook, atexit and signal handlers:
                # an armed flight recorder dumps here
                flight.dump_if_installed(f"injected {point} (exit)")
                os._exit(113)
            else:
                raise _EXC[point](point, step=step, count=count)

    def _should_fire(self, i: int, spec: FaultSpec,
                     step: Optional[int], count: int) -> bool:
        if spec.max_fires is not None \
                and self._fires.get(i, 0) >= spec.max_fires:
            return False
        if spec.at_step is not None:
            return step == spec.at_step
        if spec.every is not None:
            return (count + 1) % spec.every == 0
        if spec.probability > 0.0:
            return _unit_hash(spec.seed, spec.point, count) < spec.probability
        return False


# -- the process-wide plan the instrumented sites consult --------------------

_injector: Optional[FaultInjector] = None
_env_checked = False


def install(specs) -> FaultInjector:
    """Install a plan process-wide; returns the injector (its ``events``
    are what tests assert on)."""
    global _injector, _env_checked
    _injector = (specs if isinstance(specs, FaultInjector)
                 else FaultInjector(list(specs)))
    _env_checked = True
    return _injector


def clear() -> None:
    """Remove the plan; the environment's plan is not read again."""
    global _injector, _env_checked
    _injector = None
    _env_checked = True


def get() -> Optional[FaultInjector]:
    return _injector


def fire(point: str, step: Optional[int] = None) -> None:
    """The instrumented site's entry: one None check when no plan is
    installed (after the first call's look at the environment)."""
    global _injector, _env_checked
    if _injector is None:
        if _env_checked:
            return
        _env_checked = True
        plan = os.environ.get("BIGDL_TPU_FAULTS")
        if not plan:
            return
        _injector = FaultInjector(parse_plan(plan))
    _injector.fire(point, step=step)


def fire_step(step: int) -> None:
    """All step-scoped points, in hazard order: a straggler is slow
    before it fails, and a kill beats a clean exception."""
    fire("slow_host", step=step)
    fire("process_kill", step=step)
    fire("step_fail", step=step)


def fire_bundle(step: int, n_steps: int = 1) -> None:
    """Step-scoped points for a bundle of ``n_steps`` steps from
    ``step``: the host sees only bundle edges, so every step of the range
    is evaluated here, before the bundle runs; an ``at_step`` plan fires
    at its exact step whatever the bundling, and the whole bundle rewinds
    to its start on recovery."""
    if _injector is None and _env_checked:
        return
    for s in range(step, step + n_steps):
        fire_step(s)


def parse_plan(text: str) -> List[FaultSpec]:
    """Parse the ``BIGDL_TPU_FAULTS`` grammar (module docstring)."""
    keys = {"p": ("probability", float), "every": ("every", int),
            "max": ("max_fires", int), "delay": ("delay_s", float),
            "seed": ("seed", int), "action": ("action", str.strip)}
    specs = []
    for entry in filter(None, (e.strip() for e in text.split(";"))):
        head, *opts = entry.split(":")
        point, at = (head.split("@", 1) + [None])[:2]
        kw = dict(point=point.strip(),
                  at_step=int(at) if at is not None else None)
        for opt in opts:
            k, _, v = opt.partition("=")
            k = k.strip()
            if k not in keys:
                raise ValueError(f"unknown fault option {k!r} in {entry!r}")
            name, conv = keys[k]
            kw[name] = conv(v)
        specs.append(FaultSpec(**kw))
    return specs
