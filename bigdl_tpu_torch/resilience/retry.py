"""Retry policies and failure classification — the port's copy of
``bigdl_tpu.resilience.retry``.

Retry behaviour is cause-aware: a transient storage hiccup gets fast
exponential backoff and many attempts, a poisoned batch few (replaying
the same plan poisons again), and a topology change none in place.
Backoff jitter is a hash of (seed, attempt), not a live RNG, so recovery
timing is reproducible.

The CUDA errors PyTorch raises map onto the causes the JAX package gives
their XLA counterparts:

- ``torch.cuda.OutOfMemoryError`` (XLA's ``RESOURCE_EXHAUSTED``) is
  UNKNOWN: the same step on the same card runs out again, so the run
  escalates instead of retrying in place;
- any other CUDA runtime error (a ``RuntimeError`` or
  ``torch.AcceleratorError`` whose text names CUDA, XLA's ``INTERNAL``
  device errors) is STEP_FAILURE: the step is replayed from the last
  checkpoint, as an injected ``step_fail`` is;
- a message naming a non-finite value is POISONED_BATCH, as in the JAX
  package."""

import logging
import re
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, Optional

import torch

log = logging.getLogger("bigdl_tpu_torch.resilience")


class FailureCause(Enum):
    TRANSIENT_STORAGE = "transient_storage"
    POISONED_BATCH = "poisoned_batch"
    TOPOLOGY_CHANGE = "topology_change"
    PROCESS_FAILURE = "process_failure"
    STEP_FAILURE = "step_failure"
    # a peer host died; recovery is the gang's (ROADMAP A.2)
    HOST_LOST = "host_lost"
    UNKNOWN = "unknown"


class PoisonedStepError(RuntimeError):
    """Raised by the step watchdog on a NaN/Inf loss streak: the batch
    (or the rate) is the problem, not the infrastructure."""


class TopologyChangedError(RuntimeError):
    """The process set changed.  Kept for the name: nothing raises it
    until the cluster control plane (``set_cluster``, ROADMAP A.2 and
    A.6.9)."""


def classify(exc: BaseException) -> FailureCause:
    """The cause of ``exc``: injected faults by their point, real errors
    by type; a wrapped error (``raise X from Y``) by the first link of
    its cause chain that is recognised."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        cause = _classify_one(e)
        if cause is not FailureCause.UNKNOWN:
            return cause
        e = e.__cause__ or e.__context__
    return FailureCause.UNKNOWN


_CUDA_ERROR = re.compile(r"\bcuda\b|\bcudnn\b|\bcublas\b", re.IGNORECASE)


def _classify_one(exc: BaseException) -> FailureCause:
    from bigdl_tpu_torch.resilience import faults

    if isinstance(exc, faults.ProcessKilledError):
        return FailureCause.PROCESS_FAILURE
    if isinstance(exc, faults.HostLostError):
        return FailureCause.HOST_LOST
    if isinstance(exc, (faults.InjectedStorageError,
                        faults.InjectedCheckpointWriteError)):
        return FailureCause.TRANSIENT_STORAGE
    if isinstance(exc, faults.InjectedStepFailure):
        return FailureCause.STEP_FAILURE
    if isinstance(exc, TopologyChangedError):
        return FailureCause.TOPOLOGY_CHANGE
    if isinstance(exc, (PoisonedStepError, FloatingPointError)):
        return FailureCause.POISONED_BATCH
    if isinstance(exc, (OSError, TimeoutError, ConnectionError)):
        return FailureCause.TRANSIENT_STORAGE
    text = str(exc).lower()
    # word-bounded: "info"/"nanosecond" must not read as numerics trouble
    if re.search(r"\b(nan|inf|infinity|non-finite)\b", text):
        return FailureCause.POISONED_BATCH
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return FailureCause.UNKNOWN
    accel = getattr(torch, "AcceleratorError", ())
    if isinstance(exc, accel) or (isinstance(exc, RuntimeError)
                                  and _CUDA_ERROR.search(text)):
        return FailureCause.STEP_FAILURE
    return FailureCause.UNKNOWN


@dataclass
class RetryPolicy:
    """Bounded retries with exponential backoff and deterministic
    jitter."""

    max_retries: int = 5
    base_s: float = 1.0
    multiplier: float = 2.0
    max_s: float = 60.0
    jitter: float = 0.1   # ± fraction of the backoff
    seed: int = 0

    def backoff(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential, capped,
        with hash-based jitter in ``[-jitter, +jitter)`` of the value."""
        attempt = max(1, attempt)
        raw = min(self.max_s,
                  self.base_s * self.multiplier ** (attempt - 1))
        if not self.jitter:
            return raw
        from bigdl_tpu_torch.resilience.faults import _unit_hash

        u = 2.0 * _unit_hash(self.seed, "backoff", attempt) - 1.0
        return max(0.0, raw * (1.0 + self.jitter * u))

    def call(self, fn: Callable, *args,
             retryable: Callable[[BaseException], bool] = lambda e: True,
             describe: str = "operation", sleep=time.sleep, **kwargs):
        """Run ``fn`` under this policy; re-raises the last error once
        retries are exhausted or the error is not ``retryable``."""
        attempt = 0
        while True:
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                attempt += 1
                if attempt > self.max_retries or not retryable(e):
                    raise
                delay = self.backoff(attempt)
                log.warning("%s failed (%s: %s); retry %d/%d in %.2fs",
                            describe, type(e).__name__, e, attempt,
                            self.max_retries, delay)
                sleep(delay)


# fast exponential for storage blips; one retry for a poisoned batch
# (replaying the same plan poisons again); none for topology changes
_DEFAULT_BY_CAUSE: Dict[FailureCause, RetryPolicy] = {
    FailureCause.TRANSIENT_STORAGE: RetryPolicy(
        max_retries=8, base_s=0.5, max_s=30.0),
    FailureCause.POISONED_BATCH: RetryPolicy(max_retries=1, base_s=0.0),
    FailureCause.TOPOLOGY_CHANGE: RetryPolicy(max_retries=0),
    FailureCause.HOST_LOST: RetryPolicy(max_retries=4, base_s=0.5,
                                        max_s=30.0),
}


@dataclass
class FailurePolicy:
    """The fault-tolerance contract an ``EngineConfig`` carries: at most
    ``max_restarts`` recoveries across causes, ``by_cause`` overriding
    the per-cause retry policy.  (The JAX policy's heartbeat, watchdog
    and cluster fields come with the supervisor, ROADMAP A.6.9 and
    A.2.)"""

    max_restarts: int = 5
    default_retry: RetryPolicy = field(default_factory=RetryPolicy)
    by_cause: Dict[FailureCause, RetryPolicy] = field(default_factory=dict)

    def policy_for(self, cause: FailureCause) -> RetryPolicy:
        if cause in self.by_cause:
            return self.by_cause[cause]
        return _DEFAULT_BY_CAUSE.get(cause, self.default_retry)
