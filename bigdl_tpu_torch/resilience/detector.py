"""Step health on one process — the port of ``StepWatchdog`` from
``bigdl_tpu.resilience.detector`` (the heartbeats and their monitor come
with the supervisor, ROADMAP A.6.9)."""

import logging
import math
import threading
import time
from typing import Callable, Optional

from bigdl_tpu_torch.resilience.retry import PoisonedStepError

log = logging.getLogger("bigdl_tpu_torch.resilience")


class StepWatchdog:
    """Hung-step detection and the NaN streak.

    The driver reports ``step_started`` at each bundle edge and
    ``observe_loss`` for every step's loss when it reads them; ``hung()``
    (or the background ``start()`` thread) flags a step in flight longer
    than ``step_timeout_s``.  A hang cannot be interrupted from Python
    (the thread waits on the card), so the watchdog makes it visible:
    ``on_hang`` may escalate."""

    def __init__(self, step_timeout_s: float = 600.0, nan_patience: int = 3,
                 on_hang: Optional[Callable[[int, float], None]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.step_timeout_s = step_timeout_s
        self.nan_patience = nan_patience
        self.on_hang = on_hang
        self._clock = clock
        self._step = -1
        self._started: Optional[float] = None
        self._nan_streak = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._hang_reported = False

    def step_started(self, step: int) -> None:
        self._step = step
        self._started = self._clock()
        self._hang_reported = False

    def observe_loss(self, step: int, loss: float) -> None:
        """Feed a loss read on the host; raises ``PoisonedStepError``
        after ``nan_patience`` non-finite values in a row."""
        self._started = None  # the steps up to here completed
        if math.isfinite(loss):
            self._nan_streak = 0
            return
        self._nan_streak += 1
        log.warning("non-finite loss %s at step %d (%d/%d before poisoned)",
                    loss, step, self._nan_streak, self.nan_patience)
        if self._nan_streak >= self.nan_patience:
            self._nan_streak = 0
            raise PoisonedStepError(
                f"loss non-finite for {self.nan_patience} consecutive "
                f"observations (last step {step})")

    def hung(self, now: Optional[float] = None) -> bool:
        if self._started is None:
            return False
        now = self._clock() if now is None else now
        return (now - self._started) > self.step_timeout_s

    def check(self) -> bool:
        """One poll: logs (and calls ``on_hang``) the first time a hang
        is seen; returns whether the current step is hung."""
        if not self.hung():
            return False
        if not self._hang_reported:
            self._hang_reported = True
            stuck_for = self._clock() - (self._started or 0.0)
            log.error("step %d appears HUNG (%.0fs > %.0fs timeout)",
                      self._step, stuck_for, self.step_timeout_s)
            if self.on_hang is not None:
                self.on_hang(self._step, stuck_for)
        return True

    def start(self, poll_interval_s: float = 5.0) -> "StepWatchdog":
        def run():
            while not self._stop.wait(poll_interval_s):
                self.check()

        self._thread = threading.Thread(
            target=run, name="bigdl-tpu-torch-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=6)
            self._thread = None
