"""Profiling — the port of ``bigdl_tpu.utils.profiling``: traces of the
host and the card by ``torch.profiler``, written as Chrome trace files
(``chrome://tracing``, Perfetto) where the JAX package writes
``jax.profiler`` traces."""

import contextlib
import logging
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

log = logging.getLogger("bigdl_tpu_torch.profiling")


def _activities():
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _export(prof, log_dir: str, tag: str) -> str:
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{tag}-{os.getpid()}-"
                                 f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
    return path


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block into a file under ``log_dir``."""
    prof = profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        _export(prof, log_dir, "block")


class IterationProfiler:
    """Trace training iterations ``[start_iter, start_iter + num_iters)``
    once the run is warm: never step 0, which holds set-up (and, with
    step bundles, the warm-up steps and the capture)."""

    def __init__(self, log_dir: str, start_iter: int = 10,
                 num_iters: int = 5):
        self.log_dir = log_dir
        self.start_iter = max(1, start_iter)
        self.stop_iter = self.start_iter + num_iters
        self._prof = None
        self.done = False
        self.path = None   # the trace file, once written

    def step(self, iteration: int) -> None:
        """Call once per training iteration, before it is dispatched."""
        if self.done:
            return
        if self._prof is None and iteration >= self.start_iter:
            self._prof = profile(activities=_activities())
            self._prof.start()
        elif self._prof is not None and iteration >= self.stop_iter:
            self.close()

    def close(self) -> None:
        """Stop and write a trace still open (training ended inside the
        window); idempotent."""
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.path = _export(self._prof, self.log_dir,
                            f"iters{self.start_iter}-{self.stop_iter - 1}")
        self._prof = None
        self.done = True

    def __enter__(self) -> "IterationProfiler":
        return self

    def __exit__(self, *a) -> bool:
        self.close()
        return False


def annotate(name: str):
    """A named range in the trace (``record_function``)."""
    return record_function(name)
