"""Step-time attribution — the port of ``bigdl_tpu.obs.attr``.

Every training window's wall time splits into four components, from the
driver's own timers:

- **data**     — host time blocked on the input feed (the
  ``train.data_wait_s`` samples);
- **dispatch** — host time issuing the step or the bundle;
- **overhead** — trigger work at bundle edges: validation, checkpoints,
  parameter histograms;
- **device**   — the residual: wall minus the three host components, the
  time the host waited out the card (the components sum to the wall by
  construction).

Per-step values land in the ``train.attr.*_s`` histograms; the run total
is the end-of-run table (:meth:`StepAttribution.table`).

Two run-health sentinels live here too:

- :class:`RecompileSentinel` counts compiles.  The JAX package listens
  for XLA's backend-compile events through ``jax.monitoring``; the port
  has no XLA, and its compiles are CUDA graph captures (the step
  bundles, the decode engine's programs) and kernel builds
  (``ops._build``).  Each publishes a duration event through this
  module's listener registry (:func:`compile_event`), the port's stand-in
  for ``jax.monitoring``.  A compile after the run went steady and
  outside an :func:`expected_compile` region is an unexpected recompile:
  counted under the JAX metric names and recorded in the flight
  recorder.
- :func:`host_step_time_stats` all-gathers every process's window step
  time (straggler detection)."""

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.obs import flight
from bigdl_tpu_torch.utils.log import get_logger

log = get_logger("bigdl_tpu_torch.obs")

COMPONENTS = ("data", "dispatch", "device", "overhead")

# the compile event every capture and kernel build publishes
COMPILE_EVENT = "/bigdl_tpu_torch/compile_duration"


class StepAttribution:
    """Accumulates per-window wall-time decompositions and exports them as
    ``train.attr.*`` histograms plus an end-of-run table."""

    def __init__(self, metrics=None):
        if metrics is None:
            from bigdl_tpu_torch.optim.metrics import global_metrics

            metrics = global_metrics()
        self.metrics = metrics
        self.steps = 0
        self.wall_s = 0.0
        self.totals: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
        self.windows = 0

    def window(self, steps: int, wall_s: float, data_s: float,
               dispatch_s: float, overhead_s: float) -> Dict[str, float]:
        """Record one window of ``steps`` steps; ``device`` is the
        residual, clamped at 0, so the components sum to ``wall_s``
        (unless host timers overlap and the clamp engages)."""
        if steps <= 0 or wall_s <= 0:
            return {}
        comps = {
            "data": max(data_s, 0.0),
            "dispatch": max(dispatch_s, 0.0),
            "overhead": max(overhead_s, 0.0),
        }
        comps["device"] = max(wall_s - sum(comps.values()), 0.0)
        self.steps += steps
        self.wall_s += wall_s
        self.windows += 1
        for name, v in comps.items():
            self.totals[name] += v
            self.metrics.observe(f"train.attr.{name}_s", v / steps)
        return comps

    def report(self) -> Dict[str, Any]:
        """Run totals and fractions, the machine-readable table."""
        out: Dict[str, Any] = {
            "steps": self.steps, "wall_s": self.wall_s,
            "windows": self.windows, "components": {},
        }
        for name in COMPONENTS:
            t = self.totals[name]
            out["components"][name] = {
                "total_s": t,
                "per_step_s": t / self.steps if self.steps else 0.0,
                "fraction": t / self.wall_s if self.wall_s else 0.0,
            }
        return out

    def table(self) -> str:
        """The end-of-run "where did the time go" table (the first window
        holds the set-up and the captures, in ``device``)."""
        rep = self.report()
        lines = [
            f"step-time attribution over {rep['steps']} steps "
            f"({rep['wall_s']:.3f}s wall):",
            f"  {'component':<10} {'total_s':>10} {'per_step_ms':>12} "
            f"{'fraction':>9}",
        ]
        for name in COMPONENTS:
            c = rep["components"][name]
            lines.append(
                f"  {name:<10} {c['total_s']:>10.3f} "
                f"{c['per_step_s'] * 1e3:>12.3f} {c['fraction']:>8.1%}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# duration events: the port's stand-in for jax.monitoring
# ---------------------------------------------------------------------------

_listeners: List[Callable[..., None]] = []
_listeners_lock = threading.Lock()


def register_event_duration_secs_listener(fn: Callable[..., None]) -> None:
    """Call ``fn(name, duration_s, **kw)`` on every duration event."""
    with _listeners_lock:
        _listeners.append(fn)


def record_event_duration_secs(name: str, duration_s: float, **kw) -> None:
    """Publish one duration event to every listener; a listener's error
    never reaches the publisher."""
    with _listeners_lock:
        fns = list(_listeners)
    for fn in fns:
        try:
            fn(name, float(duration_s), **kw)
        except Exception:  # noqa: BLE001
            pass


@contextmanager
def compile_event(kind: str):
    """Time the enclosed compile (a CUDA graph capture, a kernel build)
    and publish it as a :data:`COMPILE_EVENT` of ``kind``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record_event_duration_secs(COMPILE_EVENT,
                                   time.perf_counter() - t0, kind=kind)


# ---------------------------------------------------------------------------
# recompilation sentinel
# ---------------------------------------------------------------------------

_expected = threading.local()


def _expected_depth() -> int:
    return getattr(_expected, "depth", 0)


@contextmanager
def expected_compile():
    """Mark the calling thread's region as an expected compile site (a
    new bundle signature, a first evaluation, an engine's warmup) so the
    recompile sentinel doesn't flag it."""
    _expected.depth = _expected_depth() + 1
    try:
        yield
    finally:
        _expected.depth = _expected_depth() - 1


class RecompileSentinel:
    """Counts compiles through :data:`COMPILE_EVENT`.

    Every compile increments ``train.xla_compiles_total`` and lands in
    the ``train.compile_time_s`` histogram (the JAX names).  After
    :meth:`mark_steady` (the driver calls it once warmup is over), a
    compile outside an :func:`expected_compile` region also increments
    ``train.unexpected_recompiles_total`` and records an
    ``unexpected_recompile`` flight event."""

    EVENT = COMPILE_EVENT

    def __init__(self):
        self._steady = False
        self._step: Optional[int] = None
        self._registered = False

    def install(self) -> "RecompileSentinel":
        """Register the listener once (there is no unregister, as in
        ``jax.monitoring``; the listener is a cheap counter)."""
        if self._registered:
            return self
        register_event_duration_secs_listener(self._on_event)
        self._registered = True
        return self

    def _on_event(self, name: str, duration_s: float, **kw) -> None:
        if name != self.EVENT:
            return
        try:
            from bigdl_tpu_torch.optim.metrics import global_metrics

            m = global_metrics()
            m.inc("train.xla_compiles_total")
            m.observe("train.compile_time_s", float(duration_s))
            if self._steady and _expected_depth() == 0:
                m.inc("train.unexpected_recompiles_total")
                flight.record("unexpected_recompile",
                              duration_s=float(duration_s),
                              step=self._step,
                              compile_kind=kw.get("kind"))
                log.warning(
                    "unexpected compile mid-run (%s, %.3fs, step %s): a "
                    "new input shape or a dropped graph", kw.get("kind"),
                    duration_s, self._step)
        except Exception:  # noqa: BLE001 — a metrics bug never sinks a compile
            pass

    def mark_steady(self, step: Optional[int] = None) -> None:
        """Warmup is over: from here every unannounced compile is
        flagged."""
        self._steady = True
        self._step = step

    def note_step(self, step: int) -> None:
        self._step = step

    def mark_warmup(self) -> None:
        """Back to warmup (a run ended or starts): compiles are expected
        again."""
        self._steady = False
        self._step = None

    @property
    def steady(self) -> bool:
        return self._steady


_sentinel: Optional[RecompileSentinel] = None
_sentinel_lock = threading.Lock()


def recompile_sentinel() -> RecompileSentinel:
    """The process-wide sentinel, its listener installed on first use."""
    global _sentinel
    if _sentinel is None:
        with _sentinel_lock:
            if _sentinel is None:
                _sentinel = RecompileSentinel().install()
    return _sentinel


# ---------------------------------------------------------------------------
# cross-process aggregation (straggler skew)
# ---------------------------------------------------------------------------

def step_time_stats(values) -> Dict[str, float]:
    """max/min/skew/mean over per-process step times."""
    vals = np.ravel(np.asarray(values, np.float64))
    if vals.size == 0:
        return {}
    return {"max": float(vals.max()), "min": float(vals.min()),
            "skew": float(vals.max() - vals.min()),
            "mean": float(vals.mean()), "n_hosts": int(vals.size)}


def host_step_time_stats(step_time_s: float, group=None
                         ) -> Optional[Dict[str, float]]:
    """All-gather this process's window step time over the process group
    (``group``, default the world) and reduce it to straggler stats:
    a float64 CPU tensor over gloo, a CUDA tensor over NCCL.  None on
    one process.  Every process calls it at the same cadence (the
    driver's log points)."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size(group) <= 1:
        return None
    n = dist.get_world_size(group)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    mine = torch.full((1,), float(step_time_s), dtype=torch.float64,
                      device=dev)
    out = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(out, mine, group=group)
    return step_time_stats(torch.cat(out).cpu().numpy())
