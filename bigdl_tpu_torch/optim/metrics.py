"""Driver metrics and summaries — the port of ``bigdl_tpu.optim.metrics``.

``Metrics`` is a registry of per-window timers (``add``), run-lifetime
counters (``inc``), gauges and log-bucketed histograms (``observe``); the
training driver records its data wait (``train.data_wait_s``) and the
input pipeline its stage counters there.  ``SummaryWriter`` writes scalar
summaries as jsonl and as TensorBoard event files
(``utils/tbwriter.py``); ``TrainSummary`` / ``ValidationSummary`` name
them as the JAX package does, so either package reads the other's.
"""

import json
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Optional

from bigdl_tpu_torch.obs.hist import LogHistogram


def label_key(name: str, **labels) -> str:
    """Canonical registry key of a LABELED series:
    ``name{k="v",k2="v2"}`` with keys sorted and values escaped per the
    Prometheus text grammar, as the JAX package keys them."""
    if not labels:
        return name
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
        parts.append(f'{k}="{v}"')
    return name + "{" + ",".join(parts) + "}"


class Metrics:
    def __init__(self):
        self.sums: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # monotonic counters (recoveries_total, retries_by_cause.*,
        # time_lost_to_recovery_s, ...): run-lifetime totals, so they
        # survive the per-log-window reset() that clears the timers
        self.counters: Dict[str, float] = defaultdict(float)
        # latency/step-time distributions: bounded log-bucketed histograms
        # (obs.hist), run-lifetime like counters — /metrics exports their
        # p50/p95/p99 and Prometheus bucket lines
        self.hists: Dict[str, LogHistogram] = {}
        # point-in-time levels (queue depths, ring occupancy): last-write-
        # wins, exported as Prometheus gauges
        self.gauges: Dict[str, float] = {}
        # optional per-metric help strings (describe()); the exporter
        # renders them as `# HELP` lines next to `# TYPE`
        self.helps: Dict[str, str] = {}
        # the global_metrics() registry is shared across threads (the
        # input pipeline's stages + the training driver); += on a dict
        # entry is a read-modify-write that loses updates without this.
        # READS hold it too: defaultdict indexing on a miss mutates, and
        # an unlocked .items() iteration races concurrent inserts
        self._lock = threading.Lock()

    def add(self, name: str, value: float):
        with self._lock:
            self.sums[name] += value
            self.counts[name] += 1

    def inc(self, name: str, n: float = 1,
            labels: Optional[Dict[str, str]] = None):
        if labels:
            name = label_key(name, **labels)
        with self._lock:
            self.counters[name] += n
        self._mirror("inc", name, n)

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None):
        """Set a point-in-time level (queue depth, buffer-ring occupancy);
        the scrape sees the latest value.  ``labels`` selects one series
        of a labeled family (key built by :func:`label_key`)."""
        if labels:
            name = label_key(name, **labels)
        with self._lock:
            self.gauges[name] = float(value)
        self._mirror("gauge", name, value)

    def ensure_hist(self, name: str,
                    labels: Optional[Dict[str, str]] = None,
                    **hist_kwargs) -> float:
        """Create the named histogram with explicit geometry (window_s,
        window_slices, ...) if it does not exist yet.  Returns the
        histogram's (existing or created) window_s so the caller can
        detect a pre-existing smaller ring."""
        if labels:
            name = label_key(name, **labels)
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = LogHistogram(**hist_kwargs)
            return h.window_s

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None):
        """One sample into the named histogram (created on first use)."""
        if labels:
            name = label_key(name, **labels)
        with self._lock:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = LogHistogram()
            h.observe(value)
        self._mirror("observe", name, value)

    def _mirror(self, op: str, name: str, v: float) -> None:
        # run-lifetime signals (counters, histograms) recorded on a
        # per-component registry ALSO land in the process-wide one, so
        # one read sees every subsystem side by side without their
        # sharing one instance
        g = global_metrics()
        if g is not self:
            getattr(g, op)(name, v)

    def describe(self, name: str, help_text: str) -> None:
        """Attach a Prometheus ``# HELP`` string to a metric name (applies
        whatever kind the name turns out to be; mirrored like the metric
        itself so the process-wide scrape carries it too)."""
        with self._lock:
            self.helps[name] = str(help_text)
        g = global_metrics()
        if g is not self:
            g.describe(name, help_text)

    def counter(self, name: str) -> float:
        with self._lock:
            return self.counters.get(name, 0.0)

    def total(self, name: str) -> float:
        """Sum of a per-window timer (``add``) since the last ``reset`` —
        the attribution layer reads window totals, not means."""
        with self._lock:
            return self.sums.get(name, 0.0)

    def mean(self, name: str) -> float:
        with self._lock:
            c = self.counts.get(name, 0)
            return self.sums.get(name, 0.0) / c if c else 0.0

    def percentile(self, name: str, q: float) -> float:
        with self._lock:
            h = self.hists.get(name)
            return h.percentile(q) if h is not None else 0.0

    # -- sliding-window reads ----------------------------------------------
    def window_percentile(self, name: str, q: float,
                          labels: Optional[Dict[str, str]] = None,
                          window_s: Optional[float] = None,
                          now: Optional[float] = None) -> float:
        """q-th percentile of the histogram's trailing window; NaN when
        the window (or the histogram itself) is empty."""
        if labels:
            name = label_key(name, **labels)
        with self._lock:
            h = self.hists.get(name)
            return (h.window_percentile(q, now=now, window_s=window_s)
                    if h is not None else float("nan"))

    def window_fraction_over(self, name: str, threshold: float,
                             labels: Optional[Dict[str, str]] = None,
                             window_s: Optional[float] = None,
                             now: Optional[float] = None) -> float:
        """Fraction of window samples over ``threshold`` (NaN when the
        window is empty)."""
        if labels:
            name = label_key(name, **labels)
        with self._lock:
            h = self.hists.get(name)
            return (h.window_fraction_over(threshold, now=now,
                                           window_s=window_s)
                    if h is not None else float("nan"))

    def window_count(self, name: str,
                     labels: Optional[Dict[str, str]] = None,
                     window_s: Optional[float] = None,
                     now: Optional[float] = None) -> int:
        if labels:
            name = label_key(name, **labels)
        with self._lock:
            h = self.hists.get(name)
            return (h.window_count(now=now, window_s=window_s)
                    if h is not None else 0)

    def reset(self):
        with self._lock:
            self.sums.clear()
            self.counts.clear()

    def summary(self) -> Dict[str, float]:
        with self._lock:
            out = {k: (self.sums[k] / self.counts[k]
                       if self.counts.get(k) else 0.0) for k in self.sums}
            out.update(self.counters)
            out.update(self.gauges)
            for k, h in self.hists.items():
                for q, v in h.quantiles().items():
                    out[f"{k}.{q}"] = v
                out[f"{k}.count"] = h.n
        return out

    def snapshot(self, blocking: bool = True) -> Optional[Dict[str, dict]]:
        """Consistent point-in-time copy of the whole registry.

        ``blocking=False`` is for signal handlers: the handler may have
        interrupted the very frame that holds this non-reentrant lock, so
        waiting would deadlock — return None instead."""
        if not self._lock.acquire(blocking=blocking):
            return None
        try:
            return {"sums": dict(self.sums), "counts": dict(self.counts),
                    "counters": dict(self.counters),
                    "gauges": dict(self.gauges),
                    "helps": dict(self.helps),
                    "hists": {k: h.snapshot()
                              for k, h in self.hists.items()}}
        finally:
            self._lock.release()


_GLOBAL: Optional[Metrics] = None
_GLOBAL_LOCK = threading.Lock()


def global_metrics() -> Metrics:
    """The process-wide default :class:`Metrics` registry.

    Subsystems that are not handed an explicit registry record here, and
    every registry mirrors its counters and histograms here, so one
    ``summary()`` sees them side by side."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Metrics()
    return _GLOBAL


class Timer:
    def __init__(self, metrics: Metrics, name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        self.metrics.add(self.name, time.perf_counter() - self.t0)


class SummaryWriter:
    """Scalar summary, written BOTH as jsonl (greppable primary format)
    and as TensorBoard event protobufs (``utils/tbwriter.py``) so curves
    open in stock TensorBoard."""

    def __init__(self, log_dir: str, name: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self.path, "a")
        self._closed = False
        self._tb = None
        if tensorboard:
            from bigdl_tpu_torch.utils.tbwriter import TensorBoardWriter

            self._tb = TensorBoardWriter(os.path.join(log_dir, name))

    def add_scalar(self, tag: str, value: float, step: int):
        self._f.write(json.dumps(
            {"step": step, "tag": tag, "value": float(value),
             "wall": time.time()}) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values, step: int):
        if self._tb is not None:
            self._tb.add_histogram(tag, values, step)

    def read_scalar(self, tag: str):
        """(step, value) pairs for one tag — reference
        ``TrainSummary.readScalar``."""
        out = []
        with open(self.path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"] == tag:
                    out.append((rec["step"], rec["value"]))
        return out

    def close(self):
        """Close BOTH sinks — the jsonl file and the TensorBoard event
        writer (whose buffered tail events would otherwise be lost).
        Idempotent: the context-manager exit and an explicit close may
        both run."""
        if self._closed:
            return
        self._closed = True
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *a) -> bool:
        self.close()
        return False


def TrainSummary(log_dir: str, app_name: str) -> SummaryWriter:
    """Reference ``utils/visualization/TrainSummary.scala`` constructor."""
    return SummaryWriter(os.path.join(log_dir, app_name), "train")


def ValidationSummary(log_dir: str, app_name: str) -> SummaryWriter:
    """Reference ``utils/visualization/ValidationSummary.scala``."""
    return SummaryWriter(os.path.join(log_dir, app_name), "validation")
