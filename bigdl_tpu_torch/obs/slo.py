"""Declarative SLOs — sliding-window error budgets and burn-rate alerts.

The port of ``bigdl_tpu.obs.slo``: the same names, wire
formats and semantics.

An :class:`SLOSpec` declares per-tenant objectives::

    {"tenant": "ranker",
     "objectives": {"predict_p99_s": 0.2,      # p99 predict latency <= 200ms
                    "ttft_p99_s": 0.5,         # p99 time-to-first-token
                    "availability": 0.999},    # >= 99.9% answered OK
     "window_s": 30.0}

Latency objectives read the labeled per-tenant histograms
(``serving.tenant_latency_seconds{tenant=...}`` etc.) through the sliding
window ``obs.hist.LogHistogram`` keeps next to its cumulative buckets; a
``predict_p99_s <= X`` objective means "at most 1% of window requests may
exceed X" — the error budget.  The **burn rate** is the observed bad
fraction divided by that budget: 1.0 burns exactly the budget, 2.0
exhausts it in half the window.  Availability objectives count good/bad
from the per-tenant request/expired/failed counters, delta'd per
evaluation tick into the same window math.

Multi-window: every objective is evaluated over its short window AND a
``long_window_factor``× window (the classic fast-burn/sustained-burn
pair); both export as labeled gauges (``slo_burn_rate{tenant=,objective=}``
/ ``slo_burn_rate_long``).  Crossing ``alert_burn`` records an
``slo_burn`` flight-recorder event (cleared with ``slo_burn_cleared``),
and the evaluator folds everything into a **health score** in [0, 1]
(``1 - max_burn / alert_burn``, clamped) that the pool autoscaler and the
serving degradation surface consult (docs/serving.md §Autoscaling).

No recent data is NO burn: an empty window reads NaN from the histogram
(the obs.hist contract) and the objective reports burn 0 with
``samples=0`` — silence must not page anyone.

CLI — the ``SLO_r*.json`` artifact source (burn-rate alert latency under
an injected hard violation; gated lower-better by ``obs.sentinel``)::

    python -m bigdl_tpu_torch.obs.slo --bench
"""

import json
import logging
import math
import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from bigdl_tpu_torch.obs import flight

log = logging.getLogger("bigdl_tpu_torch.obs")

DEFAULT_WINDOW_S = 30.0
DEFAULT_LONG_FACTOR = 6.0
DEFAULT_ALERT_BURN = 1.0

# shorthand objective keys -> the labeled per-tenant histogram they read
# (docs/observability.md §SLOs & burn rates has the spec grammar)
_METRIC_SHORTHAND = {
    "predict": "serving.tenant_latency_seconds",
    "latency": "serving.tenant_latency_seconds",
    "ttft": "serving.tenant_ttft_seconds",
    "queue_wait": "serving.tenant_queue_wait_seconds",
}
_LATENCY_KEY_RE = re.compile(r"^(?P<metric>[a-z_]+)_p(?P<q>\d{1,2})_s$")


@dataclass
class Objective:
    """One normalized objective of one tenant."""

    name: str                 # the spec key ("predict_p99_s", ...)
    kind: str                 # "latency" | "availability"
    target: float             # good-event fraction target (p99 -> 0.99)
    threshold_s: float = 0.0  # latency bound (latency kind only)
    metric: str = ""          # histogram base name (latency kind only)

    @property
    def budget(self) -> float:
        """Allowed bad-event fraction — the error budget denominator."""
        return max(1.0 - self.target, 1e-9)


@dataclass
class SLOSpec:
    """Declarative per-tenant objectives over a sliding window."""

    tenant: str
    objectives: List[Objective]
    window_s: float = DEFAULT_WINDOW_S
    long_window_factor: float = DEFAULT_LONG_FACTOR

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "SLOSpec":
        tenant = str(d.get("tenant", "default"))
        window_s = float(d.get("window_s", DEFAULT_WINDOW_S))
        if window_s <= 0:
            # a zero window would busy-spin the background evaluator
            # (interval_s derives from the shortest window)
            raise ValueError(f"SLO spec for {tenant!r}: window_s must be "
                             f"> 0, got {window_s}")
        long_factor = float(d.get("long_window_factor",
                                  DEFAULT_LONG_FACTOR))
        if long_factor < 1.0:
            raise ValueError(f"SLO spec for {tenant!r}: "
                             f"long_window_factor must be >= 1, got "
                             f"{long_factor}")
        objectives: List[Objective] = []
        raw = d.get("objectives", {})
        if not isinstance(raw, dict) or not raw:
            raise ValueError(f"SLO spec for {tenant!r} needs a non-empty "
                             "'objectives' dict")
        for key, val in raw.items():
            objectives.append(_parse_objective(str(key), val))
        return SLOSpec(
            tenant=tenant, objectives=objectives, window_s=window_s,
            long_window_factor=long_factor)


def _parse_objective(key: str, val: Any) -> Objective:
    """One spec entry -> a normalized :class:`Objective`.

    Grammar: ``availability: Z`` (good-fraction target), or
    ``<metric>_p<NN>_s: X`` — p<NN> sets the target (p99 -> 0.99), X the
    latency bound, ``<metric>`` one of predict/latency/ttft/queue_wait
    (or a full dict ``{"metric": "serving.xyz_seconds", "p": 99,
    "threshold_s": X}`` for histograms outside the shorthand table)."""
    if isinstance(val, dict):
        q = float(val.get("p", 99))
        return Objective(
            name=key, kind=str(val.get("kind", "latency")),
            target=float(val.get("target", 1.0 - (100.0 - q) / 100.0)),
            threshold_s=float(val.get("threshold_s", 0.0)),
            metric=str(val.get("metric", "")))
    if key == "availability":
        z = float(val)
        if not 0.0 < z < 1.0:
            raise ValueError(f"availability target must be in (0, 1); "
                             f"got {z}")
        return Objective(name=key, kind="availability", target=z)
    m = _LATENCY_KEY_RE.match(key)
    if m is None or m.group("metric") not in _METRIC_SHORTHAND:
        raise ValueError(
            f"unknown SLO objective {key!r}: expected 'availability' or "
            f"'<metric>_p<NN>_s' with metric in "
            f"{sorted(_METRIC_SHORTHAND)}")
    q = int(m.group("q"))
    return Objective(name=key, kind="latency",
                     target=1.0 - (100 - q) / 100.0,
                     threshold_s=float(val),
                     metric=_METRIC_SHORTHAND[m.group("metric")])


def load_specs(obj: Any) -> List[SLOSpec]:
    """Coerce the knob surface onto specs: a list of dicts (the
    ``ServingConfig.slo`` / ``EngineConfig.slo_specs`` form), one dict, a
    JSON string, or a path to a JSON file (the ``BIGDL_TPU_SLO_SPECS``
    env form)."""
    if obj is None:
        return []
    if isinstance(obj, SLOSpec):
        return [obj]
    if isinstance(obj, str):
        text = obj
        if not obj.lstrip().startswith(("[", "{")):
            with open(obj) as f:
                text = f.read()
        obj = json.loads(text)
    if isinstance(obj, dict):
        obj = [obj]
    return [s if isinstance(s, SLOSpec) else SLOSpec.from_dict(s)
            for s in obj]


@dataclass
class SLOStatus:
    """One objective's verdict at one evaluation tick."""

    tenant: str
    objective: str
    burn: float               # short-window burn rate (0 = no burn)
    burn_long: float
    budget_remaining: float   # max(0, 1 - burn)
    samples: int              # window events backing the verdict
    burning: bool             # burn >= alert threshold

    def asdict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class SLOEvaluator:
    """Evaluates declared SLOs against a ``Metrics`` registry and exports
    the verdicts as labeled ``slo.*`` gauges.

    Thread model: ``evaluate()`` may be called from any single driver (a
    background thread via :meth:`start`, the serving engine's GC tick via
    :meth:`maybe_evaluate`, or a test directly); internal state is
    lock-guarded so readers (``health_score`` from the autoscaler path)
    never race an evaluation."""

    def __init__(self, specs: Any, metrics=None,
                 alert_burn: float = DEFAULT_ALERT_BURN,
                 interval_s: Optional[float] = None,
                 clock: Callable[[], float] = time.time):
        if metrics is None:
            from bigdl_tpu_torch.optim.metrics import global_metrics

            metrics = global_metrics()
        self.metrics = metrics
        self.specs = load_specs(specs)
        if not self.specs:
            raise ValueError("SLOEvaluator needs at least one spec")
        self.alert_burn = float(alert_burn)
        # default cadence: 6 ticks per shortest window — enough samples
        # for the availability delta ring without busy-polling
        self.interval_s = interval_s if interval_s is not None else \
            min(s.window_s for s in self.specs) / 6.0
        self.clock = clock
        # pre-size the tenant histograms this evaluator will read: the
        # default 60s ring cannot answer a longer spec window (short OR
        # 6x long) — slices keep the SHORT window's resolution.  A
        # histogram that already exists with a smaller ring (traffic
        # preceded the evaluator) is left alone but flagged: its long
        # window is silently capped at what the ring holds
        for spec in self.specs:
            need = spec.window_s * spec.long_window_factor
            slices = min(240, max(6, int(math.ceil(
                need / (spec.window_s / 6.0)))))
            for obj in spec.objectives:
                if obj.kind != "latency" or not obj.metric:
                    continue
                got = self.metrics.ensure_hist(
                    obj.metric, labels={"tenant": spec.tenant},
                    window_s=need, window_slices=slices)
                if got < need:
                    log.warning(
                        "SLO %s/%s: histogram window %.0fs predates this "
                        "evaluator and is shorter than the spec's long "
                        "window %.0fs — burn rates evaluate over the "
                        "shorter ring", spec.tenant, obj.name, got, need)
        self._lock = threading.Lock()
        # availability ring per tenant: (t, good_delta, bad_delta)
        self._avail_ring: Dict[str, deque] = {}
        self._last_counts: Dict[str, Tuple[float, float]] = {}
        self._burning: set = set()          # (tenant, objective) over alert
        self._last_eval_t = float("-inf")
        self._last_statuses: List[SLOStatus] = []
        self._health = 1.0
        self._tenant_health: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- reads (autoscaler / degradation / health endpoints) ----------------
    def health_score(self) -> float:
        """Pool health in [0, 1]: ``1 - max_burn / alert_burn`` clamped —
        1.0 while every budget holds, 0.0 once any objective burns at or
        past the alert threshold.  1.0 before the first evaluation (no
        verdict is not a bad verdict)."""
        with self._lock:
            return self._health

    def tenant_health(self, tenant: str) -> float:
        with self._lock:
            return self._tenant_health.get(tenant, 1.0)

    def statuses(self) -> List[SLOStatus]:
        with self._lock:
            return list(self._last_statuses)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-safe verdict summary for ``/health``."""
        with self._lock:
            return {"health": self._health,
                    "tenants": dict(self._tenant_health),
                    "alert_burn": self.alert_burn,
                    "objectives": [s.asdict()
                                   for s in self._last_statuses]}

    # -- evaluation ---------------------------------------------------------
    def maybe_evaluate(self, now: Optional[float] = None
                       ) -> Optional[List[SLOStatus]]:
        """Rate-limited :meth:`evaluate` — safe to call from a hot-ish
        loop (the serving engine piggybacks it on the result-GC tick)."""
        now = self.clock() if now is None else now
        with self._lock:
            if now - self._last_eval_t < self.interval_s:
                return None
        return self.evaluate(now)

    def evaluate(self, now: Optional[float] = None) -> List[SLOStatus]:
        now = self.clock() if now is None else now
        statuses: List[SLOStatus] = []
        for spec in self.specs:
            self._tick_availability(spec, now)
            for obj in spec.objectives:
                statuses.append(self._evaluate_one(spec, obj, now))
        by_tenant: Dict[str, float] = {}
        for st in statuses:
            by_tenant[st.tenant] = max(by_tenant.get(st.tenant, 0.0),
                                       st.burn)
        max_burn = max(by_tenant.values(), default=0.0)
        health = max(0.0, 1.0 - max_burn / self.alert_burn)
        tenant_health = {t: max(0.0, 1.0 - b / self.alert_burn)
                         for t, b in by_tenant.items()}
        with self._lock:
            self._last_eval_t = now
            self._last_statuses = statuses
            self._health = health
            self._tenant_health = tenant_health
        self.metrics.gauge("slo.health", health)
        for t, h in tenant_health.items():
            self.metrics.gauge("slo.tenant_health", h,
                               labels={"tenant": t})
        return statuses

    def _tick_availability(self, spec: SLOSpec, now: float) -> None:
        """Sample the tenant's cumulative good/bad counters into the
        delta ring (counters only move forward; a window sum of deltas is
        the windowed event count the budget math needs)."""
        t = spec.tenant
        lb = {"tenant": t}
        from bigdl_tpu_torch.optim.metrics import label_key

        good = self.metrics.counter(
            label_key("serving.tenant_requests_total", **lb))
        bad = (self.metrics.counter(
                   label_key("serving.tenant_expired_total", **lb))
               + self.metrics.counter(
                   label_key("serving.tenant_failed_total", **lb)))
        ring = self._avail_ring.setdefault(t, deque())
        last = self._last_counts.get(t)
        if last is not None:
            dg, db = good - last[0], bad - last[1]
            if dg or db:
                ring.append((now, max(dg, 0.0), max(db, 0.0)))
        self._last_counts[t] = (good, bad)
        horizon = now - spec.window_s * spec.long_window_factor
        while ring and ring[0][0] < horizon:
            ring.popleft()

    def _avail_fracs(self, spec: SLOSpec, now: float
                     ) -> Tuple[float, float, int]:
        """(short bad fraction, long bad fraction, short window events)
        from the delta ring; NaN fractions when the window saw nothing."""
        ring = self._avail_ring.get(spec.tenant, ())

        def frac(window: float) -> Tuple[float, int]:
            g = b = 0.0
            for t, dg, db in ring:
                if t >= now - window:
                    g += dg
                    b += db
            total = g + b
            return ((b / total) if total else float("nan"), int(total))

        short, n = frac(spec.window_s)
        long_, _ = frac(spec.window_s * spec.long_window_factor)
        return short, long_, n

    def _evaluate_one(self, spec: SLOSpec, obj: Objective,
                      now: float) -> SLOStatus:
        lb = {"tenant": spec.tenant}
        if obj.kind == "availability":
            bad_s, bad_l, n = self._avail_fracs(spec, now)
        else:
            bad_s = self.metrics.window_fraction_over(
                obj.metric, obj.threshold_s, labels=lb,
                window_s=spec.window_s, now=now)
            bad_l = self.metrics.window_fraction_over(
                obj.metric, obj.threshold_s, labels=lb,
                window_s=spec.window_s * spec.long_window_factor, now=now)
            n = self.metrics.window_count(obj.metric, labels=lb,
                                          window_s=spec.window_s, now=now)
        # NaN = empty window = no burn: silence must not page anyone
        burn = 0.0 if math.isnan(bad_s) else bad_s / obj.budget
        burn_long = 0.0 if math.isnan(bad_l) else bad_l / obj.budget
        labels = {"tenant": spec.tenant, "objective": obj.name}
        self.metrics.gauge("slo.burn_rate", burn, labels=labels)
        self.metrics.gauge("slo.burn_rate_long", burn_long, labels=labels)
        self.metrics.gauge("slo.budget_remaining",
                           max(0.0, 1.0 - burn), labels=labels)
        key = (spec.tenant, obj.name)
        burning = burn >= self.alert_burn
        if burning and key not in self._burning:
            self._burning.add(key)
            self.metrics.inc("slo.burn_events_total")
            flight.record("slo_burn", tenant=spec.tenant,
                          objective=obj.name, burn=round(burn, 4),
                          burn_long=round(burn_long, 4),
                          threshold_s=obj.threshold_s,
                          target=obj.target, window_s=spec.window_s,
                          samples=n)
            log.warning("SLO BURN: tenant %s objective %s burn=%.2f "
                        "(alert >= %.2f, window %.0fs, %d events)",
                        spec.tenant, obj.name, burn, self.alert_burn,
                        spec.window_s, n)
        elif not burning and key in self._burning:
            self._burning.discard(key)
            flight.record("slo_burn_cleared", tenant=spec.tenant,
                          objective=obj.name, burn=round(burn, 4))
            log.info("SLO recovered: tenant %s objective %s burn=%.2f",
                     spec.tenant, obj.name, burn)
        return SLOStatus(tenant=spec.tenant, objective=obj.name,
                         burn=burn, burn_long=burn_long,
                         budget_remaining=max(0.0, 1.0 - burn),
                         samples=n, burning=burning)

    # -- background loop ----------------------------------------------------
    def start(self, interval_s: Optional[float] = None) -> "SLOEvaluator":
        if interval_s is not None:
            self.interval_s = interval_s
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.evaluate()
                except Exception as e:  # noqa: BLE001 — an evaluator tick
                    # must never take the host process down with it
                    log.warning("SLO evaluation failed: %s", e)

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="bigdl-tpu-slo")
        self._thread.start()
        return self


    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 1)
            self._thread = None


def evaluator_from_env(metrics=None,
                       alert_burn: float = DEFAULT_ALERT_BURN
                       ) -> Optional[SLOEvaluator]:
    """Build an evaluator from ``BIGDL_TPU_SLO_SPECS`` (inline JSON or a
    JSON file path); None when the env is unset or unparseable — a bad
    spec degrades observability, never serving."""
    raw = os.environ.get("BIGDL_TPU_SLO_SPECS")
    if not raw:
        return None
    try:
        return SLOEvaluator(load_specs(raw), metrics=metrics,
                            alert_burn=alert_burn)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        log.error("BIGDL_TPU_SLO_SPECS unusable (%s); SLO evaluation "
                  "disabled", e)
        return None


# ---------------------------------------------------------------------------
# the SLO_r*.json artifact source: burn-rate alert latency under load
# ---------------------------------------------------------------------------

def bench(window_s: float = 2.0, warm_s: float = 1.0,
          threshold_s: float = 0.05, rate_hz: float = 200.0,
          timeout_s: float = 10.0) -> Dict[str, Any]:
    """Measure how fast the burn-rate alert fires after a hard SLO
    violation starts — THE number that decides whether an operator pages
    in seconds or in minutes.  Real wall clock on a compressed geometry
    (2s windows): feed in-budget latencies for ``warm_s``, then switch
    every request to 4x the objective bound and count evaluation TICKS
    until ``burn >= alert`` — the reported latency is ``ticks *
    interval``, quantized to the evaluation cadence so the committed
    artifact is stable run-to-run (a sub-tick wall measurement would
    gate on scheduler phase noise, not detection quality).  Gated
    lower-better by the sentinel's SLO family; ``slo_burn_peak`` gates
    higher-better (the detector must keep SEEING a hard violation as a
    hard burn)."""
    from bigdl_tpu_torch.optim.metrics import Metrics

    m = Metrics()
    spec = SLOSpec.from_dict({
        "tenant": "bench",
        "objectives": {"predict_p99_s": threshold_s},
        "window_s": window_s})
    interval = window_s / 20.0
    ev = SLOEvaluator([spec], metrics=m, interval_s=interval)
    lb = {"tenant": "bench"}
    period = 1.0 / rate_hz
    t0 = time.time()
    while time.time() - t0 < warm_s:
        m.observe("serving.tenant_latency_seconds", threshold_s / 5,
                  labels=lb)
        ev.maybe_evaluate()
        time.sleep(period)
    warm_burn = max((s.burn for s in ev.statuses()), default=0.0)
    inject_t = time.time()
    alert_latency = None
    burn_peak = 0.0
    ticks = 0
    while time.time() - inject_t < timeout_s:
        # one full evaluation tick: violating traffic, then the verdict
        tick_end = inject_t + (ticks + 1) * interval
        while time.time() < tick_end:
            m.observe("serving.tenant_latency_seconds", threshold_s * 4,
                      labels=lb)
            time.sleep(period)
        ticks += 1
        burn = max((s.burn for s in ev.evaluate()), default=0.0)
        burn_peak = max(burn_peak, burn)
        if alert_latency is None and burn >= ev.alert_burn:
            alert_latency = ticks * interval
        if alert_latency is not None \
                and ticks * interval >= alert_latency + 5 * interval:
            break  # peak sampled well past the crossing; done
    row: Dict[str, Any] = {
        "metric": "slo_alert",
        "slo_alert_latency_s": alert_latency,
        "slo_burn_peak": round(burn_peak, 3),
        "warm_burn": round(warm_burn, 4),
        "window_s": window_s,
        "eval_interval_s": interval,
        "threshold_s": threshold_s,
        "alert_burn": ev.alert_burn,
        "evals_after_injection": ticks,
        "geometry": "inject_hard_violation_w2",
    }
    if alert_latency is None:
        row["error"] = "burn rate never crossed the alert threshold"
    elif warm_burn >= ev.alert_burn:
        row["error"] = "alert was already firing before the injection"
    return row


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="bigdl_tpu_torch.obs.slo",
        description="SLO burn-rate alert-latency bench (the SLO_r*.json "
                    "artifact source; docs/observability.md §SLOs & burn "
                    "rates)")
    ap.add_argument("--bench", action="store_true",
                    help="measure burn-rate alert latency under an "
                         "injected hard violation")
    ap.add_argument("--window", type=float, default=2.0)
    ap.add_argument("--out", default=None,
                    help="also write the JSON row to this path")
    args = ap.parse_args(argv)
    if not args.bench:
        ap.error("nothing to do (use --bench)")
    row = bench(window_s=args.window)
    print(json.dumps(row))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
    if "error" in row:
        return 1
    # the gate the CI step enforces: detection inside ONE window
    return 0 if row["slo_alert_latency_s"] <= args.window else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
