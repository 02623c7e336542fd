"""ServingServer — the Cluster-Serving streaming engine.

The port of ``bigdl_tpu.serving.server``: the same names, wire
formats and semantics.

The transport is an in-process (or file-backed) queue pair —
Redis/Flink are cluster plumbing, not capability — while the batching loop,
backpressure and at-least-once result delivery semantics match.  Client
threads only enqueue; the engine owns the card.

Continuous batching (docs/serving.md §Continuous batching): the engine is
TWO threads with a double-buffered handoff.  The *assembler* builds the
next batch — popping per-model heaps in deadline order, so a near-expiry
request jumps the window — WHILE the *predict* thread runs the current
one; assembly time hides under predict time instead of stalling behind
it, which is what turns the fixed-window loop's 21× p99/p50 tail ratio
into throughput.  Wakeup is event-driven (one condition variable fed by
``enqueue``): no polling loop, no idle CPU burn, no 50 ms of avoidable
sparse-traffic latency.  The legacy fixed-window loop survives behind
``ServingConfig(continuous=False)`` as the parity reference.

Multi-tenancy: a model registry (``register_model``) gives every model its
own bounded admission heap, weighted stride scheduling across tenants
sharing the one predict engine, per-tenant degradation/fallback, and
per-tenant ``serving.tenant.<name>.*`` latency/queue metrics — one
``/metrics`` scrape shows every tenant's SLO.

Request lifecycle (docs/serving.md has the state machine): every request
carries an admission time and an absolute deadline from ``enqueue``
through the queue into the batch loop.  Admission fails fast — a full
queue sheds (``ServiceUnavailableError``, never an unbounded block), a
degraded tenant sheds (half-open probing excepted) — and the engine drops
expired requests BEFORE predict so a slow model never spends card time
answering a client that already gave up.  Completed results live in a
TTL'd table so an abandoned ``query`` cannot leak entries forever, and
shutdown is explicit: ``drain()`` finishes queued work, plain ``stop()``
fails it with ``RequestDroppedError`` — queued requests are never
silently discarded.
"""

import heapq
import logging
import math
import re
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from bigdl_tpu_torch.obs import flight, trace
from bigdl_tpu_torch.optim.metrics import Metrics, Timer, global_metrics
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving.decode_engine import DeadlineExceededError
from bigdl_tpu_torch.serving.inference_model import InferenceModel

log = logging.getLogger("bigdl_tpu_torch.serving")

# registered model names become metric names and URL/JSON tokens; keep
# them to the same header-safe grammar as request ids
MODEL_NAME_RE = re.compile(r"[A-Za-z0-9._\-]{1,64}")

DEFAULT_MODEL = "default"


@dataclass
class ServingConfig:
    """Reference config.yaml surface: modelPath, batchSize, timeout."""

    batch_size: int = 32
    batch_timeout_s: float = 0.005
    queue_capacity: int = 4096
    # the engine mode: continuous (assembler builds the next batch while
    # predict runs the current one) vs the legacy fixed-window loop kept
    # as the parity/regression reference
    continuous: bool = True
    # cap on stacked rows per predict batch; None derives it from the
    # model's largest batch bucket so one batch is one compiled program
    max_batch_rows: Optional[int] = None
    # graceful degradation: after this many CONSECUTIVE failed predict
    # batches a TENANT is 'degraded' — it serves from its last-good
    # fallback model if one is set, and sheds new load otherwise
    degraded_after_failures: int = 3
    # half-open probing while degraded WITHOUT a fallback: one request per
    # interval is admitted as a probe so a recovered model can clear
    # degradation by itself (otherwise shedding is permanent: recovery
    # only happens inside _process, which needs an admitted request)
    degraded_probe_interval_s: float = 1.0
    # -- request lifecycle --------------------------------------------------
    # deadline stamped at admission when the caller passes none; None means
    # requests never expire (the pre-lifecycle behavior)
    default_deadline_s: Optional[float] = None
    # how long enqueue may wait on a FULL queue before shedding; 0 sheds
    # immediately.  Bounded by construction — there is no blocking mode
    enqueue_block_s: float = 0.0
    # Retry-After hint attached to sheds (HTTP 429 surfaces it verbatim)
    retry_after_s: float = 1.0
    # completed-but-never-queried results are GC'd after this long; the
    # sweep runs on the engine thread between batches
    result_ttl_s: float = 60.0
    result_gc_interval_s: float = 1.0
    # default budget for stop(drain=True) / drain()
    drain_timeout_s: float = 10.0
    # declarative per-tenant SLOs (docs/observability.md §SLOs & burn
    # rates): a list of spec dicts ({"tenant", "objectives", "window_s"}),
    # inline JSON, or a JSON file path — same grammar as
    # BIGDL_TPU_SLO_SPECS, which applies when this is None.  Evaluation
    # piggybacks on the engine's result-GC tick; burn rates export as
    # slo.* gauges and feed the pool autoscaler's health signal
    slo: Optional[Any] = None
    slo_alert_burn: float = 1.0


class ServiceUnavailableError(RuntimeError):
    """Raised by ``enqueue`` when the server cannot accept the request —
    degraded with no fallback model, queue full (backpressure), draining,
    or stopped — so callers fail fast at admission and retry another
    replica instead of queueing into one that cannot answer.
    ``retry_after`` is the backoff hint (HTTP 429 ``Retry-After``)."""

    def __init__(self, msg: str, retry_after: float = 1.0):
        super().__init__(msg)
        self.retry_after = retry_after


class RequestDroppedError(RuntimeError):
    """Delivered to ``query`` for requests still queued when the server
    stopped without (or past) a drain — an explicit verdict, never a
    silent drop."""

    def __init__(self, rid: str):
        super().__init__(f"request {rid} dropped: server stopped before it "
                         "was processed")
        self.rid = rid


@dataclass
class _Request:
    """One queued request: payload + lifecycle timestamps (absolute)."""

    rid: str
    arr: np.ndarray
    admit_t: float
    deadline_t: float  # math.inf when the request never expires
    model: str = DEFAULT_MODEL
    seq: int = 0       # admission order — the deadline-heap tiebreak

    @property
    def rows(self) -> int:
        return self.arr.shape[0] if self.arr.ndim > 1 else 1


@dataclass
class _Tenant:
    """One registered model: its admission heap + scheduling and
    degradation state.  Heap entries are ``(deadline_t, seq, req)`` so
    near-expiry requests sort first and no-deadline requests stay FIFO."""

    name: str
    model: Any
    weight: float = 1.0
    fallback: Optional[Any] = None
    heap: List = field(default_factory=list)
    # stride-scheduling position: the assembler serves the tenant with the
    # lowest pass value; serving k requests advances it by k/weight, so
    # long-run service is proportional to weight
    pass_value: float = 0.0
    degraded: bool = False
    consecutive_failures: int = 0
    last_probe_t: float = 0.0

    def rows_cap(self, cfg: ServingConfig) -> Optional[int]:
        if cfg.max_batch_rows is not None:
            return cfg.max_batch_rows
        buckets = getattr(self.model, "buckets", None)
        return max(buckets) if buckets else None


class _QueueView:
    """Read-only queue facade: ``qsize``/``empty`` over the per-tenant
    heaps, so callers (and tests) that watched the old ``queue.Queue``
    keep one stable surface."""

    def __init__(self, srv: "ServingServer"):
        self._srv = srv

    def qsize(self) -> int:
        with self._srv._work_cv:
            return sum(len(t.heap) for t in self._srv._tenants.values())

    def empty(self) -> bool:
        return self.qsize() == 0


class ServingServer:
    """per-model heaps -> continuous batch assembly -> predict ->
    result table.

    Resilience posture (reference Cluster-Serving keeps serving while a
    replica restarts): a streak of predict failures flips a tenant to
    DEGRADED.  Degraded with a fallback model (``set_fallback_model`` —
    typically the previous good version) keeps answering from it;
    degraded without one sheds that tenant's new load at ``enqueue`` so
    callers retry another replica — other tenants are unaffected.
    ``reload_model`` installs a restarted replica's model and clears
    degradation.

    Every lifecycle event (shed, expiry, drain, drop, GC) lands in
    ``stats`` and — namespaced ``serving.*`` — in the process
    :class:`~bigdl_tpu_torch.optim.metrics.Metrics` registry, so ``/health``
    and training-side metric consumers see the same counters."""

    def __init__(self, model: Optional[InferenceModel] = None,
                 config: Optional[ServingConfig] = None,
                 metrics: Optional[Metrics] = None,
                 models: Optional[Dict[str, Any]] = None):
        self.config = config or ServingConfig()
        self.metrics = metrics or global_metrics()
        self._results: Dict[str, Any] = {}
        self._result_expiry: Dict[str, float] = {}
        # rids admitted but not yet published — with caller-supplied ids
        # (X-Request-Id) a duplicate of an IN-FLIGHT id must be rejected
        # at admission, or two waiters would race one _results slot
        self._pending: set = set()
        # the generate subset of _pending: decode requests live in the
        # engine's slot scheduler, not the tenant heaps, so backlog()
        # would otherwise go blind to them the moment they are admitted
        self._generate_pending: set = set()
        self._result_cv = threading.Condition()
        self._last_gc_t = 0.0
        self._stop = threading.Event()
        self._draining = False
        self._busy = False  # engine is expiring/predicting a batch
        self._threads: List[threading.Thread] = []
        self._probe_lock = threading.Lock()
        # -- work board: tenant heaps + the double-buffered handoff slot.
        # ONE condition carries every engine wakeup: enqueue (new work),
        # batch handoff (slot filled), predict going idle (slot free),
        # heap pops (queue room for bounded enqueue waiters), stop.
        self._work_cv = threading.Condition()
        self._tenants: Dict[str, _Tenant] = {}
        self._slot: Optional[List[_Request]] = None
        self._predict_waiting = False
        self._assembling_n = 0   # requests popped into a batch being built
        self._seq_n = 0
        self._predict_ema_s = 0.01  # urgency horizon for deadline jumps
        self._in = _QueueView(self)
        # fleet role (docs/serving.md §Decode fleet): "both" serves
        # everything; "prefill" workers run chunked prefill and hand KV
        # pages off; "decode" workers run the token loop.  Advisory — the
        # pool proxy routes on it via /health; the server itself never
        # refuses work, so a mis-roled request still gets an answer
        self.role = "both"
        if models:
            for name, m in models.items():
                self.register_model(name, m)
            self._default_name = DEFAULT_MODEL if DEFAULT_MODEL in models \
                else next(iter(models))
        elif model is not None:
            self.register_model(DEFAULT_MODEL, model)
            self._default_name = DEFAULT_MODEL
        else:
            raise ValueError("need a model (or models={name: model, ...})")
        self._stats_lock = threading.Lock()
        self.stats = {"batches": 0, "requests": 0, "failed_batches": 0,
                      "fallback_batches": 0, "shed_requests": 0,
                      "expired_requests": 0, "drained_requests": 0,
                      "dropped_requests": 0, "results_gc": 0}
        # migrated-in KV handoffs parked until the pool proxy re-places
        # the stream here with resume_from (docs/serving.md §Fleet fault
        # tolerance): rid -> (park time, handoff dict).  Bounded + TTL'd
        # — an orphaned park (proxy never resumed) must not pin host KV
        # images forever
        self._parked: Dict[str, tuple] = {}
        self._parked_lock = threading.Lock()
        # /metrics HELP lines for the lifecycle counters a fleet alerts on
        # (obs.export renders describe() strings next to # TYPE)
        self.metrics.describe("serving.shed_requests",
                              "requests rejected at admission "
                              "(backpressure/degraded/draining)")
        self.metrics.describe("serving.expired_requests",
                              "requests dropped before predict: deadline "
                              "already expired")
        self.metrics.describe("serving.predict_s",
                              "model predict wall time per batch")
        self.metrics.describe("serving.queue_wait_s",
                              "admission-to-predict queue wait per request "
                              "(latency_s minus this is predict+publish)")
        self.metrics.describe("serving.batch_occupancy",
                              "cumulative avg batch fill / batch_size")
        self.metrics.describe("serving.queue_depth",
                              "requests queued across all model heaps")
        # declarative SLOs: explicit config wins, BIGDL_TPU_SLO_SPECS
        # applies fleet-wide; a bad spec degrades observability only
        self.slo = None
        try:
            if self.config.slo is not None:
                from bigdl_tpu_torch.obs.slo import SLOEvaluator

                self.slo = SLOEvaluator(
                    self.config.slo, metrics=self.metrics,
                    alert_burn=self.config.slo_alert_burn)
            else:
                from bigdl_tpu_torch.obs.slo import evaluator_from_env

                self.slo = evaluator_from_env(
                    metrics=self.metrics,
                    alert_burn=self.config.slo_alert_burn)
        except Exception as e:  # noqa: BLE001 — serving must start anyway
            log.error("SLO spec unusable (%s); SLO evaluation disabled", e)

    # -- model registry -----------------------------------------------------
    def register_model(self, name: str, model: Any,
                       weight: float = 1.0) -> "ServingServer":
        """Add a tenant: its own bounded queue and SLO accounting, sharing
        this engine's predict loop under weighted admission."""
        if not MODEL_NAME_RE.fullmatch(name):
            raise ValueError(f"bad model name {name!r}: must match "
                             "[A-Za-z0-9._-]{1,64}")
        if weight <= 0:
            raise ValueError(f"model weight must be > 0, got {weight}")
        with self._work_cv:
            if name in self._tenants:
                raise ValueError(f"model {name!r} already registered; use "
                                 "reload_model to replace it")
            t = _Tenant(name, model, float(weight))
            # join the stride rotation at the current frontier: a new
            # tenant must not replay the service its peers already used
            if self._tenants:
                t.pass_value = max(x.pass_value
                                   for x in self._tenants.values())
            self._tenants[name] = t
        self.metrics.describe(f"serving.tenant.{name}.latency_s",
                              f"model {name}: admission-to-publish latency")
        return self

    def unregister_model(self, name: str) -> None:
        """Remove a tenant; its queued requests get an explicit
        :class:`RequestDroppedError` — never a silent drop."""
        if name == self._default_name:
            raise ValueError(f"cannot unregister the default model {name!r}")
        with self._work_cv:
            t = self._tenants.pop(name, None)
            reqs = [r for _, _, r in t.heap] if t else []
            self._work_cv.notify_all()
        if reqs:
            self._deliver_dropped(reqs)

    def models(self) -> Dict[str, dict]:
        """Registry snapshot for ``GET /models`` and the autoscaler."""
        with self._work_cv:
            return {t.name: {"weight": t.weight, "degraded": t.degraded,
                             "queue_depth": len(t.heap),
                             "default": t.name == self._default_name,
                             "fallback": t.fallback is not None}
                    for t in self._tenants.values()}

    def backlog(self) -> int:
        """Admitted requests not yet answered: tenant heaps + the
        assembled handoff slot + a batch mid-assembly + generate
        requests living in the decode engine.  THE autoscaling and
        fleet-routing pressure signal — the heaps alone go quiet once
        the double buffer absorbs a backlog, and generate requests
        never touch the heaps at all (``_QueueView.qsize`` stays
        heap-only: it is the bounded-admission capacity the enqueue
        path enforces)."""
        with self._result_cv:
            generating = len(self._generate_pending)
        with self._work_cv:
            return (sum(len(t.heap) for t in self._tenants.values())
                    + (len(self._slot) if self._slot else 0)
                    + self._assembling_n + generating)

    def decode_pressure(self) -> Dict[str, Any]:
        """Aggregated decode-engine capacity across tenants — the
        ``decode`` block of ``/health`` the fleet router places
        ``/generate`` by (docs/serving.md §Decode fleet).  Only engines
        already built are consulted (a Seq2SeqService's lazy engine is
        not forced into existence by a health probe); numeric fields sum
        across tenants, and ``generate_inflight`` counts admitted
        generate requests not yet resolved."""
        agg: Dict[str, Any] = {}
        for t in list(self._tenants.values()):
            engine = getattr(t.model, "decode_engine", None)
            pressure = getattr(engine, "decode_pressure", None)
            if pressure is None:
                continue
            for k, v in pressure().items():
                if k == "kv_bytes_per_page":
                    # a per-page PROPERTY, not a capacity count: summing
                    # across tenants would inflate it.  Report the max —
                    # the conservative per-page cost for the router
                    agg[k] = max(agg.get(k, 0), v)
                elif k == "page_dtype":
                    # tenants should agree; if they don't, say so rather
                    # than letting the first tenant's dtype win and the
                    # router misprice the rest
                    agg[k] = v if agg.get(k, v) == v else "mixed"
                elif isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0) + v
                elif k not in agg:   # e.g. the prefix_cache stats dict
                    agg[k] = v
        with self._result_cv:
            agg["generate_inflight"] = len(self._generate_pending)
        return agg

    def slo_health(self) -> float:
        """The SLO health score in [0, 1] (1.0 with no evaluator or no
        verdict yet) — consulted by ``/health``, the pool autoscaler, and
        operator degradation tooling (docs/observability.md §SLOs &
        burn rates)."""
        return self.slo.health_score() if self.slo is not None else 1.0

    def _tenant_series(self, name: str, kind: str, value: float = 1.0
                       ) -> None:
        """One per-tenant signal, recorded BOTH ways: the legacy
        name-embedded ``serving.tenant.<name>.<kind>`` series (deprecated
        alias, kept one release) and the label-form family
        (``serving.tenant_latency_seconds{tenant="..."}`` — the form a
        fleet's Prometheus can aggregate across)."""
        lb = {"tenant": name}
        if kind == "latency":
            self.metrics.observe(f"serving.tenant.{name}.latency_s", value)
            self.metrics.observe("serving.tenant_latency_seconds", value,
                                 labels=lb)
        elif kind == "queue_wait":
            self.metrics.observe(f"serving.tenant.{name}.queue_wait_s",
                                 value)
            self.metrics.observe("serving.tenant_queue_wait_seconds",
                                 value, labels=lb)
        elif kind == "ttft":
            self.metrics.observe(f"serving.tenant.{name}.ttft_s", value)
            self.metrics.observe("serving.tenant_ttft_seconds", value,
                                 labels=lb)
        elif kind == "queue_depth":
            self.metrics.gauge(f"serving.tenant.{name}.queue_depth", value)
            self.metrics.gauge("serving.tenant_queue_depth", value,
                               labels=lb)
        elif kind == "requests":
            self.metrics.inc(f"serving.tenant.{name}.requests", value)
            self.metrics.inc("serving.tenant_requests_total", value,
                             labels=lb)
        elif kind == "expired":
            self.metrics.inc(f"serving.tenant.{name}.expired", value)
            self.metrics.inc("serving.tenant_expired_total", value,
                             labels=lb)
        elif kind == "failed":
            self.metrics.inc(f"serving.tenant.{name}.failed", value)
            self.metrics.inc("serving.tenant_failed_total", value,
                             labels=lb)
        else:  # pragma: no cover — programming error, not data
            raise ValueError(f"unknown tenant series kind {kind!r}")

    def _default(self) -> _Tenant:
        return self._tenants[self._default_name]

    # single-model compatibility surface: the pre-registry API (and the
    # chaos suite) reads/writes these on the server itself
    @property
    def model(self):
        return self._default().model

    @model.setter
    def model(self, m) -> None:
        self._default().model = m

    @property
    def degraded(self) -> bool:
        return self._default().degraded

    @degraded.setter
    def degraded(self, v: bool) -> None:
        self._default().degraded = v

    @property
    def _fallback_model(self):
        return self._default().fallback

    @_fallback_model.setter
    def _fallback_model(self, m) -> None:
        self._default().fallback = m

    @property
    def _last_probe_t(self) -> float:
        return self._default().last_probe_t

    @_last_probe_t.setter
    def _last_probe_t(self, t: float) -> None:
        self._default().last_probe_t = t

    @property
    def _consecutive_failures(self) -> int:
        return self._default().consecutive_failures

    @_consecutive_failures.setter
    def _consecutive_failures(self, n: int) -> None:
        self._default().consecutive_failures = n

    def _count(self, name: str, n: int = 1) -> None:
        # client threads and the engine thread both count; += on a dict
        # entry is not atomic, and tests assert exact counter values
        with self._stats_lock:
            self.stats[name] += n
            self.metrics.inc(f"serving.{name}", n)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingServer":
        if self.config.continuous:
            self._threads = [
                threading.Thread(target=self._assemble_run, daemon=True,
                                 name="serving-assembler"),
                threading.Thread(target=self._predict_run, daemon=True,
                                 name="serving-predict"),
            ]
        else:
            self._threads = [threading.Thread(target=self._run_fixed,
                                              daemon=True,
                                              name="serving-engine")]
        for t in self._threads:
            t.start()
        return self

    def _work_pending(self) -> bool:
        """Anything still owed an answer: queued, being assembled, parked
        in the handoff slot, or in predict."""
        with self._work_cv:
            return (self._busy or self._slot is not None
                    or self._assembling_n > 0
                    or any(t.heap for t in self._tenants.values()))

    def drain(self, timeout: Optional[float] = None) -> Dict[str, int]:
        """Graceful shutdown: stop admitting, let the engine finish queued
        and in-flight work within ``timeout``, then stop.  Requests still
        queued when the budget runs out get an explicit
        :class:`RequestDroppedError`.  Returns ``{"drained": n, "dropped":
        m}`` for the caller's log line."""
        timeout = self.config.drain_timeout_s if timeout is None else timeout
        self._draining = True
        t_end = time.time() + timeout
        drained_from = self.stats["requests"]
        while time.time() < t_end:
            if not self._work_pending():
                break
            time.sleep(0.005)
        self._shutdown_threads(join_timeout=max(timeout, 5))
        dropped = self._fail_queued()
        drained = self.stats["requests"] - drained_from
        self._count("drained_requests", drained)
        if dropped:
            log.warning("serving drain: budget exhausted, %d queued "
                        "requests dropped with explicit errors", dropped)
        return {"drained": drained, "dropped": dropped}

    def stop(self, drain: bool = False,
             timeout: Optional[float] = None) -> None:
        """Stop the engine.  ``drain=True`` finishes queued work first
        (see :meth:`drain`); otherwise queued requests are failed
        explicitly with :class:`RequestDroppedError` — never silently
        discarded."""
        if drain:
            self.drain(timeout)
            return
        self._draining = True
        self._shutdown_threads(join_timeout=5)
        self._fail_queued()

    def _shutdown_threads(self, join_timeout: float) -> None:
        self._stop.set()
        with self._work_cv:
            self._work_cv.notify_all()
        for t in self._threads:
            t.join(timeout=join_timeout)

    def _deliver_dropped(self, reqs: List[_Request]) -> int:
        now = time.time()
        with self._result_cv:
            for req in reqs:
                self._results[req.rid] = RequestDroppedError(req.rid)
                self._result_expiry[req.rid] = now + self.config.result_ttl_s
                self._pending.discard(req.rid)
            if reqs:
                self._result_cv.notify_all()
        if reqs:
            self._count("dropped_requests", len(reqs))
            flight.record("serving_requests_dropped", count=len(reqs))
        return len(reqs)

    def _fail_queued(self) -> int:
        """Deliver RequestDroppedError to everything still queued —
        including a batch parked in the handoff slot."""
        with self._work_cv:
            reqs: List[_Request] = []
            for t in self._tenants.values():
                reqs.extend(r for _, _, r in t.heap)
                t.heap.clear()
            if self._slot is not None:
                reqs.extend(self._slot)
                self._slot = None
            self._work_cv.notify_all()
        return self._deliver_dropped(reqs)

    # -- degradation control ------------------------------------------------
    def set_fallback_model(self, model: Any,
                           name: Optional[str] = None) -> "ServingServer":
        """Register the last-good model; while degraded, that tenant's
        batches are served from it instead of failing."""
        self._tenants[name or self._default_name].fallback = model
        return self

    def reload_model(self, model: Any, name: Optional[str] = None) -> None:
        """Install a (restarted) replica's model; the old primary becomes
        the fallback and degradation clears."""
        t = self._tenants[name or self._default_name]
        t.fallback = t.model if not t.degraded else t.fallback
        t.model = model
        t.consecutive_failures = 0
        if t.degraded:
            log.info("serving: model %s reloaded; leaving degraded mode",
                     t.name)
            flight.record("serving_recovered", via="reload_model",
                          model=t.name)
        t.degraded = False

    def predict_inline(self, name: str, arr: np.ndarray) -> np.ndarray:
        """Run one batch through tenant ``name``'s model ON THE CALLER'S
        thread — the pipeline fast path for a stage whose input was
        already produced by an admitted request (recall -> ranking in
        ``friesian/pipeline.py``): candidates never re-enter admission,
        so an accepted recommend cannot be shed halfway through by its
        own second stage.  Tenant health accounting matches the engine
        loop — success clears the failure streak (and degradation),
        failures feed the degradation threshold and the fallback model
        answers when one exists; degraded-without-fallback sheds with
        :class:`ServiceUnavailableError` like admission would."""
        cfg = self.config
        with self._work_cv:
            tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._tenants)}")
        if tenant.degraded and tenant.fallback is None:
            self._count("shed_requests")
            raise ServiceUnavailableError(
                f"model {name!r} is degraded with no fallback; retry "
                "against another replica", retry_after=cfg.retry_after_s)
        stacked = np.asarray(arr)
        n = int(stacked.shape[0]) if stacked.ndim else 1
        use_fallback = tenant.degraded and tenant.fallback is not None
        primary = tenant.fallback if use_fallback else tenant.model
        t0 = time.time()
        out = None
        try:
            out = primary.predict(stacked)
            tenant.consecutive_failures = 0
            if not use_fallback and tenant.degraded:
                log.info("serving: inline predict recovered; %s leaving "
                         "degraded mode", tenant.name)
                tenant.degraded = False
                flight.record("serving_recovered",
                              via="predict_inline_success",
                              model=tenant.name)
        except Exception as e:
            tenant.consecutive_failures += 1
            self._count("failed_batches")
            if (not tenant.degraded and tenant.consecutive_failures
                    >= cfg.degraded_after_failures):
                tenant.degraded = True
                log.error(
                    "serving: %d consecutive predict failures — model %s "
                    "DEGRADED (%s)", tenant.consecutive_failures,
                    tenant.name,
                    "serving from fallback model"
                    if tenant.fallback is not None
                    else "no fallback: shedding new load")
                flight.record(
                    "serving_degraded", model=tenant.name,
                    consecutive_failures=tenant.consecutive_failures,
                    fallback=tenant.fallback is not None, error=str(e))
            if not use_fallback and tenant.fallback is not None:
                try:
                    out = tenant.fallback.predict(stacked)
                    use_fallback = True
                except Exception as e2:
                    log.error("inline fallback predict also failed: %s",
                              e2)
            if out is None:
                self._tenant_series(name, "failed", float(n))
                raise
        if use_fallback:
            self._count("fallback_batches")
        lat = time.time() - t0
        self._count("batches")
        self._count("requests", n)
        self._tenant_series(name, "requests", float(n))
        self._tenant_series(name, "latency", lat)
        return np.asarray(out)

    # -- client side --------------------------------------------------------
    def enqueue(self, arr: np.ndarray, request_id: Optional[str] = None,
                deadline_s: Optional[float] = None,
                model: Optional[str] = None) -> str:
        """Admit one request for ``model`` (default tenant when None).
        Never blocks beyond ``config.enqueue_block_s``: a full queue, a
        draining/stopped server, or tenant degradation without fallback
        all raise :class:`ServiceUnavailableError` at admission (counted
        as ``shed_requests``).  ``deadline_s`` is relative to now; it
        defaults to ``config.default_deadline_s`` (None = no expiry)."""
        cfg = self.config
        if self._draining or self._stop.is_set():
            self._count("shed_requests")
            raise ServiceUnavailableError(
                "server is draining/stopped; retry against another replica",
                retry_after=cfg.retry_after_s)
        name = model or self._default_name
        tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._tenants)}")
        if tenant.degraded and tenant.fallback is None:
            # half-open: admit one probe per interval so a recovered
            # model can clear degradation; shed everything else —
            # admission-time fast-fail beats letting the request rot in
            # the queue until the client timeout
            with self._probe_lock:  # check-then-set: exactly ONE probe
                #                     per interval across client threads
                now = time.time()
                is_probe = (now - tenant.last_probe_t
                            >= cfg.degraded_probe_interval_s)
                if is_probe:
                    tenant.last_probe_t = now
                else:
                    self._count("shed_requests")
            if not is_probe:
                raise ServiceUnavailableError(
                    f"model {name} degraded (predict failing) and no "
                    "fallback; shedding load — retry against another "
                    "replica", retry_after=cfg.retry_after_s)
        rid = request_id or uuid.uuid4().hex
        now = time.time()
        if deadline_s is None:
            deadline_s = cfg.default_deadline_s
        deadline_t = now + deadline_s if deadline_s is not None else math.inf
        req = _Request(rid, np.asarray(arr), now, deadline_t, model=name)
        with self._result_cv:
            if rid in self._pending:
                # still in flight: two waiters must not race one result
                # slot — retryable conflict (HTTP 409 upstream); resolves
                # as soon as the first attempt publishes
                raise ValueError(
                    f"request id {rid!r} is already in flight; "
                    "request ids must be unique per outstanding request")
            # completed but never fetched (first waiter gone, or an id
            # deliberately reused with a NEW payload): discard the stale
            # verdict and recompute — adopting it would silently answer
            # the new payload with the old prediction
            self._results.pop(rid, None)
            self._result_expiry.pop(rid, None)
            self._pending.add(rid)
        with trace.span("serving/enqueue", request_id=rid, model=name):
            admitted = self._admit(tenant, req)
        if not admitted:
            with self._result_cv:
                self._pending.discard(rid)
            self._count("shed_requests")
            raise ServiceUnavailableError(
                f"request queue full ({cfg.queue_capacity}); shedding load "
                "— retry after backoff", retry_after=cfg.retry_after_s)
        if self._stop.is_set():
            # raced stop(): the engine may already be gone and _fail_queued
            # past — sweep again so THIS request still gets an explicit
            # verdict (either the engine processed it or it is now failed)
            self._fail_queued()
        return rid

    def _admit(self, tenant: _Tenant, req: _Request) -> bool:
        """Push into the tenant heap, bounded by ``queue_capacity``; waits
        at most ``enqueue_block_s`` for room (0 = immediate verdict).
        The push notifies the assembler — THE event-driven wakeup."""
        cfg = self.config
        t_end = time.time() + cfg.enqueue_block_s
        with self._work_cv:
            while len(tenant.heap) >= cfg.queue_capacity:
                remaining = t_end - time.time()
                if remaining <= 0 or self._stop.is_set() or self._draining:
                    return False
                self._work_cv.wait(remaining)
            req.seq = self._seq_n = self._seq_n + 1
            heapq.heappush(tenant.heap, (req.deadline_t, req.seq, req))
            self._work_cv.notify_all()
        return True

    def enqueue_generate(self, tokens=None, request_id: Optional[str] = None,
                         deadline_s: Optional[float] = None,
                         model: Optional[str] = None,
                         max_new_tokens: Optional[int] = None,
                         temperature: float = 0.0, top_k: int = 0,
                         top_p: float = 1.0, seed: int = 0,
                         on_token=None, handoff: Optional[dict] = None
                         ) -> str:
        """Admit one GENERATE request for ``model``'s continuous decode
        engine (docs/serving.md §Autoregressive decode).  Admission
        mirrors :meth:`enqueue` — draining/degraded/duplicate-id checks,
        deadline stamped here — but the request then lives in the decode
        engine's slot scheduler, not the predict batch heaps: tokens
        stream via ``on_token`` (engine thread) and the final token
        array lands in the result table for :meth:`query`.  Per-token
        deadline enforcement is the engine's: an expired streaming
        request frees its slot immediately and resolves as
        :class:`DeadlineExceededError` (counted under
        ``serving.tenant.<name>.expired``).

        ``handoff`` (docs/serving.md §Decode fleet) is an unpacked KV
        handoff from a ``role="prefill"`` worker: tokens and sampling
        params come from it (the decode must resume under exactly the
        sampling the prefill worker selected the first token with),
        prefill is skipped entirely — the engine imports the shipped
        pages and resumes decode byte-identically to having prefilled
        locally."""
        import math as _math

        from bigdl_tpu_torch.serving.decode_engine import DecodeRequest

        cfg = self.config
        if handoff is not None:
            tokens = handoff["tokens"]
            temperature = handoff.get("temperature", temperature)
            top_k = handoff.get("top_k", top_k)
            top_p = handoff.get("top_p", top_p)
            seed = handoff.get("seed", seed)
        elif tokens is None:
            raise ValueError("enqueue_generate needs tokens (or a handoff)")
        if self._draining or self._stop.is_set():
            self._count("shed_requests")
            raise ServiceUnavailableError(
                "server is draining/stopped; retry against another replica",
                retry_after=cfg.retry_after_s)
        name = model or self._default_name
        tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._tenants)}")
        engine = getattr(tenant.model, "decode_engine", None)
        if engine is None and hasattr(tenant.model, "_engine"):
            # Seq2SeqService builds its engine lazily on first use — a
            # freshly registered tenant must still serve generates
            engine = tenant.model._engine()
        if engine is None:
            raise TypeError(
                f"model {name!r} has no decode engine; serve it from an "
                "InferenceModel(decode=DecodeConfig(...)) or a "
                "Seq2SeqService")
        if tenant.degraded and tenant.fallback is None:
            self._count("shed_requests")
            raise ServiceUnavailableError(
                f"model {name} degraded; shedding generate load",
                retry_after=cfg.retry_after_s)
        rid = request_id or uuid.uuid4().hex
        now = time.time()
        if deadline_s is None:
            deadline_s = cfg.default_deadline_s
        deadline_t = now + deadline_s if deadline_s is not None \
            else _math.inf
        with self._result_cv:
            if rid in self._pending:
                raise ValueError(
                    f"request id {rid!r} is already in flight; "
                    "request ids must be unique per outstanding request")
            self._results.pop(rid, None)
            self._result_expiry.pop(rid, None)
            self._pending.add(rid)
            self._generate_pending.add(rid)

        def _done(req: DecodeRequest) -> None:
            done_t = time.time()
            if req.error is not None:
                if isinstance(req.error, DeadlineExceededError):
                    self._count("expired_requests")
                    self._tenant_series(name, "expired")
                    flight.record("serving_deadline_drop", count=1,
                                  request_ids=[rid], decode=True)
                verdict: Any = req.error
            else:
                verdict = req.result.tokens
                lat = done_t - req.admit_t
                self.metrics.observe("serving.latency_s", lat)
                self._tenant_series(name, "latency", lat)
                if req.result.ttft_s >= 0:
                    # the decode tail the ttft_p* SLO objectives read
                    self._tenant_series(name, "ttft", req.result.ttft_s)
                self._count("requests")
                self._tenant_series(name, "requests")
            ttl = done_t + cfg.result_ttl_s
            with self._result_cv:
                self._results[rid] = verdict
                self._result_expiry[rid] = ttl
                self._pending.discard(rid)
                self._generate_pending.discard(rid)
                self._result_cv.notify_all()

        req = DecodeRequest(
            tokens=np.asarray(tokens, np.int32), rid=rid, tenant=name,
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, seed=seed, deadline_t=deadline_t,
            on_token=on_token, on_done=_done, handoff=handoff)
        with trace.span("serving/enqueue_generate", request_id=rid,
                        model=name):
            try:
                engine.submit(req)
            except RuntimeError as e:
                with self._result_cv:
                    self._pending.discard(rid)
                    self._generate_pending.discard(rid)
                self._count("shed_requests")
                raise ServiceUnavailableError(
                    f"decode queue full: {e}",
                    retry_after=cfg.retry_after_s)
            except Exception:
                # submit-time rejection (e.g. prompt over the cache
                # cap): the id must not stay poisoned in _pending
                with self._result_cv:
                    self._pending.discard(rid)
                    self._generate_pending.discard(rid)
                raise
        return rid

    def prefill_handoff(self, tokens, request_id: Optional[str] = None,
                        model: Optional[str] = None,
                        temperature: float = 0.0, top_k: int = 0,
                        top_p: float = 1.0, seed: int = 0,
                        timeout: float = 30.0) -> dict:
        """Run the prefill half of a split generate request and return
        the KV handoff dict (docs/serving.md §Decode fleet) — what a
        ``role="prefill"`` worker serves at ``POST /fleet/prefill``.

        Synchronous by design: the engine selects the first token during
        the final prefill chunk (one decode step of work), so the caller
        gets tokens + first token + the float32 page images in one call
        and ships them to a decode worker via
        :func:`~bigdl_tpu_torch.serving.fleet.handoff.pack_handoff`.  The
        request never enters the result table — the decode worker owns
        the client-visible request id."""
        from bigdl_tpu_torch.serving.decode_engine import DecodeRequest

        cfg = self.config
        if self._draining or self._stop.is_set():
            self._count("shed_requests")
            raise ServiceUnavailableError(
                "server is draining/stopped; retry against another replica",
                retry_after=cfg.retry_after_s)
        name = model or self._default_name
        tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError(
                f"unknown model {name!r}; registered: "
                f"{sorted(self._tenants)}")
        engine = getattr(tenant.model, "decode_engine", None)
        if engine is None and hasattr(tenant.model, "_engine"):
            engine = tenant.model._engine()
        if engine is None:
            raise TypeError(
                f"model {name!r} has no decode engine; cannot prefill")
        req = DecodeRequest(
            tokens=np.asarray(tokens, np.int32),
            rid=request_id or uuid.uuid4().hex, tenant=name,
            max_new_tokens=1, temperature=temperature, top_k=top_k,
            top_p=top_p, seed=seed, export_kv=True)
        with trace.span("serving/prefill_handoff", request_id=req.rid,
                        model=name):
            try:
                engine.submit(req)
            except RuntimeError as e:
                self._count("shed_requests")
                raise ServiceUnavailableError(
                    f"decode queue full: {e}", retry_after=cfg.retry_after_s)
            req.wait(timeout)
        if req.error is not None:
            raise req.error
        if req.kv_export is None:  # pragma: no cover - engine bug guard
            raise RuntimeError("prefill finished without a KV export")
        return req.kv_export

    # -- fleet fault tolerance (docs/serving.md §Fleet fault tolerance) ------
    def _engine_for(self, model: Optional[str] = None):
        """The decode engine serving ``model`` (default tenant when
        None), or None when the tenant has no engine built."""
        tenant = self._tenants.get(model or self._default_name)
        if tenant is None:
            return None
        engine = getattr(tenant.model, "decode_engine", None)
        if engine is None and hasattr(tenant.model, "_engine"):
            engine = tenant.model._engine()
        return engine

    def decode_config(self, model: Optional[str] = None):
        """The decode engine's config (cap, max_new_tokens, eos_id) —
        what the frontend's resume_from math needs to reproduce the
        original run's effective token budget."""
        engine = self._engine_for(model)
        return None if engine is None else engine.cfg

    def cancel_generate(self, request_id: str,
                        reason: str = "cancelled") -> None:
        """Cancel an in-flight generate on every tenant engine that
        might hold it — the client went away (broken pipe on the
        stream) or the slot migrated.  Unknown ids are a no-op."""
        for t in list(self._tenants.values()):
            engine = getattr(t.model, "decode_engine", None)
            if engine is not None and hasattr(engine, "cancel"):
                engine.cancel(request_id, reason)

    _PARKED_MAX = 32
    _PARKED_TTL_S = 120.0

    def park_handoff(self, handoff: dict) -> str:
        """Hold a migrated-in KV handoff until the proxy re-places its
        stream here (``POST /fleet/import`` body).  Returns the parked
        request id."""
        rid = str(handoff.get("request_id") or uuid.uuid4().hex)
        now = time.time()
        with self._parked_lock:
            stale = [r for r, (t, _) in self._parked.items()
                     if now - t > self._PARKED_TTL_S]
            for r in stale:
                del self._parked[r]
            while len(self._parked) >= self._PARKED_MAX:
                oldest = min(self._parked, key=lambda r: self._parked[r][0])
                del self._parked[oldest]
            self._parked[rid] = (now, handoff)
        self.metrics.inc("serving.fleet.parked_handoffs")
        return rid

    def take_parked(self, request_id: str) -> Optional[dict]:
        """Pop a parked migration handoff for adoption (returns None
        when absent or expired — the resume falls back to re-prefill)."""
        with self._parked_lock:
            item = self._parked.pop(request_id, None)
        if item is None:
            return None
        t, handoff = item
        if time.time() - t > self._PARKED_TTL_S:
            return None
        return handoff

    def drain_decode(self, peers: List[str],
                     model: Optional[str] = None,
                     timeout: float = 10.0,
                     evict: bool = True) -> Dict[str, Any]:
        """Live-drain this worker's decode state (docs/serving.md
        §Fleet fault tolerance): freeze-and-export every migratable
        slot, ship each as a BDLFKV1 blob to a peer's ``/fleet/import``
        (round-robin over ``peers``), then evict the frozen slots so
        their streams abort and the pool proxy fails them over — onto
        the peer that parked the state, which adopts it instead of
        re-prefilling.  A failed ship (or a ``fleet_handoff_corrupt``
        injection) degrades to the re-prefill failover path: the
        request is never dropped, it just pays a re-prefill.

        With ``evict=False`` the frozen slots are left in place and
        their rids returned under ``"frozen"`` — the pool uses the
        two-phase form (ship, record the migration map, THEN evict) so
        its failover path already knows the adopting peer when the
        victim's streams abort."""
        import urllib.request

        from bigdl_tpu_torch.serving.fleet.handoff import pack_handoff

        engine = self._engine_for(model)
        if engine is None or not hasattr(engine, "migrate_live_slots"):
            return {"migrated": {}, "failed": [], "frozen": []}
        exports, frozen, leftover = engine.migrate_live_slots()
        migrated: Dict[str, str] = {}
        failed: List[str] = list(leftover)
        for i, h in enumerate(exports):
            rid = str(h["request_id"])
            blob = pack_handoff(h)
            try:
                # chaos seam: a corrupted migration blob — the peer's
                # hardened unpack rejects it and the stream recovers
                # through re-prefill failover instead
                faults.fire("fleet_handoff_corrupt")
            except faults.HandoffCorruptFault:
                blob = b"XXXXXXXX" + blob[8:]
            shipped = None
            for j in range(len(peers)):
                peer = peers[(i + j) % len(peers)]
                try:
                    req = urllib.request.Request(
                        peer.rstrip("/") + "/fleet/import", data=blob,
                        headers={"Content-Type":
                                 "application/octet-stream"})
                    with urllib.request.urlopen(
                            req, timeout=timeout) as resp:
                        if resp.status == 200:
                            shipped = peer
                            break
                except Exception as e:  # noqa: BLE001 — degrade, never drop
                    log.warning("KV migration of %s to %s failed: %s",
                                rid, peer, e)
            if shipped is None:
                failed.append(rid)
            else:
                migrated[rid] = shipped
        if evict:
            for rid in frozen:
                engine.cancel(rid, "migrated")
        for rid in leftover:
            engine.cancel(rid, "migrated")
        self.metrics.inc("serving.fleet.migrations", len(migrated))
        flight.record("fleet_drain", migrated=len(migrated),
                      failed=len(failed),
                      request_ids=sorted(migrated))
        return {"migrated": migrated, "failed": failed,
                "frozen": [] if evict else frozen}

    def evict_migrated(self, request_ids: List[str]) -> None:
        """Phase two of a two-phase drain: evict the frozen slots whose
        state already shipped (their streams abort and fail over)."""
        for t in list(self._tenants.values()):
            engine = getattr(t.model, "decode_engine", None)
            if engine is not None and hasattr(engine, "cancel"):
                for rid in request_ids:
                    engine.cancel(rid, "migrated")

    def query(self, request_id: str, timeout: float = 30.0) -> np.ndarray:
        deadline = time.time() + timeout
        with self._result_cv:
            while request_id not in self._results:
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"result {request_id} not ready")
                self._result_cv.wait(remaining)
            res = self._results.pop(request_id)
            self._result_expiry.pop(request_id, None)
        if isinstance(res, Exception):
            raise res
        return res

    # -- engine: continuous batching ----------------------------------------
    def _pick_tenant(self, now: float) -> Optional[_Tenant]:
        """Weighted, deadline-aware admission (caller holds ``_work_cv``):
        a tenant whose head request is about to expire jumps the weighted
        rotation (earliest deadline first); otherwise stride scheduling —
        lowest pass value — shares the engine by weight."""
        ts = [t for t in self._tenants.values() if t.heap]
        if not ts:
            return None
        horizon = now + self.config.batch_timeout_s \
            + 2 * self._predict_ema_s
        urgent = [t for t in ts if t.heap[0][0] <= horizon]
        if urgent:
            return min(urgent, key=lambda t: t.heap[0][0])
        return min(ts, key=lambda t: (t.pass_value, t.name))

    def _assemble_run(self) -> None:
        """Assembler half of the engine: builds the NEXT batch while the
        predict thread runs the current one, handing off through the
        single-slot buffer.  Exactly one batch ahead: more buffering would
        defeat deadline ordering and inflate effective queue depth."""
        cv = self._work_cv
        while True:
            with cv:
                while not self._stop.is_set() and (
                        self._slot is not None
                        or not any(t.heap
                                   for t in self._tenants.values())):
                    cv.wait()
                if self._stop.is_set():
                    return
                tenant = self._pick_tenant(time.time())
                batch = self._fill_batch(tenant)
                self._assembling_n = 0
                if batch is None:   # stopped mid-fill; requests back home
                    return
                tenant.pass_value += len(batch) / tenant.weight
                self._slot = batch
                cv.notify_all()

    def _fill_batch(self, tenant: _Tenant) -> Optional[List[_Request]]:
        """Build one batch from ``tenant``'s heap (caller holds
        ``_work_cv``; waits release it).  Pops in deadline order; caps at
        ``batch_size`` requests and the model's largest bucket in rows so
        one batch maps onto one compiled program.  While predict is busy
        it keeps accumulating — assembly hides under predict — and once
        predict is waiting it holds the ``batch_timeout_s`` window open
        for stragglers, cut short when a batched deadline would not
        survive the wait."""
        cfg = self.config
        cv = self._work_cv
        rows_cap = tenant.rows_cap(cfg)
        batch: List[_Request] = []
        rows = 0
        t_first = time.time()
        while True:
            if self._stop.is_set():
                # push the partial batch back for _fail_queued's sweep
                for req in batch:
                    heapq.heappush(tenant.heap,
                                   (req.deadline_t, req.seq, req))
                return None
            popped = False
            while tenant.heap and len(batch) < cfg.batch_size:
                r = tenant.heap[0][2].rows
                if batch and rows_cap is not None and rows + r > rows_cap:
                    break
                _, _, req = heapq.heappop(tenant.heap)
                batch.append(req)
                rows += r
                popped = True
            if popped:
                self._assembling_n = len(batch)
                cv.notify_all()   # queue room for bounded-enqueue waiters
            if len(batch) >= cfg.batch_size:
                return batch
            if (tenant.heap and rows_cap is not None
                    and rows + tenant.heap[0][2].rows > rows_cap):
                return batch      # row bucket full
            now = time.time()
            if not self._predict_waiting:
                # predict is busy: keep the window open and accumulate;
                # woken by enqueue or by predict going idle
                cv.wait(0.05)
                continue
            remaining = cfg.batch_timeout_s - (now - t_first)
            if remaining <= 0:
                return batch
            urgent_t = min(r.deadline_t for r in batch)
            if urgent_t <= now + remaining:
                return batch      # near-expiry request jumps the window
            cv.wait(remaining)

    def _predict_run(self) -> None:
        """Predict half of the engine: takes batches from the handoff
        slot, expires what died in queue, runs predict, publishes.  Idle
        waits double as the result-table GC tick."""
        cv = self._work_cv
        while True:
            batch = None
            with cv:
                if self._stop.is_set():
                    return
                if self._slot is None:
                    self._predict_waiting = True
                    cv.notify_all()   # assembler: window may close now
                    cv.wait(self.config.result_gc_interval_s)
                if self._slot is not None:
                    batch = self._slot
                    self._slot = None
                    self._predict_waiting = False
                    self._busy = True   # set under the lock: drain's
                    #                     work-pending probe must never
                    #                     catch the gap between slot and
                    #                     busy
                    cv.notify_all()
            self._gc_results()
            if batch is None:
                continue
            try:
                batch = self._expire(batch)
                if batch:
                    self._process_guarded(batch)
            finally:
                self._busy = False

    # -- engine: legacy fixed-window loop (parity reference) -----------------
    def _run_fixed(self) -> None:
        """The pre-continuous engine: fill a window, then block on predict
        before touching the queue again.  Kept behind
        ``ServingConfig(continuous=False)`` as the batching-parity and
        perf A/B reference."""
        cfg = self.config
        cv = self._work_cv
        while not self._stop.is_set():
            self._gc_results()
            with cv:
                tenant = self._pick_tenant(time.time())
                if tenant is None:
                    cv.wait(0.05)
                    tenant = self._pick_tenant(time.time())
                    if tenant is None:
                        continue
                _, _, first = heapq.heappop(tenant.heap)
                batch = [first]
                cv.notify_all()
            t0 = time.time()
            while (len(batch) < cfg.batch_size
                   and time.time() - t0 < cfg.batch_timeout_s):
                with cv:
                    if tenant.heap:
                        batch.append(heapq.heappop(tenant.heap)[2])
                        cv.notify_all()
                        continue
                time.sleep(0.0005)
            batch = self._expire(batch)
            if not batch:
                continue
            self._busy = True
            try:
                self._process_guarded(batch)
            finally:
                self._busy = False

    def _process_guarded(self, batch: List[_Request]) -> None:
        try:
            self._process(batch)
        except Exception as e:  # noqa: BLE001 — engine must outlive
            # any single batch: a concatenate error (shape-mismatched
            # co-batched requests) or a raise-mode injected fault
            # outside _process's own predict handler would otherwise
            # kill the engine thread and zombify the server
            log.error("serving batch failed outside predict: %s", e)
            self._count("failed_batches")
            self._tenant_series(batch[0].model, "failed", len(batch))
            self._publish([r.rid for r in batch],
                          [1] * len(batch), None, error=e)

    def _gc_results(self) -> None:
        """TTL sweep over the result table: a client that abandoned its
        ``query`` (timeout, disconnect) must not leak its entry forever.
        The SLO evaluator piggybacks on the same engine-thread tick (its
        own rate limit inside) — no extra thread, and burn rates stay
        fresh exactly as long as the engine is alive."""
        if self.slo is not None:
            try:
                self.slo.maybe_evaluate()
            except Exception as e:  # noqa: BLE001 — never stall serving
                log.warning("SLO evaluation failed: %s", e)
        now = time.time()
        if now - self._last_gc_t < self.config.result_gc_interval_s:
            return
        self._last_gc_t = now
        with self._result_cv:
            stale = [rid for rid, t in self._result_expiry.items()
                     if t <= now]
            for rid in stale:
                self._results.pop(rid, None)
                self._result_expiry.pop(rid, None)
        if stale:
            self._count("results_gc", len(stale))
            log.info("serving: GC'd %d abandoned results", len(stale))

    def _expire(self, batch) -> list:
        """Drop requests whose deadline passed while queued — BEFORE
        predict, so expired work never reaches the card.  Each gets an
        explicit DeadlineExceededError result."""
        now = time.time()
        live, expired = [], []
        for req in batch:
            (expired if req.deadline_t <= now else live).append(req)
        if expired:
            ttl = now + self.config.result_ttl_s
            with self._result_cv:
                for req in expired:
                    self._results[req.rid] = DeadlineExceededError(
                        req.rid, now - req.admit_t)
                    self._result_expiry[req.rid] = ttl
                    self._pending.discard(req.rid)
                self._result_cv.notify_all()
            self._count("expired_requests", len(expired))
            # batches are single-tenant (_fill_batch pops one heap), so
            # one inc attributes the whole drop — the per-tenant SLO
            # surface must say WHOSE deadlines are expiring
            self._tenant_series(expired[0].model, "expired", len(expired))
            flight.record("serving_deadline_drop", count=len(expired),
                          request_ids=[r.rid for r in expired])
        return live

    def _process(self, batch) -> None:
        # attrs (the O(batch) rid join, specifically) are built only when
        # a tracer is installed — tracing off must stay a None check
        tenant = self._tenants[batch[0].model]
        tr = trace.active()
        if tr is None:
            return self._process_traced(batch, tenant, None)
        with tr.span("serving/batch", batch_size=len(batch),
                     model=tenant.name,
                     request_ids=",".join(r.rid for r in batch)):
            self._process_traced(batch, tenant, tr)

    def _process_traced(self, batch, tenant: _Tenant, tr) -> None:
        cfg = self.config
        rids = [r.rid for r in batch]
        sizes = [r.rows for r in batch]
        arrs = [r.arr if r.arr.ndim > 1 else r.arr[None] for r in batch]
        stacked = np.concatenate(arrs, axis=0)
        t_predict = time.time()
        for r in batch:
            # admission→predict-start wait: the tail's wait-vs-predict
            # decomposition (mirrors the train-side attribution model)
            wait = t_predict - r.admit_t
            self.metrics.observe("serving.queue_wait_s", wait)
            self._tenant_series(tenant.name, "queue_wait", wait)
        # chaos seams (docs/serving.md): a slow batch delays the loop so
        # queued requests expire; a worker kill takes the process down
        # mid-request (the pool's breaker/supervisor must absorb it)
        faults.fire("serving_slow_batch")
        faults.fire("serving_worker_kill")
        use_fallback = tenant.degraded and tenant.fallback is not None
        primary = tenant.fallback if use_fallback else tenant.model
        out = None
        try:
            pred_span = trace.NULL_SPAN if tr is None else tr.span(
                "serving/predict", batch_size=len(batch),
                model=tenant.name, request_ids=",".join(rids))
            with pred_span, Timer(self.metrics, "serving.predict_s"):
                faults.fire("serving_predict_fail")
                out = primary.predict(stacked)
            tenant.consecutive_failures = 0
            if not use_fallback and tenant.degraded:
                log.info("serving: predict recovered; %s leaving degraded "
                         "mode", tenant.name)
                tenant.degraded = False
                flight.record("serving_recovered", via="predict_success",
                              model=tenant.name)
        except Exception as e:
            tenant.consecutive_failures += 1
            self._count("failed_batches")
            if (not tenant.degraded and tenant.consecutive_failures
                    >= cfg.degraded_after_failures):
                tenant.degraded = True
                log.error(
                    "serving: %d consecutive predict failures — model %s "
                    "DEGRADED (%s)", tenant.consecutive_failures,
                    tenant.name,
                    "serving from fallback model"
                    if tenant.fallback is not None
                    else "no fallback: shedding new load")
                flight.record(
                    "serving_degraded", model=tenant.name,
                    consecutive_failures=tenant.consecutive_failures,
                    fallback=tenant.fallback is not None,
                    error=str(e))
            if not use_fallback and tenant.fallback is not None:
                # last-good model answers THIS batch too, not just the
                # post-degradation ones — a waiter should not pay for the
                # primary's death with an error when a fallback exists
                try:
                    out = tenant.fallback.predict(stacked)
                    use_fallback = True
                except Exception as e2:
                    log.error("fallback predict also failed: %s", e2)
            if out is None:
                log.error("predict failed: %s", e)
                # the availability half of the tenant's SLO: failed
                # requests count against the error budget
                self._tenant_series(tenant.name, "failed", len(batch))
                self._publish(rids, sizes, None, error=e)
                return
        if use_fallback:
            self._count("fallback_batches")
        self._publish(rids, sizes, out)
        now = time.time()
        # EMA of predict wall time: the assembler's deadline-urgency
        # horizon (how long a queued request is likely to wait)
        self._predict_ema_s = (0.8 * self._predict_ema_s
                               + 0.2 * (now - t_predict))
        for r in batch:
            # admission→publish latency; the p50/p95/p99 surface /metrics
            # exports as a Prometheus histogram — per tenant too, so one
            # scrape shows every model's SLO
            lat = now - r.admit_t
            self.metrics.observe("serving.latency_s", lat)
            self._tenant_series(tenant.name, "latency", lat)
        self._count("batches")
        self._count("requests", len(batch))
        self._tenant_series(tenant.name, "requests", len(batch))
        with self._stats_lock:
            occ = (self.stats["requests"] / self.stats["batches"]
                   / max(cfg.batch_size, 1))
        self.metrics.gauge("serving.batch_occupancy", occ)
        self.metrics.gauge("serving.queue_depth", self._in.qsize())
        self.metrics.gauge("serving.backlog", self.backlog())
        self._tenant_series(tenant.name, "queue_depth", len(tenant.heap))

    def _publish(self, rids, sizes, out, error: Optional[Exception] = None
                 ) -> None:
        ttl = time.time() + self.config.result_ttl_s
        ofs = 0
        tr = trace.active()
        pub_span = trace.NULL_SPAN if tr is None else tr.span(
            "serving/publish", request_ids=",".join(rids),
            error=error is not None)
        with pub_span, self._result_cv:
            for rid, n in zip(rids, sizes):
                if error is not None:
                    self._results[rid] = error
                else:
                    self._results[rid] = out[ofs:ofs + n]
                    ofs += n
                self._result_expiry[rid] = ttl
                self._pending.discard(rid)
            self._result_cv.notify_all()
