"""Multi-worker serving scale-out — process-isolated engine replicas.

The port of ``bigdl_tpu.serving.pool``: the same names, wire
formats and semantics.

    pool = ServingPool("my_pkg.my_mod:make_model", workers=2).start()
    # pool.url -> proxy endpoint: POST /predict, GET /health
    pool.stop()

``loader`` is a ``module:function`` spec resolving to a zero-arg callable
returning an :class:`~bigdl_tpu_torch.serving.inference_model.InferenceModel` —
or a ``{name: model}`` dict for multi-tenant workers — imported in each
worker's own interpreter (the model never crosses the process boundary,
exactly the reference's model-per-task-manager posture).

Routing hardening (docs/serving.md): each worker sits behind a per-worker
CIRCUIT BREAKER — consecutive connection-level failures open it, an open
breaker is skipped without burning a connect timeout per request, and
after a cooldown a single half-open probe decides whether it closes.
Worker-side backpressure (429/503) routes to the next worker instead of
bouncing the client.  ``hedge_after_s`` optionally duplicates an
idempotent predict onto a second worker when the first is slow (bounded:
one hedge, first answer wins).  ``stop()`` drains workers before killing
them — each worker finishes its queued requests within the drain budget.
Forwards ride per-worker KEEP-ALIVE connections (``conn_reuse`` counts
the hits) instead of paying a TCP handshake per request.

Autoscaling (docs/serving.md §Autoscaling): with ``max_workers`` above
``min_workers``, a metrics thread watches the signals the workers already
export on ``/health`` — queue depth and the latency histogram — and
grows/shrinks the pool between the bounds — asymmetric on purpose: one
over-threshold pressure tick spawns a worker (queued users are waiting;
the cooldown rate-limits repeats), while shrinking demands sustained
idle (never while a breaker is open, always drain-before-kill, never
below ``min_workers``).
"""

import http.client
import json
import logging
import os
import subprocess
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.obs import flight, trace
from bigdl_tpu_torch.obs.export import CONTENT_TYPE, federate, render_prometheus
from bigdl_tpu_torch.optim.metrics import global_metrics
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.serving.http_frontend import REQUEST_ID_RE
from bigdl_tpu_torch.serving.json_http import reply_json

log = logging.getLogger("bigdl_tpu_torch.serving.pool")

# pool stats that ALSO publish under the fleet's canonical metric names
# (docs/observability.md): the proxy is the only process that can count
# failovers/orphans — the dying worker can't — so its registry carries
# the serving.fleet.* series the chaos gate asserts on
_FLEET_GLOBAL = {"fleet_failovers": "serving.fleet.failovers",
                 "fleet_migrations": "serving.fleet.migrations",
                 "fleet_resumed_tokens": "serving.fleet.resumed_tokens",
                 "fleet_orphans": "serving.fleet.orphaned_requests"}


def _worker_main(loader: str, batch_size: int, queue_capacity: int,
                 drain_timeout_s: float = 5.0, role: str = "both") -> None:
    """Entry point inside a worker subprocess.  ``BIGDL_TPU_POOL_CPU``
    hides the card from it (``CUDA_VISIBLE_DEVICES=""``, set before CUDA
    initializes): its loader must then build with ``device="cpu"``, and
    one that defaults to the card raises instead of landing on the CPU."""
    import importlib

    if os.environ.get("BIGDL_TPU_POOL_CPU"):
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
    # same rationale as the proxy (see ServingPool.start): the handler
    # threads stream per-token chunks and must not queue a GIL switch
    # interval behind the engine thread for every token they write
    sys.setswitchinterval(0.001)
    mod_name, _, fn_name = loader.partition(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)

    from bigdl_tpu_torch.serving.http_frontend import HttpFrontend
    from bigdl_tpu_torch.serving.server import ServingConfig, ServingServer

    cfg = ServingConfig(batch_size=batch_size, queue_capacity=queue_capacity)
    loaded = fn()
    if isinstance(loaded, dict):
        # multi-tenant worker: every model in the registry shares this
        # process's engine under weighted admission
        srv = ServingServer(models=loaded, config=cfg).start()
    else:
        srv = ServingServer(loaded, cfg).start()
    srv.role = role  # fleet role, reported via /health for the router
    hedge = os.environ.get("BIGDL_TPU_PREFILL_HEDGE_S")
    fe = HttpFrontend(srv, port=0,
                      prefill_hedge_s=float(hedge) if hedge else None
                      ).start()
    print(f"WORKER_URL={fe.url}", flush=True)
    sys.stdin.readline()           # parent closes stdin to stop us
    # drain-before-kill: finish queued requests (new ones are shed with
    # 429 by the draining server) before the frontend socket goes away
    srv.stop(drain=True, timeout=drain_timeout_s)
    fe.stop()


class _Breaker:
    """Per-worker circuit breaker over CONNECTION-level failures.

    closed -> (fail_threshold consecutive failures) -> open ->
    (cooldown_s elapses) -> half-open: exactly one probe request is
    admitted; its success closes the breaker, its failure re-opens.
    Application-level errors (worker answered 4xx/5xx) count as success —
    the worker is alive and routable.

    ``try_acquire`` (mutating — reserves the half-open probe slot) is
    called only at the moment a request is actually about to be sent;
    candidate listing must stay side-effect-free, otherwise a worker
    listed-but-never-contacted would burn its probe and wedge half-open
    forever with nothing ever feeding record_success/failure."""

    def __init__(self, fail_threshold: int = 3, cooldown_s: float = 2.0,
                 name: str = "worker", on_open=None):
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self.name = name
        self.state = "closed"
        self.failures = 0
        self.trips = 0
        self._opened_t = 0.0
        self._lock = threading.Lock()
        # fired (outside the lock) each time the breaker TRIPS open —
        # the pool wires this to invalidate_fleet_snapshot so the router
        # stops placing onto a worker the breaker just condemned, without
        # waiting out the snapshot TTL
        self._on_open = on_open

    def _transition(self, new: str, **data) -> None:
        """State change + its flight-recorder event (postmortems must show
        the breaker's trip/probe/close sequence around a worker death)."""
        if new != self.state:
            flight.record("breaker_" + new.replace("-", "_"),
                          breaker=self.name, **data)
        self.state = new

    def try_acquire(self) -> bool:
        """Admission for one real attempt (mutating).  Open past the
        cooldown flips to half-open and admits THIS caller as the probe;
        half-open admits nobody else until the probe reports back."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if time.time() - self._opened_t >= self.cooldown_s:
                    self._transition("half-open")
                    return True
                return False
            return False  # half-open: a probe is already in flight

    def record_success(self) -> None:
        with self._lock:
            self.failures = 0
            self._transition("closed")

    def record_failure(self) -> None:
        opened = False
        with self._lock:
            self.failures += 1
            if (self.state == "half-open"
                    or self.failures >= self.fail_threshold):
                if self.state != "open":
                    self.trips += 1
                    opened = True
                self._transition("open", failures=self.failures,
                                 trips=self.trips)
                self._opened_t = time.time()
        if opened and self._on_open is not None:
            try:
                self._on_open()
            except Exception:  # noqa: BLE001 — a callback must not poison
                pass           # the breaker's own accounting

    def reset(self) -> None:
        with self._lock:
            self._transition("closed", via="respawn")
            self.failures = 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self.state, "failures": self.failures,
                    "trips": self.trips}


class _ConnPool:
    """Per-worker-url keep-alive HTTP connections (satellite of the
    continuous-batching PR: the proxy used to pay a fresh TCP handshake
    per forwarded request).  ``acquire`` hands back an idle connection
    when one exists (``reused=True`` — the caller counts the hit) or
    opens a fresh one; ``release`` parks it for the next forward, bounded
    per url so a burst cannot hoard sockets."""

    def __init__(self, timeout: float, depth: int = 16):
        self._timeout = timeout
        self._depth = depth
        self._idle: Dict[str, List[http.client.HTTPConnection]] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _host_port(url: str) -> Tuple[str, int]:
        host, _, port = url.split("//", 1)[1].partition(":")
        return host, int(port or 80)

    def acquire(self, url: str
                ) -> Tuple[http.client.HTTPConnection, bool]:
        with self._lock:
            stack = self._idle.get(url)
            if stack:
                return stack.pop(), True
        host, port = self._host_port(url)
        return http.client.HTTPConnection(host, port,
                                          timeout=self._timeout), False

    def release(self, url: str, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            stack = self._idle.setdefault(url, [])
            if len(stack) < self._depth:
                stack.append(conn)
                return
        conn.close()

    def request(self, url: str, method: str, path: str,
                body: Optional[bytes] = None,
                headers: Optional[dict] = None,
                on_reuse=None) -> Tuple[int, bytes, dict]:
        """One request over a pooled connection: acquire, send, read,
        park (or close when the peer said so).  A reused socket that
        turns out stale gets ONE fresh-connection retry.  ``on_reuse``
        fires when the answering attempt rode a parked socket (the
        proxy's ``conn_reuse`` stat).  The single implementation behind
        forwards and health probes — the retry/release protocol must not
        fork."""
        for attempt in (0, 1):
            conn, reused = self.acquire(url)
            try:
                conn.request(method, path, body=body, headers=headers or {})
                resp = conn.getresponse()
                data = resp.read()
            except Exception:
                conn.close()
                if reused and attempt == 0:
                    continue  # stale keep-alive socket: one fresh retry
                raise
            if resp.will_close:
                conn.close()
            else:
                self.release(url, conn)
            if reused and on_reuse is not None:
                on_reuse()
            return resp.status, data, dict(resp.headers)
        raise RuntimeError("unreachable")

    def clear(self, url: Optional[str] = None) -> None:
        """Drop idle connections (for one url, or all) — a respawned or
        removed worker's sockets must not linger."""
        with self._lock:
            if url is None:
                stacks = list(self._idle.values())
                self._idle.clear()
            else:
                stacks = [self._idle.pop(url, [])]
        for stack in stacks:
            for conn in stack:
                try:
                    conn.close()
                except Exception:  # noqa: BLE001 — already gone
                    pass


class _Worker:
    def __init__(self, loader: str, batch_size: int, queue_capacity: int,
                 env: Optional[dict] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 drain_timeout_s: float = 5.0,
                 name: str = "worker", role: str = "both",
                 on_breaker_open=None):
        self.loader = loader
        self.batch_size = batch_size
        self.queue_capacity = queue_capacity
        self.env = env
        self.drain_timeout_s = drain_timeout_s
        self.name = name
        # fleet role (docs/serving.md §Decode fleet): "both" | "prefill"
        # | "decode" — the proxy's FleetRouter places /generate by it
        self.role = role
        self.proc: Optional[subprocess.Popen] = None
        self.url: Optional[str] = None
        # seconds of the last spawn that reached WORKER_URL (the worker's
        # imports, its loader and its warmup)
        self.spawn_s: Optional[float] = None
        self.breaker = _Breaker(breaker_threshold, breaker_cooldown_s,
                                name=name, on_open=on_breaker_open)

    def spawn(self, timeout: float = 120.0) -> None:
        t0 = time.perf_counter()
        env = dict(os.environ, **(self.env or {}))
        if env.get("BIGDL_TPU_POOL_CPU"):
            env["CUDA_VISIBLE_DEVICES"] = ""
        self.url = None  # a corpse's url must never leak into routing/health
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "bigdl_tpu_torch.serving.pool",
             "--worker",
             "--loader", self.loader, "--batch-size",
             str(self.batch_size), "--queue-capacity",
             str(self.queue_capacity), "--drain-timeout",
             str(self.drain_timeout_s), "--role", self.role],
            env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True)
        # readline blocks with no deadline, so read on a helper thread: a
        # loader that hangs before printing must not stall spawn() (the
        # supervisor calls spawn inline — a hung respawn would freeze ALL
        # supervision)
        found: List[str] = []

        def read_url():
            while True:
                line = self.proc.stdout.readline()
                if not line:
                    return
                line = line.strip()
                if line.startswith("WORKER_URL="):
                    found.append(line[len("WORKER_URL="):])
                    return

        t = threading.Thread(target=read_url, daemon=True)
        t.start()
        t.join(timeout)
        if found:
            self.url = found[0]
            self.spawn_s = time.perf_counter() - t0
            self.breaker.reset()  # fresh process, fresh record
            return
        if not t.is_alive():
            # stdout closed without a URL: the worker is exiting
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
        rc = self.proc.poll()
        if rc is not None:
            raise RuntimeError(
                f"serving worker exited with code {rc} before it served "
                f"(its loader's error is on its stderr)")
        self.proc.kill()
        raise RuntimeError(
            f"serving worker failed to start within {timeout}s")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def routable(self) -> bool:
        """Listing-time check — deliberately breaker-blind (and so
        side-effect-free): the breaker gates at attempt time via
        ``try_acquire``, where a skip costs nothing."""
        return self.alive() and self.url is not None

    def request_stop(self) -> None:
        """Begin drain-before-kill: closing stdin asks the worker to
        finish its queued requests (bounded by its drain budget) and
        exit."""
        if self.proc is not None and self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except Exception:  # noqa: BLE001 — already half-dead
                self.proc.kill()

    def join_stop(self) -> None:
        """Wait out the drain budget; only a worker that overruns it is
        killed."""
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            self.proc.wait(timeout=self.drain_timeout_s + 10)
        except Exception:
            self.proc.kill()

    def stop(self) -> None:
        self.request_stop()
        self.join_stop()


class _ProxyHandler(BaseHTTPRequestHandler):
    server_version = "bigdl-tpu-serving-pool/1"
    protocol_version = "HTTP/1.1"  # clients keep-alive into the proxy too
    # the streaming relay re-frames many tiny chunks toward the client;
    # Nagle would hold each one for the previous chunk's ACK
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        log.debug(fmt, *args)

    def _forward(self, method: str, base: str, path: str,
                 body: Optional[bytes]):
        """One upstream request over the per-worker keep-alive pool.  A
        reused connection that fails before any response (the worker
        idle-closed it) is retried ONCE on a fresh connection — safe even
        for POST because predict is idempotent (the hedging premise)."""
        pool: "ServingPool" = self.server.pool
        headers = {"Content-Type": "application/json"}
        rid = getattr(self, "_rid", None)
        if rid is not None:
            # one id names the request across proxy, worker frontend, and
            # engine spans — retries and hedges reuse it, so a trace shows
            # every worker that saw this request
            headers["X-Request-Id"] = rid
        deadline = getattr(self, "_deadline_hdr", None)
        if deadline is not None:
            # the client's header-form deadline must reach the worker or
            # its request outlives itself in a backed-up queue
            headers["X-Deadline-S"] = deadline
        model = getattr(self, "_model_hdr", None)
        if model is not None:
            # header-form tenant routing: dropping it would silently
            # serve the default tenant's answer with a 200
            headers["X-Model"] = model
        prefill = getattr(self, "_prefill_hdr", None)
        if prefill is not None:
            # physical prefill/decode split: tells the decode worker
            # which prefill worker to ship the prompt to
            headers["X-Prefill-Url"] = prefill
        return pool.conns.request(
            base, method, path, body=body, headers=headers,
            on_reuse=lambda: pool._count("conn_reuse"))

    def _reply(self, code: int, body: bytes,
               headers: Optional[dict] = None):
        reply_json(self, code, body, headers)

    def _attempt(self, worker: "_Worker", body: bytes
                 ) -> Tuple[str, int, bytes]:
        """One forward to one worker, with breaker accounting.  Returns
        ('relay', code, body) for an answer that must go to the client,
        ('busy', ...) for worker-side backpressure (try the next worker),
        ('skip', ...) when the breaker refuses admission (open, or a
        probe already in flight), or raises on a connection-level failure
        (breaker already fed)."""
        if not worker.breaker.try_acquire():
            return ("skip", 0, b"")
        pool: "ServingPool" = self.server.pool
        try:
            code, out, _ = self._forward("POST", worker.url, self.path,
                                         body)
        except Exception:
            worker.breaker.record_failure()
            # a connection-level failure is fleet-placement news even
            # below the breaker threshold: the cached health snapshot may
            # still list this worker as the best decode target
            pool.invalidate_fleet_snapshot()
            raise
        # the worker is ALIVE and answered: its breaker stays closed.
        # 429/503 are backpressure/draining — route around, the next
        # worker may have queue room; other codes (400 bad payload /
        # 500 model error) relay as the worker's verdict
        worker.breaker.record_success()
        if code in (429, 503):
            return ("busy", code, out)
        return ("relay", code, out)

    def do_POST(self):
        pool: "ServingPool" = self.server.pool
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0:
                raise ValueError(length)  # read(-1) would buffer to EOF
        except ValueError:
            self.close_connection = True  # unread body poisons keep-alive
            return self._reply(400, b'{"error": "bad Content-Length"}')
        if length > pool.max_body_bytes:
            pool._count("rejected_oversize")
            self.close_connection = True
            return self._reply(413, json.dumps(
                {"error": f"request body {length} bytes exceeds limit "
                          f"{pool.max_body_bytes}"}).encode())
        body = self.rfile.read(length)
        # assign the correlation id AT THE EDGE (caller's wins — header,
        # else the documented "request_id" payload fallback): every
        # retry/hedge below forwards the same X-Request-Id, so the worker
        # spans of one request share one id end to end (and the worker's
        # header-wins precedence cannot discard a payload-supplied id)
        rid = self.headers.get("X-Request-Id")
        if rid is None and b'"request_id"' in body:
            # the substring probe keeps the common no-id case from paying
            # a full JSON decode of the instances array at the proxy
            try:
                payload = json.loads(body)
                if isinstance(payload, dict) \
                        and payload.get("request_id") is not None:
                    rid = str(payload["request_id"])
            except (ValueError, json.JSONDecodeError):
                pass  # malformed body: the worker's 400 is the verdict
        if rid is not None and not REQUEST_ID_RE.fullmatch(rid):
            # the id is echoed into a response header: same guard as the
            # worker frontend, enforced at the edge too
            return self._reply(400, json.dumps(
                {"error": "bad request id: must match "
                          "[A-Za-z0-9._:-]{1,128}"}).encode())
        self._rid = rid or uuid.uuid4().hex
        self._deadline_hdr = self.headers.get("X-Deadline-S")
        self._model_hdr = self.headers.get("X-Model")
        self._prefill_hdr = None
        rid_hdr = {"X-Request-Id": self._rid}
        if self.path == "/generate":
            # decode-fleet path (docs/serving.md §Decode fleet): KV-aware
            # placement instead of round-robin, prefill/decode split when
            # the topology has dedicated prefill workers, and streaming
            # relay — the rid was assigned above, so every retry below
            # shares one id end to end
            return self._generate_fleet(pool, body, rid_hdr)
        # breaker-aware routing, starting at the round-robin cursor: dead
        # or breaker-open workers are skipped without burning a connect
        # timeout; worker-side 429/503 routes to the next worker; the
        # supervisor respawns corpses independently
        with trace.span("serving/proxy_request", request_id=self._rid):
            last_err: Optional[BaseException] = None
            busy: Optional[Tuple[int, bytes]] = None
            candidates = pool._next_workers()
            tried = set()  # a hedge backup that actually saw this request
            #                must not get the same body again next iteration
            #                (duplicate predict work)
            for i, w in enumerate(candidates):
                if id(w) in tried:
                    continue
                tried.add(id(w))
                try:
                    if (pool.hedge_after_s is not None
                            and i + 1 < len(candidates)):
                        verdict, code, out = self._attempt_hedged(
                            w, candidates[i + 1], body, pool, tried)
                    else:
                        verdict, code, out = self._attempt(w, body)
                except Exception as e:  # noqa: BLE001 — worker down mid-request
                    last_err = e
                    continue
                if verdict == "skip":
                    continue
                if verdict == "busy":
                    busy = (code, out)
                    continue
                return self._reply(code, out, rid_hdr)
            if busy is not None:
                # every routable worker is shedding: relay the backpressure
                # verdict (with its Retry-After) instead of inventing a 503
                pool._count("proxy_busy")
                return self._reply(
                    busy[0], busy[1],
                    {"Retry-After": str(pool.retry_after_s), **rid_hdr})
            pool._count("proxy_unavailable")
            self._reply(503, json.dumps(
                {"error": f"no serving worker available: {last_err}"}
                ).encode(),
                {"Retry-After": str(pool.retry_after_s), **rid_hdr})

    def _attempt_hedged(self, primary: "_Worker", backup: "_Worker",
                        body: bytes, pool: "ServingPool", tried: set
                        ) -> Tuple[str, int, bytes]:
        """Bounded hedge for idempotent predicts: fire the primary, and if
        it has not answered within ``hedge_after_s`` also fire ONE backup;
        the first answer wins (the loser's response is discarded — predict
        is pure, so duplicated work is wasted card time, not corruption).
        The backup joins ``tried`` only when the hedge actually fires — a
        fast primary verdict must leave it available to the routing
        loop."""
        import queue as _queue

        results: "_queue.Queue" = _queue.Queue()

        def run(worker):
            try:
                results.put(("ok", self._attempt(worker, body)))
            except Exception as e:  # noqa: BLE001 — breaker already fed
                results.put(("err", e))

        threading.Thread(target=run, args=(primary,), daemon=True).start()
        try:
            kind, payload = results.get(timeout=pool.hedge_after_s)
        except _queue.Empty:
            pool._count("hedged_requests")
            tried.add(id(backup))
            threading.Thread(target=run, args=(backup,), daemon=True).start()
            kind, payload = results.get()  # first of the two to answer
            if kind == "err" or payload[0] == "skip":
                # give the straggler a chance before giving up on the pair
                try:
                    kind2, payload2 = results.get(
                        timeout=self.server.predict_timeout)
                    if kind2 == "ok" and payload2[0] != "skip":
                        kind, payload = kind2, payload2
                except _queue.Empty:
                    pass
        if kind == "ok":
            return payload
        raise payload

    # -- decode fleet (docs/serving.md §Decode fleet) -----------------------
    def _generate_fleet(self, pool: "ServingPool", body: bytes,
                        rid_hdr: dict) -> None:
        """Route one ``POST /generate``: KV-aware placement from cached
        worker healths (falling back to round-robin order behind the
        router's pick), the prefill/decode split via ``X-Prefill-Url``
        when the topology has dedicated prefill workers, and chunked
        streaming relayed end to end.  Backpressure (429/503) before any
        stream byte retries the next decode worker under the SAME
        request id — the proxy assigned it, so the worker-side duplicate
        guard never fires across a retry ladder."""
        from bigdl_tpu_torch.serving.fleet import FleetRouter

        stream = False
        prompt_len = None
        try:
            payload = json.loads(body)
            if isinstance(payload, dict):
                stream = bool(payload.get("stream", False))
                toks = payload.get("tokens")
                if isinstance(toks, list):
                    prompt_len = len(toks)
        except (ValueError, json.JSONDecodeError):
            pass  # malformed body: a worker's 400 is the verdict
        snap = pool.fleet_snapshot()
        entries = []
        for w, h in snap:
            e = dict(h) if isinstance(h, dict) else {}
            e.setdefault("role", w.role)
            e["alive"] = w.routable()
            entries.append(e)
        didx, pidx = FleetRouter().route(entries)
        workers = [w for w, _ in snap]
        # the split is an optimization, not a routing invariant: shipping
        # a SHORT prompt's pages costs more than recomputing them on the
        # decode worker, so only prompts past the threshold cross the
        # handoff channel (an unknown length — prompt-string bodies —
        # splits: it may be arbitrarily long once tokenized)
        worth_splitting = (prompt_len is None
                           or prompt_len >= pool.fleet_split_min_tokens)
        if pidx is not None and workers[pidx].routable() and worth_splitting:
            self._prefill_hdr = workers[pidx].url
            pool._count("fleet_split")
        # the router's decode pick leads; every other decode-capable
        # routable worker follows in round-robin order as the retry
        # ladder (a prefill-role worker never decodes)
        cands: List[_Worker] = []
        seen = set()
        if didx is not None and workers[didx].routable():
            cands.append(workers[didx])
            seen.add(id(workers[didx]))
            pool._count("fleet_routed")
        for w in pool._next_workers():
            if id(w) not in seen and getattr(w, "role", "both") != "prefill":
                cands.append(w)
                seen.add(id(w))
        with trace.span("serving/proxy_generate", request_id=self._rid,
                        stream=stream):
            if stream:
                return self._relay_stream(pool, cands, body, rid_hdr)
            last_err: Optional[BaseException] = None
            busy: Optional[Tuple[int, bytes]] = None
            for w in cands:
                try:
                    verdict, code, out = self._attempt(w, body)
                except Exception as e:  # noqa: BLE001 — worker down
                    last_err = e
                    continue
                if verdict == "skip":
                    continue
                if verdict == "busy":
                    busy = (code, out)
                    continue
                return self._reply(code, out, rid_hdr)
            self._reply_unrouted(pool, busy, last_err, rid_hdr)

    @staticmethod
    def _park(pool: "ServingPool", url: str, conn, resp) -> None:
        if resp.will_close:
            conn.close()
        else:
            pool.conns.release(url, conn)

    def _relay_stream(self, pool: "ServingPool", candidates: List["_Worker"],
                      body: bytes, rid_hdr: dict) -> None:
        """Relay a chunked NDJSON token stream through the proxy's
        keep-alive path: one upstream connection held for the stream's
        life, each worker LINE re-framed toward the client as it arrives
        (token latency is the product — no buffering).

        Mid-stream FAILOVER (docs/serving.md §Fleet fault tolerance):
        every token line is parsed and its token id recorded in
        ``delivered`` before it reaches the client, so when the worker
        dies mid-stream (read error, truncated chunk framing, injected
        ``fleet_stream_sever``) the proxy re-places the request on the
        next decode-capable worker with ``resume_from=delivered`` — the
        engine's position-keyed sampling makes the resumed continuation
        byte-identical — and relays only tokens past the resume point.
        A drain-migrated request prefers the peer that adopted its KV
        (``pool.take_migrated``).  Re-placement rounds retry (the
        supervisor may still be respawning the fleet) within the
        predict-timeout budget; only when that runs out is the stream
        ORPHANED: the client gets a terminal error line and a proper
        chunk terminator, never a silent truncation."""
        headers = {"Content-Type": "application/json",
                   "X-Request-Id": self._rid}
        if self._deadline_hdr is not None:
            headers["X-Deadline-S"] = self._deadline_hdr
        if self._model_hdr is not None:
            headers["X-Model"] = self._model_hdr
        if self._prefill_hdr is not None:
            headers["X-Prefill-Url"] = self._prefill_hdr
        last_err: Optional[BaseException] = None
        busy: Optional[Tuple[int, bytes]] = None
        delivered: List[int] = []   # token ids already relayed, in order
        started = False             # 200 + chunked headers already sent
        failing_since: Optional[float] = None  # first worker-loss instant
        cur_body = body
        budget_t = time.time() + float(self.server.predict_timeout)
        while True:
            for w in candidates:
                if not w.breaker.try_acquire():
                    continue
                resp = conn = None
                try:
                    for attempt in (0, 1):
                        conn, reused = pool.conns.acquire(w.url)
                        try:
                            conn.request("POST", "/generate", body=cur_body,
                                         headers=headers)
                            resp = conn.getresponse()
                            break
                        except Exception:
                            conn.close()
                            conn = None
                            if not (reused and attempt == 0):
                                raise
                            # stale keep-alive socket: one fresh retry
                except Exception as e:  # noqa: BLE001 — worker down
                    w.breaker.record_failure()
                    pool.invalidate_fleet_snapshot()
                    last_err = e
                    continue
                w.breaker.record_success()
                if resp.status in (429, 503):
                    # backpressure BEFORE any stream byte: the next
                    # decode worker retries under the same request id
                    # (a resume body re-prefills deterministically, so
                    # bouncing it between workers is safe)
                    busy = (resp.status, resp.read())
                    self._park(pool, w.url, conn, resp)
                    continue
                chunked = "chunked" in (resp.getheader("Transfer-Encoding")
                                        or "")
                if resp.status != 200 or not chunked:
                    # error verdicts (400/404/500...) come back framed
                    # with Content-Length; relay buffered like any
                    # forward — unless the client already holds half a
                    # stream, in which case this worker merely refused
                    # the resume and the ladder continues
                    data = resp.read()
                    self._park(pool, w.url, conn, resp)
                    if started:
                        last_err = RuntimeError(
                            f"resume refused: HTTP {resp.status} "
                            f"{data[:200]!r}")
                        continue
                    return self._reply(resp.status, data, rid_hdr)
                if failing_since is not None:
                    # the request survived its worker: count the
                    # failover and the recovery latency the client paid
                    pool._count("fleet_failovers")
                    if delivered:
                        pool._count("fleet_resumed_tokens",
                                    len(delivered))
                    global_metrics().observe(
                        "serving.fleet.recovery_s",
                        time.time() - failing_since)
                    flight.record("fleet_failover", request_id=self._rid,
                                  worker=w.name,
                                  resumed_tokens=len(delivered))
                    failing_since = None
                if not started:
                    pool._count("stream_relays")
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     resp.getheader("Content-Type")
                                     or "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.send_header("X-Request-Id", self._rid)
                    self.end_headers()
                    started = True
                outcome, err = self._pump_stream(pool, w, conn, resp,
                                                 delivered)
                if outcome in ("done", "client_gone"):
                    return
                # "severed": the WORKER side failed mid-stream
                w.breaker.record_failure()
                pool.invalidate_fleet_snapshot()
                if failing_since is None:
                    failing_since = time.time()
                last_err = err
                cur_body = self._resume_body(body, delivered)
                if cur_body is None:
                    return self._orphan(pool, started, last_err, rid_hdr)
                candidates = self._failover_candidates(pool, w)
                break  # restart the ladder against the rebuilt list
            else:
                # ladder exhausted without an answer
                if not started:
                    return self._reply_unrouted(pool, busy, last_err,
                                                rid_hdr)
                if time.time() >= budget_t:
                    return self._orphan(pool, started, last_err, rid_hdr)
                # the fleet may be mid-respawn: wait a beat, rebuild
                time.sleep(0.25)
                candidates = self._failover_candidates(pool, None)
            if started and time.time() >= budget_t:
                return self._orphan(pool, started, last_err, rid_hdr)

    def _pump_stream(self, pool: "ServingPool", w: "_Worker", conn, resp,
                     delivered: List[int]
                     ) -> Tuple[str, Optional[BaseException]]:
        """Pump one worker's un-chunked NDJSON stream to the client,
        line-buffered so every ``{"token":..,"index":..}`` event lands in
        ``delivered`` — the failover resume point — before the client
        sees it.  Lines whose index is already delivered (an adopting
        worker re-emits its import-boundary token) are dropped, not
        duplicated.  Returns ``('done', None)`` after a complete stream
        (the worker wrote its terminator — a severed socket raises
        ``IncompleteRead`` from ``read1`` instead), ``('client_gone',
        None)`` when the CLIENT hung up (write-side failure — never
        confused with a worker death), or ``('severed', err)`` when the
        WORKER side failed mid-stream."""
        buf = b""
        while True:
            try:
                faults.fire("fleet_stream_sever")
                data = resp.read1(65536)
            except Exception as e:  # noqa: BLE001 — worker died mid-stream
                conn.close()
                return ("severed", e)
            if not data:
                break
            buf += data
            out = bytearray()
            while b"\n" in buf:
                line, _, buf = buf.partition(b"\n")
                if self._track_line(line, delivered):
                    out += line + b"\n"
            if out:
                try:
                    self.wfile.write(f"{len(out):X}\r\n".encode()
                                     + bytes(out) + b"\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    conn.close()  # worker sees the reset and cancels
                    self.close_connection = True
                    return ("client_gone", None)
        try:
            if buf:
                # defensive: a final line without its newline
                self.wfile.write(f"{len(buf):X}\r\n".encode() + buf
                                 + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            conn.close()
            self.close_connection = True
            return ("client_gone", None)
        if resp.will_close:
            conn.close()
        else:
            pool.conns.release(w.url, conn)
        return ("done", None)

    @staticmethod
    def _track_line(line: bytes, delivered: List[int]) -> bool:
        """Failover bookkeeping for one NDJSON event: token events append
        to ``delivered``; an index the client already holds (the resume
        boundary re-emitted by an adopting worker) is dropped.  Anything
        else — final verdicts, unparseable bytes — passes through
        untouched."""
        if not line.strip():
            return False  # swallow keep-alive blanks, don't re-frame them
        try:
            ev = json.loads(line)
        except Exception:  # noqa: BLE001 — not ours to judge
            return True
        if not isinstance(ev, dict):
            return True
        idx, tok = ev.get("index"), ev.get("token")
        if not isinstance(idx, int) or not isinstance(tok, int):
            return True
        if idx < len(delivered):
            return False  # duplicate of a token the client already has
        delivered.append(tok)
        return True

    def _resume_body(self, body: bytes, delivered: List[int]
                     ) -> Optional[bytes]:
        """Rebuild the request body for a failover re-placement: the
        original payload plus ``resume_from`` = every token the client
        already holds (the worker frontend re-prefills prompt+resume, or
        adopts a parked migration handoff, and continues byte-
        identically).  None when the body cannot be rebuilt (non-JSON
        payload) — the caller orphans the stream."""
        try:
            payload = json.loads(body)
        except Exception:  # noqa: BLE001
            return None
        if not isinstance(payload, dict):
            return None
        if delivered:
            payload["resume_from"] = list(delivered)
        payload["stream"] = True
        return json.dumps(payload).encode()

    def _failover_candidates(self, pool: "ServingPool",
                             exclude: Optional["_Worker"]
                             ) -> List["_Worker"]:
        """Decode-capable routable workers for one failover round — the
        peer that adopted this request's migrated KV (when the pool
        drained the dying worker first) sorted to the front, so a
        migrated request resumes from imported pages instead of paying a
        full re-prefill."""
        cands = [w for w in pool._next_workers()
                 if getattr(w, "role", "both") != "prefill"
                 and w is not exclude]
        peer = pool.take_migrated(self._rid)
        if peer is not None:
            cands.sort(key=lambda w: 0 if w.url == peer else 1)
        return cands

    def _orphan(self, pool: "ServingPool", started: bool,
                err: Optional[BaseException], rid_hdr: dict) -> None:
        """Every re-placement failed inside the budget: the stream is
        ORPHANED.  The client gets a terminal error line plus a proper
        chunk terminator — a well-formed, explicitly failed stream the
        SDK surfaces as an error, never a silent truncation it could
        mistake for completion."""
        pool._count("fleet_orphans")
        flight.record("fleet_orphan", request_id=self._rid,
                      error=str(err))
        if not started:
            return self._reply_unrouted(pool, None, err, rid_hdr)
        line = json.dumps(
            {"done": True,
             "error": f"stream orphaned: worker lost mid-stream and no "
                      f"re-placement succeeded ({err})"}).encode() + b"\n"
        try:
            self.wfile.write(f"{len(line):X}\r\n".encode() + line
                             + b"\r\n" + b"0\r\n\r\n")
        except Exception:  # noqa: BLE001 — client gone too
            pass
        self.close_connection = True

    def _reply_unrouted(self, pool: "ServingPool",
                        busy: Optional[Tuple[int, bytes]],
                        last_err: Optional[BaseException],
                        rid_hdr: dict) -> None:
        if busy is not None:
            # every routable worker is shedding: relay the backpressure
            # verdict instead of inventing a 503
            pool._count("proxy_busy")
            return self._reply(
                busy[0], busy[1],
                {"Retry-After": str(pool.retry_after_s), **rid_hdr})
        pool._count("proxy_unavailable")
        self._reply(503, json.dumps(
            {"error": f"no serving worker available: {last_err}"}).encode(),
            {"Retry-After": str(pool.retry_after_s), **rid_hdr})

    def _reply_federated(self, pool: "ServingPool") -> None:
        """One federated ``GET /metrics``.  A worker that cannot answer
        (dead, respawning, or killed mid-scrape) degrades the scrape —
        its series are dropped and ``federation_stale`` counts the gap —
        it NEVER fails it: the operator's dashboard must stay up exactly
        when workers are dying."""
        parts = []
        for w in pool.worker_list():
            if not w.routable():
                pool._count("federation_stale")
                continue
            try:
                code, data, _ = pool.conns.request(w.url, "GET",
                                                   "/metrics")
                if code != 200:
                    raise RuntimeError(f"HTTP {code}")
                parts.append(({"worker": w.name}, data.decode()))
            except Exception:  # noqa: BLE001 — killed mid-scrape
                pool._count("federation_stale")
        # the proxy's own registry LAST: federation_stale increments from
        # THIS scrape's failures are already visible in its own body
        parts.append(({}, render_prometheus()))
        try:
            body = federate(parts).encode()
            self.send_response(200)
            self.send_header("Content-Type", CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # scraper hung up; never kill the proxy handler thread

    def do_GET(self):
        pool: "ServingPool" = self.server.pool
        # handler instances persist per keep-alive CONNECTION: a prior
        # POST's correlation id/deadline/model must not ride along on
        # probes
        self._rid = None
        self._deadline_hdr = None
        self._model_hdr = None
        self._prefill_hdr = None
        if self.path == "/metrics":
            # FEDERATED scrape (docs/observability.md §Federation): the
            # proxy's own registry plus every live worker's exposition,
            # each worker's series labeled worker="<name>" — one scrape
            # covers the whole pool, every tenant on every worker
            return self._reply_federated(pool)
        if self.path == "/models":
            # the registry lives in the workers; relay the first answer
            for w in pool._next_workers():
                try:
                    code, out, _ = self._forward("GET", w.url, "/models",
                                                 None)
                    return self._reply(code, out)
                except Exception:  # noqa: BLE001 — try the next worker
                    continue
            return self._reply(503, b'{"error": "no worker available"}')
        if self.path != "/health":
            return self._reply(404, b'{"error": "unknown path"}')
        agg = {"status": "ok", "restarts": pool.restarts,
               "pool": dict(pool.stats),
               "autoscale": pool.autoscale_snapshot(), "workers": []}
        for w in pool.worker_list():
            # url reflects the CURRENT process: spawn() clears it before
            # launching, so a corpse's old endpoint never shows up here
            one = {"name": w.name, "url": w.url, "alive": w.alive(),
                   "role": w.role, "breaker": w.breaker.snapshot()}
            if w.alive() and w.url:
                try:
                    _, out, _ = self._forward("GET", w.url, "/health", None)
                    one.update(json.loads(out))
                except Exception as e:  # noqa: BLE001
                    one["error"] = str(e)
            agg["workers"].append(one)
        agg["requests"] = sum(int(w.get("requests", 0))
                              for w in agg["workers"])
        agg["batches"] = sum(int(w.get("batches", 0))
                             for w in agg["workers"])
        if not any(w["alive"] for w in agg["workers"]):
            agg["status"] = "unavailable"
        self._reply(200, json.dumps(agg).encode())


class ServingPool:
    """N process-isolated serving workers behind one round-robin proxy
    with liveness supervision (dead workers are respawned), per-worker
    circuit breakers, drain-before-kill shutdown, keep-alive forwarding,
    and optional metrics-driven autoscaling between ``min_workers`` and
    ``max_workers``."""

    def __init__(self, loader: str, workers: int = 2, batch_size: int = 32,
                 queue_capacity: int = 4096, host: str = "127.0.0.1",
                 port: int = 0, predict_timeout: float = 30.0,
                 worker_env: Optional[dict] = None,
                 supervise_interval_s: float = 1.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 2.0,
                 hedge_after_s: Optional[float] = None,
                 drain_timeout_s: float = 5.0,
                 max_body_bytes: int = 64 * 1024 * 1024,
                 retry_after_s: float = 1.0,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 autoscale_interval_s: float = 2.0,
                 scale_up_queue_depth: Optional[float] = None,
                 scale_down_after: int = 3,
                 scale_cooldown_s: float = 5.0,
                 scale_up_slo_health: float = 0.5,
                 roles: Optional[List[str]] = None,
                 fleet_health_max_age_s: float = 0.25,
                 fleet_split_min_tokens: int = 0):
        self.loader = loader
        self.n = workers
        # per-initial-worker fleet roles (docs/serving.md §Decode fleet),
        # e.g. ["prefill", "decode"]; unnamed (and autoscaled) workers
        # default to "both".  The router only splits prefill from decode
        # when at least one dedicated "prefill" worker exists
        if roles is not None:
            bad = [r for r in roles if r not in ("both", "prefill",
                                                 "decode")]
            if bad:
                raise ValueError(f"bad worker roles {bad}; expected "
                                 "'both', 'prefill' or 'decode'")
            if len(roles) > workers:
                raise ValueError(f"{len(roles)} roles for {workers} "
                                 "workers")
        self.roles = list(roles) if roles else []
        # prompts shorter than this prefill on the decode worker even
        # when a dedicated prefill worker exists: the handoff's fixed
        # cost (harvest, serialize, HTTP, import) only beats local
        # recompute past a prompt length.  0 = always split.
        self.fleet_split_min_tokens = int(fleet_split_min_tokens)
        # /health snapshots the generate router places by, TTL-cached so
        # a burst of concurrent /generate POSTs costs one probe sweep
        self._fleet_max_age_s = fleet_health_max_age_s
        self._fleet_lock = threading.Lock()
        self._fleet_cache: Optional[List[Tuple[_Worker,
                                               Optional[dict]]]] = None
        self._fleet_t = 0.0
        self.batch_size = batch_size
        self.queue_capacity = queue_capacity
        self.worker_env = worker_env
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.hedge_after_s = hedge_after_s
        self.drain_timeout_s = drain_timeout_s
        self.max_body_bytes = max_body_bytes
        self.retry_after_s = retry_after_s
        # autoscaling bounds: [min_workers, max_workers] around the
        # initial size; equal bounds (the default) disable the scaler
        self.min_workers = min(workers, min_workers
                               if min_workers is not None else workers)
        self.max_workers = max(workers, max_workers
                               if max_workers is not None else workers)
        self.autoscale_interval_s = autoscale_interval_s
        # pressure threshold: average queued requests per routable worker
        # that triggers a scale-up; default half a batch — the queue is
        # persistently outrunning one assembly window
        self.scale_up_queue_depth = (scale_up_queue_depth
                                     if scale_up_queue_depth is not None
                                     else max(1.0, batch_size / 2))
        self.scale_down_after = scale_down_after
        self.scale_cooldown_s = scale_cooldown_s
        # SLO-burn scale-up (docs/observability.md §SLOs & burn rates):
        # a worker-reported health score below this adds a worker even
        # when queues look shallow — burn rates see tail-latency pain
        # queue depth alone cannot (0 disables the signal)
        self.scale_up_slo_health = scale_up_slo_health
        self._idle_ticks = 0
        self._last_scale_t = 0.0
        self.workers: List[_Worker] = []
        self._workers_lock = threading.Lock()
        self._worker_seq = 0
        self._rr = 0
        self._rr_lock = threading.Lock()
        self._stop = threading.Event()
        self._supervise_interval = supervise_interval_s
        self.conns = _ConnPool(predict_timeout)
        self._httpd = ThreadingHTTPServer((host, port), _ProxyHandler)
        self._httpd.pool = self  # type: ignore[attr-defined]
        self._httpd.predict_timeout = predict_timeout  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._threads: List[threading.Thread] = []
        self.restarts = 0
        self._stats_lock = threading.Lock()
        self.stats = {"hedged_requests": 0, "proxy_busy": 0,
                      "proxy_unavailable": 0, "rejected_oversize": 0,
                      "conn_reuse": 0, "scale_up": 0, "scale_down": 0,
                      "federation_stale": 0, "fleet_routed": 0,
                      "fleet_split": 0, "stream_relays": 0,
                      "fleet_failovers": 0, "fleet_migrations": 0,
                      "fleet_resumed_tokens": 0, "fleet_orphans": 0}
        # where each drain-migrated request's KV went: request id ->
        # adopting peer url, recorded in phase 1 of _drain_victim BEFORE
        # phase 2 severs the victim's streams, so the failover relay
        # always finds the peer already holding its pages
        self._migrated: Dict[str, str] = {}
        self._migrated_lock = threading.Lock()
        # visible at 0 from the first scrape: an alert on increase needs
        # the series to exist BEFORE the first worker dies
        global_metrics().inc("serving_pool.federation_stale", 0)
        for alias in _FLEET_GLOBAL.values():
            global_metrics().inc(alias, 0)

    def _count(self, name: str, n: int = 1) -> None:
        # proxy handler threads count concurrently; += is not atomic
        with self._stats_lock:
            self.stats[name] += n
        # namespaced into the process registry so the proxy's /metrics
        # scrape exposes them in Prometheus form
        global_metrics().inc(f"serving_pool.{name}", n)
        alias = _FLEET_GLOBAL.get(name)
        if alias is not None:
            global_metrics().inc(alias, n)

    def take_migrated(self, request_id: str) -> Optional[str]:
        """Pop (single failover consumer) the url of the peer that
        adopted this request's migrated KV, if a drain recorded one."""
        with self._migrated_lock:
            return self._migrated.pop(request_id, None)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def worker_list(self) -> List[_Worker]:
        """Point-in-time copy — the autoscaler mutates ``workers``."""
        with self._workers_lock:
            return list(self.workers)

    # -- routing ------------------------------------------------------------
    def _next_workers(self) -> List[_Worker]:
        """Routable workers (alive, registered url, breaker admits) in
        round-robin order starting at the cursor."""
        workers = self.worker_list()
        if not workers:
            return []
        with self._rr_lock:
            self._rr += 1
            start = self._rr
        ordered = [workers[(start + i) % len(workers)]
                   for i in range(len(workers))]
        return [w for w in ordered if w.routable()]

    def _next_urls(self) -> List[str]:
        return [w.url for w in self._next_workers()]

    # -- lifecycle ----------------------------------------------------------
    def _new_worker(self, role: str = "both") -> _Worker:
        with self._workers_lock:
            name = f"worker-{self._worker_seq}"
            self._worker_seq += 1
        return _Worker(self.loader, self.batch_size, self.queue_capacity,
                       self.worker_env, self.breaker_threshold,
                       self.breaker_cooldown_s, self.drain_timeout_s,
                       name=name, role=role,
                       on_breaker_open=self.invalidate_fleet_snapshot)

    def start(self) -> "ServingPool":
        # the proxy process is pure I/O relay — handler threads shuttle
        # small per-token chunks between sockets and never compute.  At
        # the default 5ms GIL switch interval a ready relay thread can
        # sit several intervals behind its peers, which lands directly
        # in every streaming client's TTFT and inter-token tail
        # (measured on the fleet bench: ~8x TTFT p99, ~30% tokens/s).
        sys.setswitchinterval(0.001)
        for i in range(self.n):
            # autoscaled workers (and unnamed slots) are "both": extra
            # capacity must be able to serve whatever the load needs
            w = self._new_worker(self.roles[i] if i < len(self.roles)
                                 else "both")
            w.spawn()
            with self._workers_lock:
                self.workers.append(w)
        self._gauge_workers()
        t = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        t.start()
        s = threading.Thread(target=self._supervise, daemon=True)
        s.start()
        self._threads = [t, s]
        if self.max_workers > self.min_workers:
            a = threading.Thread(target=self._autoscale_run, daemon=True)
            a.start()
            self._threads.append(a)
        log.info("serving pool: %d workers behind %s (autoscale %d..%d)",
                 self.n, self.url, self.min_workers, self.max_workers)
        return self

    def _supervise(self) -> None:
        """Flink-style task supervision: respawn dead workers."""
        while not self._stop.is_set():
            for w in self.worker_list():
                if not w.alive() and not self._stop.is_set():
                    log.warning("serving worker %s died; respawning", w.url)
                    flight.record("worker_died", worker=w.name, url=w.url)
                    self.invalidate_fleet_snapshot()  # don't route to it
                    if w.url:
                        self.conns.clear(w.url)  # the corpse's sockets
                    w.url = None  # stale endpoint: not routable, not
                    #               reported by /health as the corpse's
                    try:
                        w.spawn()
                        self.restarts += 1
                    except Exception as e:  # noqa: BLE001 — retried next tick
                        log.error("respawn failed: %s", e)
            self._stop.wait(self._supervise_interval)

    # -- autoscaling --------------------------------------------------------
    def _worker_health(self, w: _Worker) -> Optional[dict]:
        """One /health probe over the keep-alive pool; None when the
        worker cannot answer (the supervisor's problem, not ours)."""
        if not w.routable():
            return None
        try:
            # chaos seam: fleet_health_stale makes this probe fail as an
            # injected fault — the router must degrade to role+liveness
            # scoring, exactly as it does for a genuinely dead worker
            faults.fire("fleet_health_stale")
            _, data, _ = self.conns.request(w.url, "GET", "/health")
            return json.loads(data)
        except Exception:  # noqa: BLE001 — dead socket or non-JSON body
            return None

    def invalidate_fleet_snapshot(self) -> None:
        """Drop the TTL-cached fleet snapshot NOW — wired as every worker
        breaker's ``on_open`` callback and called on connection-level
        forward failures, so the next /generate routes from fresh healths
        instead of a snapshot that still scores the dead worker as the
        best decode target."""
        with self._fleet_lock:
            self._fleet_cache = None
            self._fleet_t = 0.0

    def fleet_snapshot(self, max_age_s: Optional[float] = None
                       ) -> List[Tuple[_Worker, Optional[dict]]]:
        """Point-in-time ``(worker, health)`` pairs for the generate
        router, TTL-cached (``fleet_health_max_age_s``): placement wants
        fresh slot/page pressure, but a burst of concurrent /generate
        POSTs must not turn into a /health probe per request.  Health is
        None for a worker that cannot answer — the router scores it from
        its configured role and liveness alone."""
        max_age = self._fleet_max_age_s if max_age_s is None else max_age_s
        now = time.time()
        with self._fleet_lock:
            if (self._fleet_cache is not None
                    and now - self._fleet_t <= max_age):
                return self._fleet_cache
        snap = [(w, self._worker_health(w)) for w in self.worker_list()]
        with self._fleet_lock:
            self._fleet_cache = snap
            self._fleet_t = now
        return snap

    def pool_pressure(self) -> dict:
        """The autoscaler's input, from signals the workers already
        export: queue depth and latency percentiles via ``/health``
        (which reads the same gauges/histograms ``/metrics`` scrapes)."""
        depths, p99s, slo_healths = [], [], []
        breaker_open = False
        for w in self.worker_list():
            breaker_open |= w.breaker.snapshot()["state"] != "closed"
            h = self._worker_health(w)
            if h is None:
                continue
            # backlog (heaps + assembled-but-unpredicted) is the honest
            # pressure number — the continuous engine's handoff slot
            # absorbs a queue_depth's worth of waiting work
            depths.append(float(h.get("backlog", h.get("queue_depth", 0))))
            p99s.append(float(h.get("p99_ms", 0.0)))
            slo_healths.append(float(h.get("slo_health", 1.0)))
        return {
            "routable": len(depths),
            "avg_queue_depth": sum(depths) / len(depths) if depths else 0.0,
            "max_p99_ms": max(p99s) if p99s else 0.0,
            "breaker_open": breaker_open,
            # the sickest worker's SLO health score: burn-rate pressure
            # the queue-depth signal cannot see (tail latency, expiries)
            "slo_health": min(slo_healths) if slo_healths else 1.0,
        }

    @staticmethod
    def autoscale_decision(n_workers: int, min_workers: int,
                           max_workers: int, avg_queue_depth: float,
                           up_depth: float, idle_ticks: int,
                           down_after: int, breaker_open: bool,
                           since_last_scale_s: float,
                           cooldown_s: float,
                           slo_health: float = 1.0,
                           unhealthy_below: float = 0.0) -> str:
        """Pure scaling policy (unit-testable without subprocesses),
        asymmetric on purpose: 'up' on a single over-threshold pressure
        tick below the max bound (queued users are waiting NOW; the
        cooldown rate-limits repeats), 'down' only after ``down_after``
        consecutive idle ticks above the min bound — never while a
        breaker is open (a sick worker's load is about to redistribute;
        shrinking now would double the shock), never inside the cooldown
        window after the previous action.  ``slo_health`` below
        ``unhealthy_below`` also scales up — an SLO burning on tail
        latency is user pain the queue-depth signal can miss entirely —
        and an unhealthy pool never scales DOWN, idle-looking or not."""
        if since_last_scale_s < cooldown_s:
            return "hold"
        unhealthy = slo_health < unhealthy_below
        if (avg_queue_depth >= up_depth or unhealthy) \
                and n_workers < max_workers:
            return "up"
        if (avg_queue_depth < 0.5 and idle_ticks >= down_after
                and n_workers > min_workers and not breaker_open
                and not unhealthy):
            return "down"
        return "hold"

    def autoscale_snapshot(self) -> dict:
        return {"min": self.min_workers, "max": self.max_workers,
                "workers": len(self.worker_list()),
                "enabled": self.max_workers > self.min_workers,
                "up_depth": self.scale_up_queue_depth,
                "idle_ticks": self._idle_ticks}

    def _gauge_workers(self) -> None:
        global_metrics().gauge("serving_pool.workers",
                               len(self.worker_list()))

    def _autoscale_run(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.autoscale_interval_s)
            if self._stop.is_set():
                return
            try:
                self._autoscale_tick()
            except Exception as e:  # noqa: BLE001 — scaler must outlive a tick
                log.error("autoscale tick failed: %s", e)

    def _autoscale_tick(self) -> None:
        p = self.pool_pressure()
        if p["routable"] == 0:
            return  # nothing measurable; supervision owns dead workers
        self._idle_ticks = (self._idle_ticks + 1
                            if p["avg_queue_depth"] < 0.5 else 0)
        decision = self.autoscale_decision(
            len(self.worker_list()), self.min_workers, self.max_workers,
            p["avg_queue_depth"], self.scale_up_queue_depth,
            self._idle_ticks, self.scale_down_after, p["breaker_open"],
            time.time() - self._last_scale_t, self.scale_cooldown_s,
            slo_health=p["slo_health"],
            unhealthy_below=self.scale_up_slo_health)
        if decision == "up":
            self._scale_up(p)
        elif decision == "down":
            self._scale_down(p)

    def _scale_up(self, pressure: dict) -> None:
        w = self._new_worker()
        try:
            w.spawn()
        except Exception as e:  # noqa: BLE001 — retried next tick
            log.error("scale-up spawn failed: %s", e)
            return
        with self._workers_lock:
            self.workers.append(w)
        self._last_scale_t = time.time()
        self._count("scale_up")
        self._gauge_workers()
        flight.record("pool_scale_up", worker=w.name,
                      workers=len(self.worker_list()), **pressure)
        log.info("autoscale: +%s (avg queue depth %.1f >= %.1f) -> %d "
                 "workers", w.name, pressure["avg_queue_depth"],
                 self.scale_up_queue_depth, len(self.worker_list()))

    def _scale_down(self, pressure: dict) -> None:
        # newest healthy worker leaves; removal from the routing list
        # comes FIRST, then the drain (stdin close -> the worker finishes
        # its queued requests within its budget), as ServingServer.drain
        with self._workers_lock:
            victim = next((w for w in reversed(self.workers)
                           if w.alive()
                           and w.breaker.snapshot()["state"] == "closed"),
                          None)
            if victim is None or len(self.workers) <= self.min_workers:
                return
            self.workers.remove(victim)
        self._last_scale_t = time.time()
        self._idle_ticks = 0
        # the action is visible (victim out of the routing list) NOW —
        # count/gauge/flight before the drain, so no reader ever sees a
        # shrunken pool with a zero scale_down count
        self._count("scale_down")
        self._gauge_workers()
        flight.record("pool_scale_down", worker=victim.name,
                      workers=len(self.worker_list()), **pressure)
        log.info("autoscale: -%s (idle) -> %d workers", victim.name,
                 len(self.worker_list()))
        # live KV migration (docs/serving.md §Fleet fault tolerance):
        # before the drain, the victim exports its in-flight decode
        # slots to surviving decode-capable peers — a scale-down must
        # never cost a client its stream
        peers = [w.url for w in self.worker_list()
                 if w.routable() and getattr(w, "role", "both") != "prefill"]
        if peers and victim.url:
            self._drain_victim(victim, peers)
        victim.request_stop()
        victim.join_stop()
        if victim.url:
            self.conns.clear(victim.url)

    def _drain_victim(self, victim: _Worker, peers: List[str]) -> None:
        """Two-phase live migration of the victim's in-flight decode
        slots.  Phase 1 (``/fleet/drain`` with ``evict: false``): the
        victim freezes each live slot, exports its pages + sampling
        state as a handoff blob and ships it to a peer, which PARKS it
        keyed by request id — and reports who adopted what.  The
        migration map is recorded HERE, at the proxy, before anything is
        severed.  Phase 2 (``/fleet/evict``): the frozen slots are
        cancelled, which aborts their victim-side streams WITHOUT a
        chunk terminator — the relay sees the truncation, finds the
        adopting peer in ``_migrated`` and resumes from the imported
        pages.  Any phase failing degrades to plain failover-by-
        re-prefill; a drain never drops a request."""
        try:
            code, out, _ = self.conns.request(
                victim.url, "POST", "/fleet/drain",
                body=json.dumps({"peers": peers,
                                 "evict": False}).encode(),
                headers={"Content-Type": "application/json"})
            if code != 200:
                raise RuntimeError(f"HTTP {code}: {out[:200]!r}")
            res = json.loads(out)
        except Exception as e:  # noqa: BLE001 — degrade, never drop
            log.warning("fleet drain of %s failed (%s); its streams will "
                        "fail over by re-prefill", victim.name, e)
            return
        migrated = res.get("migrated") or {}
        frozen = res.get("frozen") or []
        if migrated:
            with self._migrated_lock:
                self._migrated.update(migrated)
            self._count("fleet_migrations", len(migrated))
        flight.record("fleet_drain", worker=victim.name,
                      migrated=len(migrated),
                      failed=len(res.get("failed") or []),
                      request_ids=sorted(migrated))
        if frozen:
            try:
                self.conns.request(
                    victim.url, "POST", "/fleet/evict",
                    body=json.dumps({"rids": frozen}).encode(),
                    headers={"Content-Type": "application/json"})
            except Exception as e:  # noqa: BLE001 — stop() severs anyway
                log.warning("fleet evict on %s failed: %s", victim.name, e)

    def stop(self) -> None:
        """Shut down: close the proxy to new requests, then drain each
        worker (stdin close -> worker finishes queued requests within its
        drain budget) before any kill."""
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        workers = self.worker_list()
        # start every worker's drain first, THEN wait: one shared drain
        # window instead of O(workers * budget) sequential shutdowns
        for w in workers:
            w.request_stop()
        for w in workers:
            w.join_stop()
        self.conns.clear()


def _main() -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--loader", required=True)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--queue-capacity", type=int, default=4096)
    ap.add_argument("--drain-timeout", type=float, default=5.0)
    ap.add_argument("--role", default="both",
                    choices=("both", "prefill", "decode"),
                    help="fleet role for --worker mode "
                         "(docs/serving.md §Decode fleet)")
    ap.add_argument("--roles", default=None,
                    help="comma-separated per-worker roles for pool mode, "
                         "e.g. prefill,decode")
    ap.add_argument("--fleet-split-min-tokens", type=int, default=0,
                    help="only split prefill for prompts at least this "
                         "long (0 = always split)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--min-workers", type=int, default=None)
    ap.add_argument("--max-workers", type=int, default=None)
    ap.add_argument("--port", type=int, default=8000)
    args = ap.parse_args()
    if args.worker:
        _worker_main(args.loader, args.batch_size, args.queue_capacity,
                     args.drain_timeout, role=args.role)
        return
    pool = ServingPool(args.loader, workers=args.workers,
                       batch_size=args.batch_size,
                       queue_capacity=args.queue_capacity,
                       min_workers=args.min_workers,
                       max_workers=args.max_workers,
                       roles=(args.roles.split(",") if args.roles
                              else None),
                       fleet_split_min_tokens=args.fleet_split_min_tokens,
                       port=args.port).start()
    print(f"POOL_URL={pool.url}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pool.stop()


if __name__ == "__main__":
    _main()
