"""HTTP frontend for synchronous serving.

The port of ``bigdl_tpu.serving.http_frontend``: the same names, wire
formats and semantics.

A stdlib ``ThreadingHTTPServer`` over the in-process
``ServingServer`` queue — requests POST JSON, the engine batches them
onto the card exactly as queue clients do.  Connections are HTTP/1.1
keep-alive: the pool proxy (and any client that holds its connection)
skips the per-request TCP setup.

    POST /predict   {"instances": [[...], ...],
                     "model": "name"?}           -> {"predictions": [...]}
    GET  /health    -> {"status": "ok", "batches": N, "requests": M,
                        "queue_depth": d, "backlog": b, "p50_ms": ..,
                        "p99_ms": .., "occupancy": .., "models": {...}, ...}
    GET  /models    -> the model registry (multi-tenant serving)
    GET  /metrics   -> Prometheus text exposition (docs/observability.md)

Request lifecycle mapping (docs/serving.md): a per-request deadline rides
in as ``"deadline_s"`` in the payload or an ``X-Deadline-S`` header and is
stamped at admission; backpressure/degradation sheds surface as **429**
with a ``Retry-After`` header (never an open-ended block), a deadline that
expires in the queue is **504**, an oversized body is rejected with
**413** before it is read, an unknown model is **404**, and other engine
errors stay **500**.  The target model rides in as ``"model"`` in the
payload or an ``X-Model`` header (absent: the default tenant).

Observability (docs/observability.md): a caller-supplied ``X-Request-Id``
header (or ``"request_id"`` in the payload) becomes the engine request id,
so one id names the request across the proxy, this frontend, and the
engine's enqueue→batch→predict→publish spans; the id — supplied or
generated — is echoed back as ``X-Request-Id`` on every predict response.
"""

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib import request as _urlreq

import numpy as np

from bigdl_tpu_torch.obs import trace
from bigdl_tpu_torch.obs.export import reply_metrics
from bigdl_tpu_torch.serving.json_http import reply_json
from bigdl_tpu_torch.serving.server import (DeadlineExceededError, MODEL_NAME_RE,
                                      RequestDroppedError,
                                      ServiceUnavailableError, ServingServer)

log = logging.getLogger("bigdl_tpu_torch.serving.http")

# caller-supplied request ids are echoed into the X-Request-Id RESPONSE
# header; constrain them to header-safe token characters (a JSON payload
# string could otherwise smuggle CRLF — response splitting).  Checked
# with fullmatch: '$' would still accept a trailing bare newline
REQUEST_ID_RE = re.compile(r"[A-Za-z0-9._:\-]{1,128}")


def _adoptable(parked: dict, tokens, resume: list, kw: dict) -> bool:
    """A parked migration handoff is adoptable iff it is EXACTLY the
    state the resuming stream needs: its tokens are prompt + all-but-
    the-last delivered token, its first_token is the last delivered
    token, and the sampling meta matches — anything else and the
    byte-parity invariant is safer served by re-prefill."""
    try:
        pt = np.asarray(parked["tokens"], np.int32).reshape(-1)
        want = np.concatenate([np.asarray(tokens, np.int32).reshape(-1),
                               np.asarray(resume[:-1], np.int32)])
        return (len(pt) == len(want) and bool(np.array_equal(pt, want))
                and int(parked["first_token"]) == int(resume[-1])
                and float(parked.get("temperature", 0.0))
                == float(kw["temperature"])
                and int(parked.get("top_k", 0)) == int(kw["top_k"])
                and float(parked.get("top_p", 1.0)) == float(kw["top_p"])
                and int(parked.get("seed", 0)) == int(kw["seed"]))
    except Exception:  # noqa: BLE001 — a malformed park is not adoptable
        return False


class _Handler(BaseHTTPRequestHandler):
    server_version = "bigdl-tpu-serving/1"
    # keep-alive: the proxy's per-worker connection reuse (and any
    # persistent client) needs 1.1 — every reply path here sets
    # Content-Length, which 1.1 requires
    protocol_version = "HTTP/1.1"
    # token streams are many tiny writes in the server->client direction;
    # with Nagle on, a chunk can sit in the kernel until the previous
    # one's ACK (http.client already sets TCP_NODELAY on the other side)
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):  # route to our logger, not stderr
        log.debug(fmt, *args)

    def _json(self, code: int, payload: dict,
              headers: Optional[dict] = None):
        reply_json(self, code, json.dumps(payload).encode(), headers)

    def do_GET(self):
        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        if self.path == "/metrics":
            # Prometheus scrape: the server's registry (the process-wide
            # one by default — serving AND training/resilience counters)
            return reply_metrics(self, srv.metrics)
        if self.path == "/models":
            return self._json(200, {"models": srv.models()})
        if self.path != "/health":
            return self._json(404, {"error": f"unknown path {self.path}"})
        stats = dict(srv.stats)
        batches = stats.get("batches", 0)
        # wait-vs-predict tail decomposition + queue pressure: the pool
        # autoscaler's scaling signals, one GET away
        self._json(200, {
            "status": "degraded" if srv.degraded else "ok",
            "degraded": srv.degraded,
            "queue_depth": srv._in.qsize(),
            "backlog": srv.backlog(),
            # decode-fleet routing signals (docs/serving.md §Decode
            # fleet): the worker's role and its engines' slot/page
            # headroom, read by the pool proxy's FleetRouter
            "role": getattr(srv, "role", "both"),
            "decode": srv.decode_pressure(),
            # SLO burn-rate verdicts (docs/observability.md §SLOs & burn
            # rates): the pool autoscaler reads slo_health from here
            "slo_health": srv.slo_health(),
            "slo": srv.slo.snapshot() if srv.slo is not None else None,
            "p50_ms": round(
                srv.metrics.percentile("serving.latency_s", 0.50) * 1e3, 3),
            "p99_ms": round(
                srv.metrics.percentile("serving.latency_s", 0.99) * 1e3, 3),
            "occupancy": round(
                stats.get("requests", 0) / batches
                / max(srv.config.batch_size, 1), 4) if batches else 0.0,
            "models": srv.models(),
            **stats})

    def do_POST(self):
        if self.path == "/generate":
            return self._generate()
        if self.path == "/fleet/prefill":
            return self._fleet_prefill()
        if self.path == "/fleet/import":
            return self._fleet_import()
        if self.path == "/fleet/drain":
            return self._fleet_drain()
        if self.path == "/fleet/evict":
            return self._fleet_evict()
        if self.path == "/recommend":
            return self._recommend()
        if self.path != "/predict":
            return self._json(404, {"error": f"unknown path {self.path}"})
        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0:
                raise ValueError(length)  # read(-1) would buffer to EOF
        except ValueError:
            self.close_connection = True  # unread body poisons keep-alive
            return self._json(400, {"error": "bad Content-Length"})
        if length > self.server.max_body_bytes:  # type: ignore[attr-defined]
            # reject BEFORE reading: one malformed client must not make
            # the worker buffer an arbitrarily large body.  The unread
            # body makes this connection unusable for a next request —
            # close it instead of letting 1.1 keep-alive misparse
            self.close_connection = True
            return self._json(413, {
                "error": f"request body {length} bytes exceeds limit "
                         f"{self.server.max_body_bytes}"})  # type: ignore[attr-defined]
        deadline_s: Optional[float] = None
        req_id: Optional[str] = None
        model: Optional[str] = None
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
            instances = np.asarray(payload["instances"], np.float32)
            hdr = self.headers.get("X-Deadline-S")
            raw = payload.get("deadline_s", hdr) \
                if isinstance(payload, dict) else hdr
            if raw is not None:
                deadline_s = float(raw)
            # request correlation: header wins, payload key is the
            # no-custom-headers fallback; absent both, enqueue generates
            req_id = self.headers.get("X-Request-Id") \
                or payload.get("request_id")
            if req_id is not None:
                req_id = str(req_id)
                if not REQUEST_ID_RE.fullmatch(req_id):
                    return self._json(400, {
                        "error": "bad request id: must match "
                                 "[A-Za-z0-9._:-]{1,128}"})
            # multi-tenant routing: payload key wins (it travels with the
            # body through the pool proxy), X-Model header as fallback
            model = payload.get("model") or self.headers.get("X-Model")
            if model is not None:
                model = str(model)
                if not MODEL_NAME_RE.fullmatch(model):
                    return self._json(400, {
                        "error": "bad model name: must match "
                                 "[A-Za-z0-9._-]{1,64}"})
        except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
            # TypeError covers valid-JSON non-object bodies ([1,2,3], 42)
            return self._json(400, {"error": f"bad request: {e}"})
        with trace.span("serving/http_request") as sp:
            try:
                rid = srv.enqueue(instances, request_id=req_id,
                                  deadline_s=deadline_s, model=model)
            except KeyError as e:
                # unknown model: a registry miss is the caller naming a
                # tenant this worker does not serve
                return self._json(404, {"error": str(e)})
            except ValueError as e:
                # duplicate in-flight X-Request-Id: usually a client retry
                # racing its first attempt — 409 + Retry-After marks it
                # RETRYABLE (the first attempt resolves within its
                # deadline), never a permanent 400
                return self._json(
                    409, {"error": str(e), "duplicate": True},
                    {"Retry-After": str(srv.config.retry_after_s)})
            except ServiceUnavailableError as e:
                # backpressure / degradation / draining: shed with a retry
                # hint so the client (or the pool proxy) goes elsewhere
                return self._json(429, {"error": str(e)},
                                  {"Retry-After": str(e.retry_after)})
            sp.set_attribute("request_id", rid)
            rid_hdr = {"X-Request-Id": rid}
            try:
                result = srv.query(rid, timeout=self.server.predict_timeout)
            except DeadlineExceededError as e:
                return self._json(504, {"error": str(e), "expired": True},
                                  rid_hdr)
            except RequestDroppedError as e:
                return self._json(503, {"error": str(e)}, rid_hdr)
            except Exception as e:  # noqa: BLE001 — surface as 500, keep serving
                return self._json(500, {"error": str(e)}, rid_hdr)
            self._json(200, {"predictions": np.asarray(result).tolist()},
                       rid_hdr)


    # -- recsys pipeline (docs/recsys.md) -----------------------------------
    def _recommend(self):
        """POST /recommend {"user_id":.., "k":..} — the recommendation
        pipeline surface (docs/recsys.md).  Error mapping mirrors
        /predict: 404 unknown user / no pipeline attached, 409 duplicate
        in-flight id, 429 shed (Retry-After), 504 deadline, 500 other.
        Rides the pool proxy unchanged — any non-/generate POST forwards
        path-verbatim to a worker."""
        pipeline = getattr(self.server, "recsys_pipeline", None)
        if pipeline is None:
            return self._json(404, {
                "error": "no recommendation pipeline attached to this "
                         "frontend (HttpFrontend(recsys_pipeline=...))"})
        try:
            payload = self._read_json_body()
            if payload is None:
                return
            user_id = int(payload["user_id"])
            k = int(payload.get("k", 10))
            if k < 1:
                raise ValueError(f"k must be >= 1, got {k}")
            deadline_s = None
            raw = payload.get("deadline_s",
                              self.headers.get("X-Deadline-S"))
            if raw is not None:
                deadline_s = float(raw)
            req_id = self.headers.get("X-Request-Id") \
                or payload.get("request_id")
            if req_id is not None:
                req_id = str(req_id)
                if not REQUEST_ID_RE.fullmatch(req_id):
                    return self._json(400, {
                        "error": "bad request id: must match "
                                 "[A-Za-z0-9._:-]{1,128}"})
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad request: {e}"})
        with trace.span("serving/http_recommend") as sp:
            try:
                items = pipeline.recommend(user_id, k=k,
                                           deadline_s=deadline_s,
                                           request_id=req_id)
            except KeyError as e:
                return self._json(404, {"error": str(e)})
            except ValueError as e:
                srv = self.server.serving  # type: ignore[attr-defined]
                return self._json(
                    409, {"error": str(e), "duplicate": True},
                    {"Retry-After": str(srv.config.retry_after_s)})
            except ServiceUnavailableError as e:
                return self._json(429, {"error": str(e)},
                                  {"Retry-After": str(e.retry_after)})
            except (DeadlineExceededError, TimeoutError) as e:
                return self._json(504, {"error": str(e), "expired": True})
            except RequestDroppedError as e:
                return self._json(503, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — 500, keep serving
                return self._json(500, {"error": str(e)})
            sp.set_attribute("user_id", str(user_id))
            self._json(200, {"items": [{"id": i, "score": s}
                                       for i, s in items]})

    # -- autoregressive decode (docs/serving.md §Autoregressive decode) -----
    def _read_json_body(self):
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0:
                raise ValueError(length)
        except ValueError:
            # the unread body poisons keep-alive framing — same guard
            # as the predict path
            self.close_connection = True
            self._json(400, {"error": "bad Content-Length"})
            return None
        if length > self.server.max_body_bytes:  # type: ignore[attr-defined]
            self.close_connection = True
            self._json(413, {"error": f"request body {length} bytes "
                             "exceeds limit"})
            return None
        return json.loads(self.rfile.read(length) or b"{}")

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    # -- decode fleet (docs/serving.md §Decode fleet) -----------------------
    def _fleet_prefill(self):
        """POST /fleet/prefill — the prefill half of a split generate.
        Body mirrors ``/generate`` (tokens + sampling params); the reply
        is ``pack_handoff`` bytes (application/octet-stream): the prompt
        KV pages, the first token selected during the final prefill
        chunk, and the sampling meta a decode worker resumes from."""
        from bigdl_tpu_torch.serving.fleet import pack_handoff

        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        try:
            payload = self._read_json_body()
            if payload is None:
                return
            tokens = np.asarray(payload.get("tokens",
                                            payload.get("prompt")),
                                np.int32)
            req_id = self.headers.get("X-Request-Id") \
                or payload.get("request_id")
            if req_id is not None and \
                    not REQUEST_ID_RE.fullmatch(str(req_id)):
                return self._json(400, {"error": "bad request id"})
            model = payload.get("model") or self.headers.get("X-Model")
            if model is not None and \
                    not MODEL_NAME_RE.fullmatch(str(model)):
                return self._json(400, {"error": "bad model name"})
            kw = dict(
                request_id=req_id, model=model,
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                seed=int(payload.get("seed", 0)))
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad request: {e}"})
        with trace.span("serving/http_fleet_prefill"):
            try:
                handoff = srv.prefill_handoff(
                    tokens, timeout=self.server.predict_timeout, **kw)  # type: ignore[attr-defined]
            except KeyError as e:
                return self._json(404, {"error": str(e)})
            except TypeError as e:
                return self._json(400, {"error": str(e)})
            except ServiceUnavailableError as e:
                return self._json(429, {"error": str(e)},
                                  {"Retry-After": str(e.retry_after)})
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — keep serving
                return self._json(500, {"error": str(e)})
        data = pack_handoff(handoff)
        try:
            # chaos seam: a corrupt handoff off the prefill wire — the
            # decode worker's hardened unpack rejects it whole and the
            # stream falls back to a local prefill
            from bigdl_tpu_torch.resilience import faults

            faults.fire("fleet_handoff_corrupt")
        except Exception:  # noqa: BLE001 — any configured action corrupts
            data = b"XXXXXXXX" + data[8:]
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("X-Request-Id", str(handoff.get("request_id", "")))
        self.end_headers()
        self.wfile.write(data)

    def _fleet_import(self):
        """POST /fleet/import — park a migrated-in KV handoff (raw
        ``pack_handoff`` bytes) until the pool proxy re-places the
        stream here with ``resume_from``; the resume then adopts the
        parked pages instead of re-prefilling (docs/serving.md §Fleet
        fault tolerance).  A corrupt blob is rejected whole (400) —
        the hardened unpack never partially allocates."""
        from bigdl_tpu_torch.serving.fleet import HandoffError, unpack_handoff

        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length < 0:
                raise ValueError(length)
        except ValueError:
            self.close_connection = True
            return self._json(400, {"error": "bad Content-Length"})
        if length > self.server.max_body_bytes:  # type: ignore[attr-defined]
            self.close_connection = True
            return self._json(413, {"error": f"handoff of {length} bytes "
                                    "exceeds limit"})
        data = self.rfile.read(length)
        cfg = srv.decode_config()
        try:
            h = unpack_handoff(
                data,
                max_bytes=self.server.max_body_bytes,  # type: ignore[attr-defined]
                max_pages=getattr(cfg, "pages_per_slot", None))
        except HandoffError as e:
            return self._json(400, {"error": str(e)})
        eng_dt = str(getattr(cfg, "kv_dtype", "float32"))
        hd_dt = str(h.get("kv_dtype", "float32"))
        if hd_dt != eng_dt:
            # mixed-dtype pages must never park here (an f32 engine has
            # no scale tables; an int8 engine would quantize-import an
            # f32 image and break handoff parity) — refusing the WHOLE
            # blob makes the drain report the failure and the re-placed
            # stream recover via re-prefill failover instead
            # (docs/quantization.md §Serving memory hierarchy)
            return self._json(400, {
                "error": f"handoff kv_dtype {hd_dt!r} does not match "
                         f"this worker's kv_dtype {eng_dt!r}; refusing "
                         "the page import (re-prefill instead)"})
        rid = srv.park_handoff(h)
        self._json(200, {"parked": rid})

    def _fleet_drain(self):
        """POST /fleet/drain — live-migrate this worker's decode slots
        to ``{"peers": [urls]}``.  ``"evict": false`` leaves the frozen
        slots in place for a later ``/fleet/evict`` (the pool's
        two-phase drain: record the migration map BEFORE the victim's
        streams abort)."""
        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        try:
            payload = self._read_json_body()
            if payload is None:
                return
            peers = [str(p) for p in payload.get("peers", [])]
            evict = bool(payload.get("evict", True))
            model = payload.get("model")
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad request: {e}"})
        try:
            out = srv.drain_decode(peers, model=model, evict=evict)
        except Exception as e:  # noqa: BLE001 — drain is best-effort
            return self._json(500, {"error": str(e)})
        self._json(200, out)

    def _fleet_evict(self):
        """POST /fleet/evict — phase two of the two-phase drain: abort
        the frozen ``{"rids": [...]}`` whose state already shipped."""
        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        try:
            payload = self._read_json_body()
            if payload is None:
                return
            rids = [str(r) for r in payload.get("rids", [])]
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad request: {e}"})
        srv.evict_migrated(rids)
        self._json(200, {"evicted": len(rids)})

    def _remote_prefill(self, url: str, tokens, kw: dict):
        """Ship the prompt to a prefill worker; returns the unpacked
        handoff, or None on any failure (caller prefills locally).

        The deadline is hedged: ``prefill_hedge_s`` (when set, tighter
        than ``predict_timeout``) bounds how long a slow prefill worker
        can stall this stream's TTFT — on breach the request falls back
        to the local prefill path immediately and the breach is counted
        as ``serving.fleet.hedged_prefills``."""
        import socket

        from bigdl_tpu_torch.serving.fleet import unpack_handoff

        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        timeout = getattr(self.server, "prefill_hedge_s", None) \
            or self.server.predict_timeout  # type: ignore[attr-defined]
        body = json.dumps({
            "tokens": np.asarray(tokens, np.int32).tolist(),
            "temperature": kw["temperature"], "top_k": kw["top_k"],
            "top_p": kw["top_p"], "seed": kw["seed"],
            "model": kw.get("model"),
            "request_id": kw.get("request_id")}).encode()
        cfg = srv.decode_config(kw.get("model"))
        try:
            req = _urlreq.Request(
                url.rstrip("/") + "/fleet/prefill", data=body,
                headers={"Content-Type": "application/json"})
            with _urlreq.urlopen(req, timeout=timeout) as resp:
                return unpack_handoff(
                    resp.read(),
                    max_pages=getattr(cfg, "pages_per_slot", None))
        except Exception as e:  # noqa: BLE001 — split is best-effort
            reason = getattr(e, "reason", None)
            if isinstance(e, (socket.timeout, TimeoutError)) \
                    or isinstance(reason, (socket.timeout, TimeoutError)):
                srv.metrics.inc("serving.fleet.hedged_prefills")
            log.warning("remote prefill at %s failed (%s); "
                        "prefilling locally", url, e)
            return None

    def _generate(self):
        """POST /generate — token generation over the continuous decode
        engine.  ``{"tokens": [...], "max_new_tokens": n,
        "temperature": t, "top_k": k, "top_p": p, "seed": s,
        "model": name?, "stream": bool}``.

        ``stream=false`` answers one JSON body ``{"tokens": [...]}``.
        ``stream=true`` answers ``Transfer-Encoding: chunked`` NDJSON —
        one ``{"token": id, "index": n}`` line per generated token as
        it decodes, then a final ``{"done": true, "tokens": [...]}``
        line — over the same keep-alive connection (chunked framing is
        what HTTP/1.1 keep-alive needs for a body of unknown length)."""
        srv: ServingServer = self.server.serving  # type: ignore[attr-defined]
        try:
            payload = self._read_json_body()
            if payload is None:
                return
            tokens = np.asarray(payload.get("tokens",
                                            payload.get("prompt")),
                                np.int32)
            stream = bool(payload.get("stream", False))
            req_id = self.headers.get("X-Request-Id") \
                or payload.get("request_id")
            if req_id is not None and \
                    not REQUEST_ID_RE.fullmatch(str(req_id)):
                return self._json(400, {"error": "bad request id"})
            model = payload.get("model") or self.headers.get("X-Model")
            if model is not None and \
                    not MODEL_NAME_RE.fullmatch(str(model)):
                return self._json(400, {"error": "bad model name"})
            hdr = self.headers.get("X-Deadline-S")
            raw = payload.get("deadline_s", hdr)
            deadline_s = float(raw) if raw is not None else None
            resume = payload.get("resume_from")
            if resume is not None:
                if not isinstance(resume, list):
                    return self._json(400, {
                        "error": "resume_from must be a token list"})
                resume = [int(t) for t in resume]
            kw = dict(
                request_id=req_id, deadline_s=deadline_s, model=model,
                max_new_tokens=(int(payload["max_new_tokens"])
                                if "max_new_tokens" in payload else None),
                temperature=float(payload.get("temperature", 0.0)),
                top_k=int(payload.get("top_k", 0)),
                top_p=float(payload.get("top_p", 1.0)),
                seed=int(payload.get("seed", 0)))
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            return self._json(400, {"error": f"bad request: {e}"})
        # physical prefill/decode split: the pool proxy names a dedicated
        # prefill worker via X-Prefill-Url; run the chunked prefill there
        # and resume decode locally from the shipped KV pages.  Any
        # remote-prefill failure falls back to prefilling locally — the
        # split is an optimization, never an availability dependency
        handoff = None
        prepend: list = []      # tokens the client already holds
        idx_off = 0             # stream indices continue past them
        if resume:
            # mid-stream failover resume (docs/serving.md §Fleet fault
            # tolerance): the pool proxy re-places a stream whose worker
            # died, naming the tokens already delivered.  Two recovery
            # paths, both byte-identical to the no-fault run (sampling
            # keys are counter-based on ABSOLUTE position, so the state
            # after prompt+delivered is the state mid-original-run):
            # adopt a parked migration handoff when one matches, else
            # re-prefill prompt+delivered through the chunked path.
            cfg = srv.decode_config(kw["model"])
            if cfg is None:
                return self._json(404, {
                    "error": "no decode engine to resume on"})
            # the ORIGINAL run's effective token budget (engine
            # admission clamps); the resumed run generates the rest
            eff = min(kw["max_new_tokens"] or cfg.max_new_tokens,
                      cfg.cap - 1, cfg.cap - len(tokens))
            r = len(resume)
            rid_hdr = {"X-Request-Id": str(req_id or "")}
            srv.metrics.inc("serving.fleet.resumes")
            if r >= eff or resume[-1] == cfg.eos_id:
                # the original run would have stopped exactly here:
                # nothing left to generate, answer with what the
                # client already holds
                if not stream:
                    return self._json(200, {"tokens": resume}, rid_hdr)
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Request-Id", str(req_id or ""))
                self.end_headers()
                self._chunk(json.dumps(
                    {"done": True, "tokens": resume}).encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")
                return
            parked = srv.take_parked(str(req_id)) if req_id else None
            if parked is not None and str(parked.get(
                    "kv_dtype", "float32")) != str(getattr(
                        srv.decode_config(), "kv_dtype", "float32")):
                # a directly-parked handoff in the wrong page dtype
                # (the import gate normally refuses these): byte parity
                # is safer served by re-prefill than a mixed-dtype
                # adoption the engine would reject at submit
                parked = None
            if parked is not None and _adoptable(parked, tokens,
                                                 resume, kw):
                # live migration adoption: the peer shipped the slot's
                # pages here before the victim aborted the stream — no
                # re-prefill, the last delivered token re-emits as the
                # handoff's first_token and decode continues
                handoff = parked
                prepend = resume[:-1]
                idx_off = r - 1
                kw["max_new_tokens"] = eff - (r - 1)
                srv.metrics.inc("serving.fleet.resume_adopted")
            else:
                # re-prefill recovery: prompt + delivered tokens run
                # through chunked prefill (hitting this worker's prefix
                # cache for any shared prefix); generation continues at
                # absolute position prompt+r, exactly where the dead
                # worker stopped
                tokens = np.concatenate(
                    [tokens, np.asarray(resume, np.int32)])
                prepend = list(resume)
                idx_off = r
                kw["max_new_tokens"] = eff - r
                srv.metrics.inc("serving.fleet.resume_reprefill")
        prefill_url = self.headers.get("X-Prefill-Url")
        if prefill_url and not resume:
            handoff = self._remote_prefill(prefill_url, tokens, kw)
        import queue as _queue

        q: "_queue.Queue" = _queue.Queue()
        with trace.span("serving/http_generate") as sp:
            try:
                rid = srv.enqueue_generate(
                    tokens,
                    on_token=(lambda r, t, i: q.put((t, i + idx_off)))
                    if stream else None, handoff=handoff, **kw)
            except KeyError as e:
                return self._json(404, {"error": str(e)})
            except TypeError as e:
                return self._json(400, {"error": str(e)})
            except ValueError as e:
                if "already in flight" in str(e):
                    # duplicate X-Request-Id racing its first attempt —
                    # retryable, like the predict path's 409
                    return self._json(
                        409, {"error": str(e), "duplicate": True},
                        {"Retry-After": str(srv.config.retry_after_s)})
                # submit-time rejection (prompt over the cache cap, ...)
                return self._json(400, {"error": str(e)})
            except ServiceUnavailableError as e:
                return self._json(429, {"error": str(e)},
                                  {"Retry-After": str(e.retry_after)})
            sp.set_attribute("request_id", rid)
            if not stream:
                from bigdl_tpu_torch.serving.decode_engine import \
                    RequestCancelledError

                rid_hdr = {"X-Request-Id": rid}
                try:
                    result = srv.query(
                        rid, timeout=self.server.predict_timeout)
                except DeadlineExceededError as e:
                    return self._json(504, {"error": str(e),
                                            "expired": True}, rid_hdr)
                except RequestCancelledError as e:
                    # slot migrated away mid-request: 503 marks it
                    # retryable — the pool proxy re-runs it elsewhere
                    return self._json(
                        503, {"error": str(e)},
                        dict(rid_hdr, **{"Retry-After": "0.05"}))
                except Exception as e:  # noqa: BLE001
                    return self._json(500, {"error": str(e)}, rid_hdr)
                return self._json(
                    200,
                    {"tokens": prepend + np.asarray(result).tolist()},
                    rid_hdr)
            # streaming: chunked NDJSON, one event per token
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.send_header("X-Request-Id", rid)
            self.end_headers()
            deadline = time.time() + self.server.predict_timeout  # type: ignore[attr-defined]

            def _drain_now() -> None:
                # greedy drain into ONE chunk write: at thousands of
                # tokens/s across many handler threads, per-token
                # json.dumps + per-token socket writes would steal the
                # GIL from the decode engine itself
                parts = []
                while True:
                    try:
                        tok, idx = q.get_nowait()
                        parts.append(b'{"token": %d, "index": %d}\n'
                                     % (tok, idx))
                    except _queue.Empty:
                        break
                if parts:
                    self._chunk(b"".join(parts))

            try:
                while True:
                    # the final verdict always lands in the result
                    # table; poll it between token events so an error
                    # (expiry, drop) terminates the stream promptly
                    try:
                        tok, idx = q.get(timeout=0.05)
                        parts = [b'{"token": %d, "index": %d}\n'
                                 % (tok, idx)]
                        while True:
                            try:
                                tok, idx = q.get_nowait()
                                parts.append(
                                    b'{"token": %d, "index": %d}\n'
                                    % (tok, idx))
                            except _queue.Empty:
                                break
                        self._chunk(b"".join(parts))
                        # IDLE timeout, not whole-stream: a healthy
                        # long generation streaming past 30s must not
                        # be cut off mid-flight
                        deadline = (time.time()
                                    + self.server.predict_timeout)  # type: ignore[attr-defined]
                        continue
                    except _queue.Empty:
                        pass
                    with srv._result_cv:
                        done = rid in srv._results
                    if done:
                        break
                    if time.time() > deadline:
                        sp.end()  # error event = completion cue, as above
                        self._chunk(json.dumps(
                            {"error": "generate timed out"}).encode()
                            + b"\n")
                        self.wfile.write(b"0\r\n\r\n")
                        self.close_connection = True
                        return
                # drain any tokens that raced the final verdict
                _drain_now()
                from bigdl_tpu_torch.serving.decode_engine import \
                    RequestCancelledError

                try:
                    result = srv.query(rid, timeout=1.0)
                    final = {"done": True, "tokens":
                             prepend + np.asarray(result).tolist()}
                except DeadlineExceededError as e:
                    final = {"done": True, "error": str(e),
                             "expired": True}
                    partial = getattr(e, "partial_tokens", None)
                    if partial is not None:
                        final["tokens"] = \
                            prepend + np.asarray(partial).tolist()
                except RequestCancelledError:
                    # the slot migrated away (or the client was already
                    # detected gone): abort WITHOUT the chunked
                    # terminator — the pool proxy sees a truncated
                    # stream and fails it over onto the adopting peer;
                    # a proper 0-chunk here would read as a clean,
                    # complete (but token-short) stream
                    self.close_connection = True
                    return
                except Exception as e:  # noqa: BLE001
                    final = {"done": True, "error": str(e)}
                # the done event is the client's cue to move on: export
                # the span BEFORE writing it, or a reader that snapshots
                # the trace right after the stream completes races this
                # thread to the context exit and misses the span
                sp.end()
                self._chunk(json.dumps(final).encode() + b"\n")
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                # client hung up mid-stream: free the slot + pages NOW
                # instead of decoding to max_new_tokens on a dead socket
                srv.cancel_generate(rid, reason="client_disconnect")
                self.close_connection = True


class HttpFrontend:
    """Serve a ServingServer over HTTP (threaded stdlib server)."""

    def __init__(self, serving: ServingServer, host: str = "127.0.0.1",
                 port: int = 0, predict_timeout: float = 30.0,
                 max_body_bytes: int = 64 * 1024 * 1024,
                 prefill_hedge_s: Optional[float] = None,
                 recsys_pipeline=None):
        self.serving = serving
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.serving = serving  # type: ignore[attr-defined]
        self._httpd.predict_timeout = predict_timeout  # type: ignore[attr-defined]
        self._httpd.max_body_bytes = max_body_bytes  # type: ignore[attr-defined]
        # POST /recommend routes through this pipeline (docs/recsys.md);
        # None keeps the surface 404 until attach_pipeline
        self._httpd.recsys_pipeline = recsys_pipeline  # type: ignore[attr-defined]
        # hedged prefill (docs/serving.md §Fleet fault tolerance): bound
        # the remote-prefill wait tighter than predict_timeout so a
        # straggling prefill worker costs a hedge, not a stalled TTFT
        self._httpd.prefill_hedge_s = prefill_hedge_s  # type: ignore[attr-defined]
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def attach_pipeline(self, pipeline) -> "HttpFrontend":
        """Attach (or swap) the /recommend pipeline on a live frontend."""
        self._httpd.recsys_pipeline = pipeline  # type: ignore[attr-defined]
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "HttpFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        log.info("HTTP frontend listening on %s", self.url)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class HttpClient:
    """Tiny client for the frontend (reference python http client analog).

    ``keep_alive=True`` holds ONE persistent HTTP/1.1 connection (retried
    once on a stale keep-alive socket) — the sustained-load path; not
    thread-safe in that mode, give each client thread its own instance."""

    def __init__(self, url: str, timeout: float = 30.0,
                 keep_alive: bool = False):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self._keep_alive = keep_alive
        self._conn = None

    def predict(self, instances, deadline_s: Optional[float] = None,
                request_id: Optional[str] = None,
                model: Optional[str] = None) -> np.ndarray:
        payload = {"instances": np.asarray(instances).tolist()}
        if deadline_s is not None:
            payload["deadline_s"] = deadline_s
        if model is not None:
            payload["model"] = model
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if request_id is not None:
            headers["X-Request-Id"] = request_id
        if self._keep_alive:
            status, data = self._request_keep_alive("POST", "/predict",
                                                    body, headers)
            if status != 200:
                raise RuntimeError(
                    f"predict failed: HTTP {status}: {data[:200]!r}")
            out = json.loads(data)
        else:
            req = _urlreq.Request(self.url + "/predict", data=body,
                                  headers=headers)
            with _urlreq.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read())
        return np.asarray(out["predictions"], np.float32)

    def recommend(self, user_id: int, k: int = 10,
                  deadline_s: Optional[float] = None,
                  request_id: Optional[str] = None) -> list:
        """POST /recommend — ranked [(item_id, score), ...] for one user
        through the full feature->recall->ranking pipeline
        (docs/recsys.md)."""
        payload = {"user_id": int(user_id), "k": int(k)}
        if deadline_s is not None:
            payload["deadline_s"] = deadline_s
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if request_id is not None:
            headers["X-Request-Id"] = request_id
        if self._keep_alive:
            status, data = self._request_keep_alive("POST", "/recommend",
                                                    body, headers)
            if status != 200:
                raise RuntimeError(
                    f"recommend failed: HTTP {status}: {data[:200]!r}")
            out = json.loads(data)
        else:
            req = _urlreq.Request(self.url + "/recommend", data=body,
                                  headers=headers)
            with _urlreq.urlopen(req, timeout=self.timeout) as resp:
                out = json.loads(resp.read())
        return [(item["id"], item["score"]) for item in out["items"]]

    def generate(self, tokens, max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 model: Optional[str] = None,
                 deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None, stream: bool = False,
                 resume_from: Optional[list] = None):
        """POST /generate.  ``stream=False`` returns the generated token
        array; ``stream=True`` returns an iterator of NDJSON events —
        ``{"token": id, "index": n}`` per token, then the final
        ``{"done": true, "tokens": [...]}`` — decoded incrementally
        off the chunked response (the wire-framing round-trip the
        decode tests pin).  ``resume_from`` re-places a failed-over
        stream: the tokens already delivered (docs/serving.md §Fleet
        fault tolerance)."""
        payload = {"tokens": np.asarray(tokens, np.int32).tolist(),
                   "temperature": temperature, "top_k": top_k,
                   "top_p": top_p, "seed": seed, "stream": stream}
        if resume_from is not None:
            payload["resume_from"] = [int(t) for t in resume_from]
        if max_new_tokens is not None:
            payload["max_new_tokens"] = max_new_tokens
        if model is not None:
            payload["model"] = model
        if deadline_s is not None:
            payload["deadline_s"] = deadline_s
        body = json.dumps(payload).encode()
        headers = {"Content-Type": "application/json"}
        if request_id is not None:
            headers["X-Request-Id"] = request_id
        if not stream:
            if self._keep_alive:
                status, data = self._request_keep_alive(
                    "POST", "/generate", body, headers)
                if status != 200:
                    raise RuntimeError(
                        f"generate failed: HTTP {status}: {data[:200]!r}")
                out = json.loads(data)
            else:
                # mirror predict(): the keep_alive=False mode stays
                # connection-less (and therefore thread-shareable)
                req = _urlreq.Request(self.url + "/generate", data=body,
                                      headers=headers)
                with _urlreq.urlopen(req, timeout=self.timeout) as resp:
                    out = json.loads(resp.read())
            return np.asarray(out["tokens"], np.int32)
        return self._generate_stream(body, headers)

    def _generate_stream(self, body: bytes, headers: dict):
        import http.client

        host, _, port = self.url.split("//", 1)[1].partition(":")
        conn = http.client.HTTPConnection(host, int(port or 80),
                                          timeout=self.timeout)
        try:
            # a dedicated one-shot connection per stream: ask the server
            # to close it after the final chunk so tearing it down does
            # not reset a kept-alive socket mid-listen
            conn.request("POST", "/generate", body=body,
                         headers=dict(headers, Connection="close"))
            resp = conn.getresponse()
            if resp.status != 200:
                raise RuntimeError(f"generate failed: HTTP {resp.status}: "
                                   f"{resp.read()[:200]!r}")
            # http.client un-chunks transparently; readline yields one
            # NDJSON event per generated token as the server flushes it
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                yield event
                if event.get("done") or "error" in event:
                    break
        finally:
            conn.close()

    def _request_keep_alive(self, method: str, path: str,
                            body: Optional[bytes], headers: dict):
        import http.client

        for attempt in (0, 1):
            fresh = self._conn is None
            if fresh:
                host, _, port = self.url.split("//", 1)[1].partition(":")
                self._conn = http.client.HTTPConnection(
                    host, int(port or 80), timeout=self.timeout)
            try:
                self._conn.request(method, path, body=body, headers=headers)
                resp = self._conn.getresponse()
                data = resp.read()
            except Exception:
                self.close()
                if fresh or attempt:
                    raise
                continue  # stale keep-alive socket: retry on a fresh one
            if resp.will_close:
                self.close()
            return resp.status, data
        raise RuntimeError("unreachable")

    def close(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
            except Exception:  # noqa: BLE001 — already gone
                pass
            self._conn = None

    def models(self) -> dict:
        with _urlreq.urlopen(self.url + "/models",
                             timeout=self.timeout) as resp:
            return json.loads(resp.read())["models"]

    def metrics(self) -> str:
        """One raw Prometheus text scrape of ``GET /metrics``."""
        with _urlreq.urlopen(self.url + "/metrics",
                             timeout=self.timeout) as resp:
            return resp.read().decode()

    def health(self) -> dict:
        with _urlreq.urlopen(self.url + "/health",
                             timeout=self.timeout) as resp:
            return json.loads(resp.read())
