"""Lightweight span tracer — Chrome-trace/Perfetto JSON, no dependencies.

The port of ``bigdl_tpu.obs.trace``: the same names, wire
formats and semantics.

Export is the Chrome trace-event format (``{"traceEvents": [...]}``, phase
``"X"`` complete events) which Perfetto and ``chrome://tracing`` load
directly; span ids/attributes ride in ``args``.

Cost when disabled: one module-global ``None`` check per ``span()`` call
(the same posture as ``resilience.faults.fire``).  Enable programmatically
(``obs.trace.enable()``) or via ``BIGDL_TPU_TRACE=/path/out.json`` which
also registers an atexit export.
"""

import contextvars
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


log = logging.getLogger("bigdl_tpu_torch.obs")

_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "bigdl_tpu_current_span", default=None)


class Span:
    """One timed region.  Use as a context manager (via ``Tracer.span`` /
    module-level ``span``); ``set_attribute`` adds attributes mid-flight
    (e.g. a request id only known after admission)."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "start_s",
                 "end_s", "attrs", "_tracer", "_token", "_tid")

    def __init__(self, tracer: "Tracer", name: str, span_id: str,
                 parent_id: Optional[str], trace_id: str,
                 attrs: Dict[str, Any]):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.attrs = attrs
        self.start_s = 0.0
        self.end_s = 0.0
        self._tracer = tracer
        self._token = None
        self._tid = threading.get_ident()

    def set_attribute(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self.start_s = time.time()
        return self

    def end(self) -> "Span":
        """Finish the span NOW (idempotent; the context exit becomes a
        no-op).  For handlers whose LAST wire write is what signals
        completion to the client: ending before that write guarantees a
        reader reacting to the completion event sees the span exported,
        instead of racing the handler thread to the context exit."""
        if self.end_s:
            return self
        self.end_s = time.time()
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self._tracer._finish(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}: {exc}"
        self.end()
        return False


class _NullSpan:
    """The disabled-tracer stand-in: every operation is a no-op."""

    __slots__ = ()

    def set_attribute(self, key, value):
        return self

    def end(self):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _NullSpan()


class Tracer:
    """Collects finished spans in a bounded ring (oldest evicted first —
    a long-running server must not grow without bound) and exports them
    as Chrome-trace JSON."""

    def __init__(self, max_spans: int = 20000):
        self._spans: "deque[Span]" = deque(maxlen=max_spans)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    def _next_id(self) -> str:
        with self._lock:
            return f"{next(self._ids):x}"

    def span(self, name: str, **attrs) -> Span:
        parent = _current.get()
        sid = self._next_id()
        if parent is not None:
            return Span(self, name, sid, parent.span_id, parent.trace_id,
                        attrs)
        return Span(self, name, sid, None, sid, attrs)

    def _finish(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def add_event(self, name: str, start_s: float, end_s: float,
                  **attrs) -> Span:
        """Append an explicitly-timed span — for call sites that time a
        region themselves (the decode engine's per-token steps span one
        engine call shared by many requests; each request's event carries
        the same wall window with its own ``request_id``).  No
        contextvars involvement: these events correlate by attribute, not
        by parent link (docs/observability.md §Decode timelines)."""
        sid = self._next_id()
        s = Span(self, name, sid, None, sid, attrs)
        s.start_s = float(start_s)
        s.end_s = float(max(end_s, start_s))
        self._finish(s)
        return s

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def chrome_trace(self) -> Dict[str, Any]:
        """The trace-event dict (phase-X complete events, microsecond
        timestamps) Perfetto/chrome://tracing load as-is."""
        events = []
        pid = os.getpid()
        for s in self.spans():
            args = {"span_id": s.span_id, "trace_id": s.trace_id}
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            args.update(s.attrs)
            events.append({
                "name": s.name, "cat": s.name.split("/", 1)[0], "ph": "X",
                "ts": s.start_s * 1e6,
                "dur": max(s.end_s - s.start_s, 0.0) * 1e6,
                "pid": pid, "tid": s._tid, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome_trace(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            # default=str: one exotic span attribute (np scalar, enum)
            # must not lose the whole trace at the atexit export
            json.dump(self.chrome_trace(), f, default=str)
        log.info("chrome trace (%d spans) written to %s",
                 len(self._spans), path)
        return path


# -- module-level tracer (what the instrumented sites consult) --------------

_tracer: Optional[Tracer] = None
_env_checked = False
_install_lock = threading.RLock()  # enable() may be re-entered via active()
_atexit_path: Optional[str] = None
_atexit_armed = False

NULL_SPAN = _NULL  # for call sites that build span attributes lazily


def _export_at_exit() -> None:
    # one registered hook reading the CURRENT tracer/path — re-enabling
    # must not stack exporters that overwrite each other's file
    t, p = _tracer, _atexit_path
    if t is not None and p:
        t.export_chrome_trace(p)


def enable(path: Optional[str] = None, max_spans: int = 20000) -> Tracer:
    """Install a process-wide tracer.  ``path`` additionally arms a single
    atexit export (of whatever tracer is current at exit) so a traced run
    needs no explicit teardown."""
    global _tracer, _env_checked, _atexit_path, _atexit_armed
    with _install_lock:
        _tracer = Tracer(max_spans=max_spans)
        _env_checked = True
        if path and not _atexit_armed:
            import atexit

            atexit.register(_export_at_exit)
            _atexit_armed = True
        # pathless enable() clears any leftover path: this tracer was not
        # asked for a file, so exit must not overwrite an earlier run's
        _atexit_path = path
        return _tracer


def disable() -> None:
    global _tracer, _env_checked, _atexit_path
    _tracer = None
    _atexit_path = None
    _env_checked = True  # explicit disable also suppresses the env plan


def get() -> Optional[Tracer]:
    return _tracer


def active() -> Optional[Tracer]:
    """The process tracer, or None when tracing is off — after the lazy
    ``BIGDL_TPU_TRACE`` probe (done once, under a lock: concurrent first
    spans from serving threads must not each install a tracer and split
    the trace between them).  Hot call sites use this to skip building
    span attributes entirely when disabled."""
    global _env_checked
    if _tracer is None:
        if _env_checked:
            return None
        with _install_lock:
            if _tracer is None and not _env_checked:
                path = os.environ.get("BIGDL_TPU_TRACE")
                _env_checked = True
                if path:
                    enable(path)
    return _tracer


def current_span():
    """The context-local active span (None outside any span) — lets call
    sites annotate whatever region they run under without threading a
    span object through every signature."""
    return _current.get()


def span(name: str, **attrs):
    """Instrumented-site entry: near-zero cost when tracing is off (one
    None check after the lazy env probe)."""
    t = active()
    return _NULL if t is None else t.span(name, **attrs)
