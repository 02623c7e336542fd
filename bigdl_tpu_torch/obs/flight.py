"""Crash flight recorder — the last N notable events, dumped on death.

The port of ``bigdl_tpu.obs.flight``: the same names, wire
formats and semantics.

- explicitly (``dump()`` — tests, operator tooling),
- on SIGTERM (the preemption signal) via ``install()``,
- on an unhandled exception crashing the process (``sys.excepthook``
  chain), also via ``install()``.

The dump is one JSON object per line (``{"t": wall, "kind": ..., **data}``)
so ``grep``/``jq`` postmortems need no custom reader.  Recording is
process-wide by default (``record(kind, **data)`` hits the global
recorder); subsystems call it unconditionally — a ring-buffer append is
cheap enough to leave on in production, which is the entire point of a
flight recorder.
"""

import json
import logging
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional


log = logging.getLogger("bigdl_tpu_torch.obs")

DEFAULT_CAPACITY = 512


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 path: Optional[str] = None):
        self._events: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        # REENTRANT: the SIGTERM/crash handlers run on the main thread and
        # call record()/dump(); a plain Lock would deadlock if the signal
        # landed while the main thread was inside record()
        self._lock = threading.RLock()
        self._dumped = False
        self.installed = False  # install() was called: crash dumps armed
        self.path = path or os.path.join(
            os.getcwd(), f"flight-{os.getpid()}.jsonl")
        self.events_total = 0

    def record(self, kind: str, **data) -> None:
        evt = {"t": time.time(), "kind": kind}
        evt.update(data)
        with self._lock:
            self._events.append(evt)
            self.events_total += 1

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def dump(self, path: Optional[str] = None, reason: str = "explicit"
             ) -> str:
        """Write the ring as JSONL; returns the path.  Never raises — a
        failing dump inside a signal/crash handler must not mask the
        original death."""
        path = path or self.path
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with self._lock:
                events = list(self._events)
            with open(path, "w") as f:
                f.write(json.dumps(
                    {"t": time.time(), "kind": "flight_dump",
                     "reason": reason, "pid": os.getpid(),
                     "events": len(events),
                     "events_total": self.events_total}) + "\n")
                snap = self._metrics_snapshot(
                    blocking=not reason.startswith("signal"))
                if snap is not None:
                    f.write(json.dumps(snap, default=str) + "\n")
                for line in _dump_source_lines():
                    f.write(json.dumps(line, default=str) + "\n")
                for evt in events:
                    f.write(json.dumps(evt, default=str) + "\n")
            self._dumped = True
            log.info("flight recorder: %d events dumped to %s (%s)",
                     len(events), path, reason)
        except Exception as e:  # noqa: BLE001 — see docstring
            log.error("flight recorder dump failed: %s", e)
        return path

    @staticmethod
    def _metrics_snapshot(blocking: bool = True) -> Optional[Dict[str, Any]]:
        """Final metric state (process-wide counters + gauges) for the
        dump, so a post-mortem carries how far the job got — not just the
        event ring.  Never raises (dump runs in crash handlers); signal
        paths pass ``blocking=False`` because the handler may have
        interrupted the frame holding the registry's non-reentrant lock —
        a blocking acquire there would hang the dump forever."""
        try:
            from bigdl_tpu_torch.optim.metrics import global_metrics

            snap = global_metrics().snapshot(blocking=blocking)
            if snap is None:  # lock held by the interrupted frame
                return None
            return {"t": time.time(), "kind": "metrics_snapshot",
                    "counters": snap.get("counters", {}),
                    "gauges": snap.get("gauges", {})}
        except Exception:  # noqa: BLE001 — see dump() docstring
            return None

    def install(self, path: Optional[str] = None, signals=None) -> None:
        """Arm the crash/preemption dump: chain a ``sys.excepthook`` that
        dumps before the previous hook runs, and a handler for each signal
        (default SIGTERM) that dumps and then re-delivers to the previous
        handler.  Idempotent enough for tests: re-installing just layers
        another chain link."""
        import signal as _signal

        if path:
            self.path = path
        self.installed = True
        prev_hook = sys.excepthook

        def _hook(exc_type, exc, tb):
            self.record("crash", error=f"{exc_type.__name__}: {exc}")
            self.dump(reason="crash")
            prev_hook(exc_type, exc, tb)

        sys.excepthook = _hook
        # non-main threads (the serving engine loop, supervisor sweeps,
        # proxy handlers) are the recorder's main event sources and report
        # through threading.excepthook, not sys.excepthook
        prev_thook = threading.excepthook

        def _thook(args):
            self.record("thread_crash", thread=args.thread.name
                        if args.thread else None,
                        error=f"{args.exc_type.__name__}: {args.exc_value}")
            self.dump(reason="thread crash")
            prev_thook(args)

        threading.excepthook = _thook
        for sig in (signals if signals is not None else (_signal.SIGTERM,)):
            prev = _signal.getsignal(sig)

            def _on_signal(signum, frame, _prev=prev):
                self.record("signal", signum=signum)
                self.dump(reason=f"signal {signum}")
                if callable(_prev):
                    _prev(signum, frame)
                elif _prev != _signal.SIG_IGN:
                    # SIG_DFL, or None (handler owned by non-Python code —
                    # getsignal can't represent it): restore + re-raise so
                    # the dump never turns a fatal signal into a no-op
                    _signal.signal(signum, _signal.SIG_DFL)
                    _signal.raise_signal(signum)

            _signal.signal(sig, _on_signal)


# -- auxiliary dump sources (subsystem state rings) -------------------------
#
# Subsystems with their OWN bounded event state (the decode engine's
# scheduling ring: slot admissions, expiries, prefill interleave) register
# a provider; every dump writes one JSON line per live source next to the
# metrics_snapshot line.  Providers are held via weakref.WeakMethod so a
# stopped engine's ring is pruned, never pinned alive by the recorder.

_dump_sources: "Dict[str, Any]" = {}
_sources_lock = threading.Lock()


def register_dump_source(name: str, method) -> None:
    """Register a bound method returning a JSON-able dict to include in
    every flight dump (keyed by ``name``; re-registering replaces)."""
    import weakref

    with _sources_lock:
        _dump_sources[name] = weakref.WeakMethod(method)


def unregister_dump_source(name: str) -> None:
    with _sources_lock:
        _dump_sources.pop(name, None)


def _dump_source_lines() -> List[Dict[str, Any]]:
    """Evaluate live sources (dead weakrefs pruned); never raises — a
    broken provider must not mask the death being dumped."""
    with _sources_lock:
        items = list(_dump_sources.items())
    out, dead = [], []
    for name, ref in items:
        fn = ref()
        if fn is None:
            dead.append(name)
            continue
        try:
            payload = fn()
        except Exception:  # noqa: BLE001 — see docstring
            continue
        if isinstance(payload, dict):
            out.append({"t": time.time(), "kind": "dump_source",
                        "source": name, **payload})
    if dead:
        with _sources_lock:
            for name in dead:
                _dump_sources.pop(name, None)
    return out


# -- process-wide recorder (what the instrumented sites hit) ----------------

_recorder: Optional[FlightRecorder] = None
_lock = threading.Lock()


def global_recorder() -> FlightRecorder:
    global _recorder
    if _recorder is None:
        with _lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record(kind: str, **data) -> None:
    """The instrumented-site entry: appends to the process recorder."""
    global_recorder().record(kind, **data)


def install(path: Optional[str] = None, signals=None) -> FlightRecorder:
    """Arm the process recorder's crash/SIGTERM dump (see
    :meth:`FlightRecorder.install`)."""
    rec = global_recorder()
    rec.install(path=path, signals=signals)
    return rec


def dump_if_installed(reason: str) -> None:
    """Dump the process recorder ONLY when crash dumps were armed via
    :func:`install` — for death paths that bypass excepthook/signals/atexit
    entirely (``os._exit`` in exit-action fault injection).  Never raises."""
    rec = _recorder
    if rec is not None and rec.installed:
        rec.dump(reason=reason)
