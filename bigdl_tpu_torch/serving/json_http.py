"""Shared JSON-over-HTTP micro server.

The port of ``bigdl_tpu.serving.json_http``: the same names, wire
formats and semantics.

One implementation of the threaded JSON endpoint scaffolding used by the
serving frontends (Cluster-Serving HTTP frontend, Friesian recsys surface)
so error mapping, socket lifecycle, and threading cannot drift between
copies.  Routes are ``{"/path": fn(request_dict) -> response_dict}``;
handler exceptions map to 400 (KeyError — missing/unknown key) or 500,
and the server always stays up.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional


def reply_json(handler: BaseHTTPRequestHandler, code: int, body: bytes,
               headers: Optional[Dict[str, str]] = None) -> None:
    """Write one JSON response, tolerating a client that already hung up
    (its own timeout) — the abandoned-request case must not traceback.
    Shared by every serving HTTP surface (frontend, pool proxy, this
    scaffolding) so the write path cannot drift between copies."""
    try:
        handler.send_response(code)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            handler.send_header(k, v)
        handler.end_headers()
        handler.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        pass


class JsonHTTPServer:
    def __init__(self, routes: Dict[str, Callable[[dict], dict]],
                 host: str = "127.0.0.1", port: int = 0,
                 max_body_bytes: int = 64 * 1024 * 1024):
        server_routes = dict(routes)
        body_limit = max_body_bytes

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def _json(self, code, payload):
                reply_json(self, code, json.dumps(payload).encode())

            def do_POST(self):
                try:
                    fn = server_routes.get(self.path)
                    if fn is None:
                        self._json(404, {"error": f"no route {self.path}"})
                        return
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        if n < 0:       # read(-1) would buffer to EOF
                            raise ValueError(n)
                    except ValueError:
                        self._json(400, {"error": "bad Content-Length"})
                        return
                    if n > body_limit:
                        # bound BEFORE reading: a malformed client must
                        # not make this process buffer an arbitrary body
                        self._json(413, {"error": f"request body {n} "
                                         f"bytes exceeds {body_limit}"})
                        return
                    req = json.loads(self.rfile.read(n) or b"{}")
                    self._json(200, fn(req))
                except KeyError as e:
                    self._json(400, {"error": f"missing/unknown key: {e}"})
                except Exception as e:  # noqa: BLE001 — service stays up
                    self._json(500, {"error": str(e)})

        self._srv = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        h, p = self._srv.server_address
        return f"http://{h}:{p}"

    def start(self) -> "JsonHTTPServer":
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()  # release the listening socket
        if self._thread:
            self._thread.join(timeout=5)
