"""Serving client — ``InputQueue``/``OutputQueue`` API.

The port of ``bigdl_tpu.serving.client``: the same names, wire
formats and semantics.

Lifecycle semantics ride through unchanged: ``enqueue`` can shed
(:class:`~bigdl_tpu_torch.serving.server.ServiceUnavailableError` on a full
queue or degraded server — it never blocks unboundedly) and accepts a
per-request ``deadline_s``; ``query`` raises the request's recorded
verdict (:class:`~bigdl_tpu_torch.serving.server.DeadlineExceededError` when it
expired in the queue, :class:`~bigdl_tpu_torch.serving.server.
RequestDroppedError` when the server stopped before processing it).
"""

from typing import Optional

import numpy as np

from bigdl_tpu_torch.serving.server import ServingServer


class InputQueue:
    def __init__(self, server: ServingServer):
        self._server = server

    def enqueue(self, uri: Optional[str] = None,
                deadline_s: Optional[float] = None,
                model: Optional[str] = None, **kwargs) -> str:
        """``InputQueue.enqueue(uri, t=ndarray)`` — returns the request id.

        ``deadline_s`` (relative) bounds how long the request may wait in
        the queue before the engine drops it instead of predicting;
        ``model`` names the registered tenant (default tenant when
        None)."""
        if len(kwargs) != 1:
            raise ValueError("enqueue expects exactly one named tensor, "
                             "e.g. enqueue('req-1', t=arr)")
        (arr,) = kwargs.values()
        return self._server.enqueue(np.asarray(arr), request_id=uri,
                                    deadline_s=deadline_s, model=model)

    def enqueue_generate(self, uri: Optional[str] = None,
                         deadline_s: Optional[float] = None,
                         model: Optional[str] = None, *, tokens,
                         **gen_kwargs) -> str:
        """Queue-client surface of the decode path (docs/serving.md
        §Autoregressive decode): admit a generate request for
        ``model``'s continuous decode engine; ``OutputQueue.query``
        returns the generated token array.  ``gen_kwargs`` pass through
        to :meth:`~bigdl_tpu_torch.serving.server.ServingServer.
        enqueue_generate` (max_new_tokens, temperature, top_k, top_p,
        seed, on_token — and ``handoff``, a prefill worker's unpacked
        KV handoff for the decode-fleet split of docs/serving.md
        §Decode fleet, in which case ``tokens`` may be the handoff's
        own token array)."""
        return self._server.enqueue_generate(
            np.asarray(tokens, np.int32), request_id=uri,
            deadline_s=deadline_s, model=model, **gen_kwargs)


class OutputQueue:
    def __init__(self, server: ServingServer):
        self._server = server

    def query(self, uri: str, timeout: float = 30.0) -> np.ndarray:
        return self._server.query(uri, timeout=timeout)
