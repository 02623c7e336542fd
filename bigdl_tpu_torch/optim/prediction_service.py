"""Thread-safe concurrent prediction — reference ``optim/PredictionService``.

The port of ``bigdl_tpu.optim.prediction_service``: the same names, wire
formats and semantics.

A semaphore of ``n_replicas`` permits bounds the predicts in flight
(the card's queue stays shallow and latency predictable), and a call's
error is returned, not raised, by :meth:`try_predict`, so the service
stays up.  The model's weights are its own (no ``variables`` tree): the
service takes a model (served by an :class:`InferenceModel` on
``device``), an :class:`InferenceModel`, or a ``predict_fn``.
"""

import threading

import numpy as np

from bigdl_tpu_torch.serving.inference_model import InferenceModel


class PredictionService:
    def __init__(self, model=None, n_replicas: int = 2, predict_fn=None,
                 device=None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._im = (model if isinstance(model, InferenceModel) else
                    InferenceModel(model, predict_fn=predict_fn,
                                   device=device))
        self._sem = threading.Semaphore(n_replicas)

    def predict(self, x) -> np.ndarray:
        """Blocking predict; safe from any number of threads."""
        with self._sem:
            return self._im.predict(np.asarray(x))

    def try_predict(self, x):
        """Reference ``PredictionService.predict`` error contract: returns
        (result, None) or (None, exception) instead of raising."""
        try:
            return self.predict(x), None
        except Exception as e:  # noqa: BLE001 — service must stay up
            return None, e
