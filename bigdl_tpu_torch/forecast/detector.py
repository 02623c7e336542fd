"""Anomaly detectors — the port of ``bigdl_tpu.forecast.detector``:
``ThresholdDetector`` (bounds on y or on |y - y_hat|), ``AEDetector``
(an autoencoder's reconstruction error, trained through the port's
``Optimizer`` on ``device``, None is ``cuda``) and ``DBScanDetector``
(density clustering), in numpy and PyTorch, with no sklearn."""

from typing import Optional

import numpy as np


class ThresholdDetector:
    """Flag points outside [min, max], or where |y - y_hat| > threshold
    derived from a ratio of the error distribution."""

    def __init__(self, threshold: Optional[tuple] = None,
                 ratio: float = 0.01):
        self.threshold = threshold
        self.ratio = ratio
        self._fitted_th = None

    def fit(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None
            ) -> "ThresholdDetector":
        if y_pred is not None:
            err = np.abs(np.asarray(y) - np.asarray(y_pred)).ravel()
            self._fitted_th = np.quantile(err, 1.0 - self.ratio)
        return self

    def score(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None
              ) -> np.ndarray:
        y = np.asarray(y)
        if y_pred is not None:
            return np.abs(y - np.asarray(y_pred)).ravel()
        return y.ravel()

    def anomaly_indexes(self, y: np.ndarray,
                        y_pred: Optional[np.ndarray] = None) -> np.ndarray:
        s = self.score(y, y_pred)
        if y_pred is not None:
            th = self._fitted_th
            if th is None:
                th = np.quantile(s, 1.0 - self.ratio)
            return np.nonzero(s > th)[0]
        if self.threshold is None:
            lo, hi = np.quantile(s, self.ratio), np.quantile(s, 1 - self.ratio)
        else:
            lo, hi = self.threshold
        return np.nonzero((s < lo) | (s > hi))[0]


class AEDetector:
    """Dense autoencoder on sliding windows; anomaly = top-ratio
    reconstruction error."""

    def __init__(self, roll_len: int = 24, ratio: float = 0.01,
                 hidden: int = 16, epochs: int = 30, lr: float = 1e-2,
                 batch_size: int = 64, seed: int = 0, device=None):
        self.roll_len = roll_len
        self.device = device
        self.ratio = ratio
        self.hidden = hidden
        self.epochs = epochs
        self.lr = lr
        self.batch_size = batch_size
        self.seed = seed

    def _roll(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y, np.float32).ravel()
        n = len(y) - self.roll_len + 1
        if n <= 0:
            raise ValueError("series shorter than roll_len")
        return y[np.arange(n)[:, None] + np.arange(self.roll_len)]

    def fit(self, y: np.ndarray) -> "AEDetector":
        import torch

        from bigdl_tpu_torch import nn
        from bigdl_tpu_torch.data.dataset import DataSet
        from bigdl_tpu_torch.nn.criterion import MSECriterion
        from bigdl_tpu_torch.optim.optim_method import Adam
        from bigdl_tpu_torch.optim.optimizer import Optimizer
        from bigdl_tpu_torch.optim.trigger import Trigger

        w = self._roll(y)
        self._mu, self._sd = w.mean(), w.std() + 1e-8
        wn = (w - self._mu) / self._sd
        g = torch.Generator().manual_seed(self.seed)
        model = nn.Sequential([
            nn.Linear(self.roll_len, self.hidden, generator=g), nn.Tanh(),
            nn.Linear(self.hidden, self.roll_len, generator=g)])
        ds = DataSet.array(wn, wn)
        opt = Optimizer(model, ds, MSECriterion(),
                        batch_size=self.batch_size, device=self.device)
        opt.set_optim_method(Adam(learning_rate=self.lr))
        opt.set_end_when(Trigger.max_epoch(self.epochs))
        self._trained = opt.optimize()
        return self

    def score(self, y: np.ndarray) -> np.ndarray:
        w = self._roll(y)
        wn = (w - self._mu) / self._sd
        rec = np.asarray(self._trained.predict(wn, batch_size=256))
        err = ((rec - wn) ** 2).mean(axis=1)
        # distribute window scores back to points (max over windows covering
        # the point)
        n_pts = len(np.asarray(y).ravel())
        out = np.zeros(n_pts)
        for off in range(self.roll_len):
            idx = np.arange(len(err)) + off
            out[idx] = np.maximum(out[idx], err)
        return out

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        """Top ``ratio`` fraction of points by reconstruction error (window
        errors are shared by every point a window covers, so quantile
        thresholds tie — rank instead)."""
        s = self.score(y)
        k = max(1, int(np.ceil(self.ratio * len(s))))
        return np.sort(np.argsort(s)[-k:])


class DBScanDetector:
    """Plain-numpy DBSCAN on 1-D values: noise points = anomalies."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5):
        self.eps = eps
        self.min_samples = min_samples

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        v = np.asarray(y, np.float64).ravel()
        order = np.argsort(v)
        sv = v[order]
        # neighbor counts within eps via two-pointer over the sorted values
        left = np.searchsorted(sv, sv - self.eps, side="left")
        right = np.searchsorted(sv, sv + self.eps, side="right")
        counts = right - left
        core = counts >= self.min_samples
        # a point is noise if it is not core and no core point is within eps
        noise = []
        core_vals = sv[core]
        for i, val in enumerate(sv):
            if core[i]:
                continue
            j = np.searchsorted(core_vals, val)
            near = False
            for jj in (j - 1, j):
                if 0 <= jj < len(core_vals) and \
                        abs(core_vals[jj] - val) <= self.eps:
                    near = True
                    break
            if not near:
                noise.append(order[i])
        return np.sort(np.asarray(noise, dtype=int))
