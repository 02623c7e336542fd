"""Classical forecasters — the port of ``bigdl_tpu.forecast.classic``
(the reference Chronos ``ARIMAForecaster`` / ``ProphetForecaster``), a
copy of the JAX package's numpy code: host models that never touch the
device.

The reference wraps pmdarima/prophet (host-CPU classical models).  Those
packages are not a dependency, so ARIMA is implemented directly
(Hannan-Rissanen two-stage least squares — the standard CSS-free
estimator for ARMA coefficients) and Prophet is likewise implemented
natively (piecewise-linear trend + Fourier seasonality, MAP ridge
fit)."""

from typing import Dict, Sequence

import numpy as np


class ARIMAForecaster:
    """ARIMA(p, d, q) on a univariate series.

    fit(series) → predict(horizon) — reference
    ``chronos/forecaster/arima_forecaster.py`` surface.  Estimation:
    difference ``d`` times, long-AR pre-fit for residuals, then OLS of
    y_t on p AR lags + q MA (residual) lags + intercept."""

    def __init__(self, p: int = 2, d: int = 0, q: int = 0):
        if p < 1:
            raise ValueError("p >= 1")
        self.p, self.d, self.q = p, d, q
        self._coef = None

    @staticmethod
    def _lag_matrix(y: np.ndarray, lags: int) -> np.ndarray:
        return np.stack([y[lags - k - 1:len(y) - k - 1]
                         for k in range(lags)], axis=1)

    def fit(self, series) -> "ARIMAForecaster":
        x = np.asarray(series, np.float64).ravel()
        if len(x) < self.p + self.q + self.d + 10:
            raise ValueError(
                f"series too short ({len(x)}) for ARIMA"
                f"({self.p},{self.d},{self.q})")
        self._tail = x[-(self.d + self.p + 1):].copy()
        y = x.copy()
        for _ in range(self.d):
            y = np.diff(y)

        p, q = self.p, self.q
        if q > 0:
            # stage 1: long AR to estimate the innovation sequence
            long_p = min(max(2 * (p + q), 8), len(y) // 2)
            A = self._lag_matrix(y, long_p)
            b = y[long_p:]
            phi_long, *_ = np.linalg.lstsq(
                np.hstack([A, np.ones((len(A), 1))]), b, rcond=None)
            resid = np.concatenate([
                np.zeros(long_p), b - np.hstack(
                    [A, np.ones((len(A), 1))]) @ phi_long])
        else:
            resid = np.zeros_like(y)

        # stage 2: y_t on p AR lags (+ q residual lags) + intercept
        m = max(p, q)
        rows = []
        targets = []
        for t in range(m, len(y)):
            row = [y[t - 1 - k] for k in range(p)]
            row += [resid[t - 1 - k] for k in range(q)]
            rows.append(row + [1.0])
            targets.append(y[t])
        X = np.asarray(rows)
        coef, *_ = np.linalg.lstsq(X, np.asarray(targets), rcond=None)
        self._coef = coef
        # state for forecasting: last p diffs + last q residuals
        self._y_hist = list(y[-p:][::-1])          # most recent first
        fitted = X @ coef
        res = np.asarray(targets) - fitted
        self._e_hist = list(res[-q:][::-1]) if q else []
        return self

    def predict(self, horizon: int) -> np.ndarray:
        if self._coef is None:
            raise RuntimeError("call fit() first")
        p, q, d = self.p, self.q, self.d
        yh = list(self._y_hist)
        eh = list(self._e_hist)
        out = []
        for _ in range(horizon):
            feats = yh[:p] + eh[:q] + [1.0]
            nxt = float(np.dot(self._coef, feats))
            out.append(nxt)
            yh = [nxt] + yh[:p - 1] if p > 1 else [nxt]
            if q:
                eh = [0.0] + eh[:q - 1] if q > 1 else [0.0]
        fc = np.asarray(out)
        # invert the differencing from the stored tail
        for k in range(d):
            base = self._tail.copy()
            for _ in range(d - 1 - k):
                base = np.diff(base)
            fc = np.cumsum(fc) + base[-1]
        return fc

    def evaluate(self, actual, metrics: Sequence[str] = ("mse",)
                 ) -> Dict[str, float]:
        a = np.asarray(actual, np.float64).ravel()
        f = self.predict(len(a))
        out = {}
        for m in metrics:
            if m.lower() == "mse":
                out[m] = float(np.mean((a - f) ** 2))
            elif m.lower() == "mae":
                out[m] = float(np.mean(np.abs(a - f)))
            elif m.lower() == "smape":
                out[m] = float(100 * np.mean(
                    2 * np.abs(a - f) / (np.abs(a) + np.abs(f) + 1e-12)))
            else:
                raise ValueError(f"metric {m!r}: mse | mae | smape")
        return out


class ProphetForecaster:
    """Prophet-class structural forecaster, implemented natively (the
    reference ``chronos/forecaster/prophet_forecaster.py`` wraps facebook
    prophet, which is not installed in this image; like the native ARIMA
    above, the MODEL is reimplemented rather than stubbed).

    The Prophet decomposition: piecewise-linear trend with ``n_changepoints``
    evenly placed changepoints (L2 prior on rate deltas — the MAP analog of
    prophet's Laplace prior), plus Fourier seasonality terms per period.
    Fitting is ridge-regularized least squares on the design matrix — the
    MAP point estimate; no MCMC/uncertainty intervals (documented
    divergence).

    Surface matches the reference: ``fit(df_or_series)`` with a pandas
    DataFrame carrying ``ds``/``y`` (or a plain series with implicit
    t = 0..n-1), ``predict(horizon)``, ``evaluate(actual, metrics)``.

    ``seasonalities``: dict period→fourier_order in SAMPLE counts, e.g.
    ``{7: 3}`` for weekly seasonality on daily data (auto: {7:3} when the
    series is long enough, like prophet's weekly default).
    """

    def __init__(self, n_changepoints: int = 12,
                 changepoint_range: float = 0.8,
                 changepoint_prior: float = 0.05,
                 seasonalities=None, seasonality_prior: float = 10.0):
        self.n_changepoints = int(n_changepoints)
        self.changepoint_range = float(changepoint_range)
        self.changepoint_prior = float(changepoint_prior)
        self.seasonalities = seasonalities
        self.seasonality_prior = float(seasonality_prior)
        self._beta = None

    @staticmethod
    def _extract(series):
        if hasattr(series, "columns"):          # pandas DataFrame
            cols = set(series.columns)
            if "y" not in cols:
                raise ValueError("DataFrame needs a 'y' column (and "
                                 "optionally 'ds') — the prophet surface")
            return np.asarray(series["y"], np.float64).ravel()
        return np.asarray(series, np.float64).ravel()

    def _design(self, t: np.ndarray) -> np.ndarray:
        """Columns: [1, t, relu(t - cp_i)..., sin/cos fourier...]."""
        cols = [np.ones_like(t), t]
        for cp in self._cps:
            cols.append(np.maximum(t - cp, 0.0))
        for period, order in self._seas.items():
            for k in range(1, order + 1):
                ang = 2 * np.pi * k * t * self._n / period
                cols.append(np.sin(ang))
                cols.append(np.cos(ang))
        return np.stack(cols, axis=1)

    def fit(self, series) -> "ProphetForecaster":
        y = self._extract(series)
        n = len(y)
        if n < max(2 * self.n_changepoints, 20):
            raise ValueError(f"series too short ({n}) for "
                             f"{self.n_changepoints} changepoints")
        self._n = n
        # time normalized to [0, 1] over the TRAINING window (prophet's
        # scaling); forecasts extrapolate t > 1
        t = np.arange(n, dtype=np.float64) / n
        self._cps = np.linspace(
            0.0, self.changepoint_range, self.n_changepoints + 2)[1:-1]
        seas = self.seasonalities
        if seas is None:
            seas = {7: 3} if n >= 21 else {}
        self._seas = {float(p): int(o) for p, o in seas.items()}

        # y scaled to O(1) like prophet (priors are calibrated for scaled
        # targets; without this the ridge over-shrinks the rate deltas)
        self._y_scale = float(np.max(np.abs(y))) or 1.0
        ys = y / self._y_scale

        X = self._design(t)
        # per-column ridge: trend deltas get 1/(changepoint_prior * n),
        # fourier terms 1/(seasonality_prior * n) — the n keeps the penalty
        # a fixed FRACTION of the data term X'X (which grows with n), so
        # prior strength is sample-size invariant; intercept+slope free
        lam = np.zeros(X.shape[1])
        lam[2:2 + len(self._cps)] = \
            1.0 / (max(self.changepoint_prior, 1e-9) * n)
        lam[2 + len(self._cps):] = \
            1.0 / (max(self.seasonality_prior, 1e-9) * n)
        A = X.T @ X + np.diag(lam)
        self._beta = np.linalg.solve(A, X.T @ ys)
        self._resid_std = float(np.std(ys - X @ self._beta)) * self._y_scale
        return self

    def predict(self, horizon: int) -> np.ndarray:
        if self._beta is None:
            raise RuntimeError("call fit() first")
        t = (self._n + np.arange(horizon, dtype=np.float64)) / self._n
        return self._design(t) @ self._beta * self._y_scale

    def evaluate(self, actual, metrics: Sequence[str] = ("mse",)
                 ) -> Dict[str, float]:
        a = np.asarray(actual, np.float64).ravel()
        f = self.predict(len(a))
        out = {}
        for m in metrics:
            if m.lower() == "mse":
                out[m] = float(np.mean((a - f) ** 2))
            elif m.lower() == "mae":
                out[m] = float(np.mean(np.abs(a - f)))
            elif m.lower() == "smape":
                out[m] = float(100 * np.mean(
                    2 * np.abs(a - f) / (np.abs(a) + np.abs(f) + 1e-12)))
            else:
                raise ValueError(f"metric {m!r}: mse | mae | smape")
        return out
