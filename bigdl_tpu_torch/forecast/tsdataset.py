"""TSDataset — the port of ``bigdl_tpu.forecast.tsdataset``, the
time-series preprocessing pipeline: ``TSDataset.from_pandas(df, dt_col,
target_col, id_col, extra_feature_col)``, then chained ``deduplicate /
impute / resample / gen_dt_feature / scale / roll(lookback, horizon)``,
ending in numpy ``(N, lookback, F)`` / ``(N, horizon, T)`` float32
windows.  Host work in pandas and numpy, the JAX package's code; pandas is
imported only where a DataFrame is handled."""

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def _as_list(v) -> List[str]:
    if v is None:
        return []
    return [v] if isinstance(v, str) else list(v)


class StandardScaler:
    def fit(self, arr: np.ndarray) -> "StandardScaler":
        self.mean_ = arr.mean(axis=0, keepdims=True)
        self.scale_ = arr.std(axis=0, keepdims=True) + 1e-8
        return self

    def transform(self, arr):
        return (arr - self.mean_) / self.scale_

    def inverse_transform(self, arr):
        return arr * self.scale_ + self.mean_


class MinMaxScaler:
    def fit(self, arr: np.ndarray) -> "MinMaxScaler":
        self.min_ = arr.min(axis=0, keepdims=True)
        rng = arr.max(axis=0, keepdims=True) - self.min_
        self.scale_ = np.where(rng == 0, 1.0, rng)
        return self

    def transform(self, arr):
        return (arr - self.min_) / self.scale_

    def inverse_transform(self, arr):
        return arr * self.scale_ + self.min_


def unscale_array(scaler, arr: np.ndarray, n_targets: int) -> np.ndarray:
    """Inverse-transform the target slice of a prediction array using a
    fitted scaler's stats (shared by TSDataset.unscale_numpy and
    TSPipeline — the only places that know scaler stat layout)."""
    if scaler is None:
        return arr
    shift = np.asarray(scaler.mean_ if hasattr(scaler, "mean_")
                       else scaler.min_)[0, :n_targets]
    scale = np.asarray(scaler.scale_)[0, :n_targets]
    return arr * scale + shift


class TSDataset:
    """Chained preprocessing over a per-id long-format DataFrame."""

    def __init__(self, df, dt_col: str, target_col: Union[str, Sequence[str]],
                 id_col: Optional[str] = None,
                 extra_feature_col: Union[str, Sequence[str], None] = None):
        self.dt_col = dt_col
        self.target_cols = _as_list(target_col)
        self.id_col = id_col
        self.feature_cols = _as_list(extra_feature_col)
        self.scaler = None
        df = df.copy()
        import pandas as pd

        df[dt_col] = pd.to_datetime(df[dt_col])
        self.df = df.sort_values(([id_col] if id_col else []) + [dt_col])

    @staticmethod
    def from_pandas(df, dt_col: str, target_col,
                    id_col: Optional[str] = None,
                    extra_feature_col=None) -> "TSDataset":
        return TSDataset(df, dt_col, target_col, id_col, extra_feature_col)

    def copy(self) -> "TSDataset":
        """Independent copy (own DataFrame) — chained mutating steps on the
        copy leave the original untouched."""
        out = TSDataset(self.df, self.dt_col, self.target_cols, self.id_col,
                        self.feature_cols)
        out.scaler = self.scaler
        return out

    # -- per-id apply -------------------------------------------------------
    def _groups(self):
        if self.id_col:
            for _, g in self.df.groupby(self.id_col, sort=False):
                yield g
        else:
            yield self.df

    def _apply(self, fn) -> "TSDataset":
        import pandas as pd

        self.df = pd.concat([fn(g) for g in self._groups()], axis=0)
        return self

    # -- cleaning -----------------------------------------------------------
    def deduplicate(self) -> "TSDataset":
        keys = ([self.id_col] if self.id_col else []) + [self.dt_col]
        self.df = self.df.drop_duplicates(subset=keys, keep="last")
        return self

    def impute(self, mode: str = "last") -> "TSDataset":
        """modes: last (ffill+bfill), const (0), linear (interpolate)."""
        cols = self.target_cols + self.feature_cols

        def fix(g):
            g = g.copy()
            if mode == "last":
                g[cols] = g[cols].ffill().bfill()
            elif mode == "const":
                g[cols] = g[cols].fillna(0.0)
            elif mode == "linear":
                g[cols] = g[cols].interpolate(
                    method="linear", limit_direction="both")
            else:
                raise ValueError(f"unknown impute mode {mode!r}")
            return g

        return self._apply(fix)

    def resample(self, interval: str, merge_mode: str = "mean") -> "TSDataset":
        cols = self.target_cols + self.feature_cols

        def rs(g):
            g = g.set_index(self.dt_col)
            agg = getattr(g[cols].resample(interval), merge_mode)()
            if self.id_col:
                agg[self.id_col] = g[self.id_col].iloc[0]
            return agg.reset_index()

        return self._apply(rs)

    def gen_dt_feature(self) -> "TSDataset":
        """Add calendar features from the datetime column (reference
        ``gen_dt_feature``: HOUR/DAYOFWEEK/DAY/MONTH/WEEKOFYEAR...)."""
        dt = self.df[self.dt_col].dt
        feats = {"HOUR": dt.hour, "DAYOFWEEK": dt.dayofweek, "DAY": dt.day,
                 "MONTH": dt.month, "IS_WEEKEND": (dt.dayofweek >= 5)}
        for k, v in feats.items():
            self.df[k] = v.astype(np.float32)
            if k not in self.feature_cols:
                self.feature_cols.append(k)
        return self

    # -- scaling ------------------------------------------------------------
    def scale(self, scaler=None, fit: bool = True) -> "TSDataset":
        cols = self.target_cols + self.feature_cols
        self.scaler = scaler or StandardScaler()
        vals = self.df[cols].to_numpy(np.float64)
        if fit:
            self.scaler.fit(vals)
        self.df[cols] = self.scaler.transform(vals)
        return self

    def unscale(self) -> "TSDataset":
        if self.scaler is None:
            return self
        cols = self.target_cols + self.feature_cols
        self.df[cols] = self.scaler.inverse_transform(
            self.df[cols].to_numpy(np.float64))
        return self

    def unscale_numpy(self, arr: np.ndarray) -> np.ndarray:
        """Unscale a rolled prediction array (N, horizon, n_targets)."""
        return unscale_array(self.scaler, arr, len(self.target_cols))

    # -- windowing ----------------------------------------------------------
    def roll(self, lookback: int, horizon: int,
             feature_col: Optional[Sequence[str]] = None,
             target_col: Optional[Sequence[str]] = None,
             shuffle: bool = False, seed: int = 0) -> "TSDataset":
        """Build (N, lookback, n_targets+n_feats) x / (N, horizon, n_targets)
        y windows across every id group."""
        t_cols = _as_list(target_col) or self.target_cols
        f_cols = (list(feature_col) if feature_col is not None
                  else self.feature_cols)
        xs, ys = [], []
        for g in self._groups():
            tgt = g[t_cols].to_numpy(np.float32)
            feats = (g[f_cols].to_numpy(np.float32) if f_cols
                     else np.zeros((len(g), 0), np.float32))
            data = np.concatenate([tgt, feats], axis=1)
            n = len(g) - lookback - horizon + 1
            if n <= 0:
                continue
            idx = np.arange(n)
            xs.append(data[idx[:, None] + np.arange(lookback)])
            ys.append(tgt[idx[:, None] + lookback + np.arange(horizon)])
        if not xs:
            raise ValueError(
                f"series too short for lookback={lookback} horizon={horizon}")
        self._x = np.concatenate(xs, 0)
        self._y = np.concatenate(ys, 0)
        if shuffle:
            perm = np.random.RandomState(seed).permutation(len(self._x))
            self._x, self._y = self._x[perm], self._y[perm]
        self.lookback, self.horizon = lookback, horizon
        return self

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        if not hasattr(self, "_x"):
            raise RuntimeError("call roll(lookback, horizon) first")
        return self._x, self._y

    # -- splits -------------------------------------------------------------
    def train_val_test_split(self, val_ratio: float = 0.1,
                             test_ratio: float = 0.1):
        """Chronological split on the rolled windows."""
        x, y = self.to_numpy()
        n = len(x)
        n_test = int(n * test_ratio)
        n_val = int(n * val_ratio)
        n_train = n - n_val - n_test
        return ((x[:n_train], y[:n_train]),
                (x[n_train:n_train + n_val], y[n_train:n_train + n_val]),
                (x[n_train + n_val:], y[n_train + n_val:]))
