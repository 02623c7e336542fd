"""XShardsTSDataset — the port of
``bigdl_tpu.forecast.xshards_tsdataset``: the per-shard twin of
:class:`~bigdl_tpu_torch.forecast.tsdataset.TSDataset` over the port's
``XShards``, each shard preprocessed on its own while one scaler is
fitted over every shard's rows, so every shard is normalized
identically."""

from typing import Optional, Sequence, Tuple, Union

import numpy as np

from bigdl_tpu_torch.data.shards import XShards
from bigdl_tpu_torch.forecast.tsdataset import StandardScaler, TSDataset


class XShardsTSDataset:
    """Each shard holds a long-format DataFrame (complete ids per shard, the
    reference's repartition-by-id contract)."""

    def __init__(self, datasets, dt_col, target_cols, feature_cols):
        self._ds = datasets  # List[TSDataset]
        self.dt_col = dt_col
        self.target_cols = target_cols
        self.feature_cols = feature_cols
        self.scaler = None

    @staticmethod
    def from_xshards(shards: XShards, dt_col: str,
                     target_col: Union[str, Sequence[str]],
                     id_col: Optional[str] = None,
                     extra_feature_col=None) -> "XShardsTSDataset":
        datasets = [TSDataset.from_pandas(df, dt_col, target_col,
                                          id_col=id_col,
                                          extra_feature_col=extra_feature_col)
                    for df in shards.collect()]
        if not datasets:
            raise ValueError("empty XShards")
        d0 = datasets[0]
        return XShardsTSDataset(datasets, dt_col, d0.target_cols,
                                d0.feature_cols)

    # ---- per-shard delegated preprocessing --------------------------------
    def _each(self, fn) -> "XShardsTSDataset":
        for d in self._ds:
            fn(d)
        return self

    def deduplicate(self) -> "XShardsTSDataset":
        return self._each(lambda d: d.deduplicate())

    def impute(self, mode: str = "last") -> "XShardsTSDataset":
        return self._each(lambda d: d.impute(mode))

    def resample(self, interval: str, merge_mode: str = "mean"):
        return self._each(lambda d: d.resample(interval, merge_mode))

    def gen_dt_feature(self) -> "XShardsTSDataset":
        self._each(lambda d: d.gen_dt_feature())
        self.feature_cols = self._ds[0].feature_cols
        return self

    # ---- globally-fitted scaling ------------------------------------------
    def scale(self, scaler=None) -> "XShardsTSDataset":
        """Fit ONE scaler over all shards' rows, then transform each shard
        with the shared stats (the reference fits on the Spark driver from
        aggregated stats for the same reason: per-shard fits would
        normalize shards inconsistently)."""
        self.scaler = scaler or StandardScaler()
        cols = self.target_cols + self.feature_cols
        allvals = np.concatenate(
            [d.df[cols].to_numpy(np.float64) for d in self._ds], axis=0)
        self.scaler.fit(allvals)
        for d in self._ds:
            d.scale(self.scaler, fit=False)
        return self

    def unscale(self) -> "XShardsTSDataset":
        self._each(lambda d: d.unscale())
        return self

    def roll(self, lookback: int, horizon: int) -> "XShardsTSDataset":
        """Per-shard windowing.  A shard whose series are ALL too short
        yields zero windows (matching the local TSDataset, which skips
        short groups); only zero windows across every shard raises."""
        self._rolled = []
        any_windows = False
        for d in self._ds:
            try:
                d.roll(lookback, horizon)
                self._rolled.append(d)
                any_windows = True
            except ValueError:
                self._rolled.append(None)  # shard contributed nothing
        if not any_windows:
            raise ValueError(
                f"series too short for lookback={lookback} horizon={horizon}"
                " in every shard")
        return self

    # ---- materialisation ---------------------------------------------------
    def _materialized(self):
        if not hasattr(self, "_rolled"):
            raise RuntimeError("call roll(lookback, horizon) first")
        return [d for d in self._rolled if d is not None]

    def to_xshards(self) -> XShards:
        """XShards of (x, y) numpy pairs, one per contributing shard —
        feeds ``Estimator.fit(data=XShards)`` directly."""
        return XShards([d.to_numpy() for d in self._materialized()])

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = zip(*[d.to_numpy() for d in self._materialized()])
        return np.concatenate(xs, 0), np.concatenate(ys, 0)

    def num_partitions(self) -> int:
        # method, matching XShards.num_partitions()
        return len(self._ds)
