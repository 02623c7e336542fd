"""Time-series forecasting — the port of ``bigdl_tpu.forecast`` (the
Chronos equivalent): ``TSDataset`` and ``XShardsTSDataset``, the TCN,
LSTM, Seq2Seq, N-Beats and Autoformer forecasters on the port's
``Optimizer``, the anomaly detectors and the classical ARIMA and Prophet
forecasters.

``AutoTSEstimator`` and ``TSPipeline`` need ``automl/``, not ported
yet: they raise, naming ROADMAP A.6.10."""

from bigdl_tpu_torch.forecast.classic import (ARIMAForecaster,
                                              ProphetForecaster)
from bigdl_tpu_torch.forecast.detector import (AEDetector, DBScanDetector,
                                               ThresholdDetector)
from bigdl_tpu_torch.forecast.forecaster import (AutoformerForecaster,
                                                 LSTMForecaster,
                                                 NBeatsForecaster,
                                                 Seq2SeqForecaster,
                                                 TCNForecaster)
from bigdl_tpu_torch.forecast.tsdataset import TSDataset
from bigdl_tpu_torch.forecast.xshards_tsdataset import XShardsTSDataset


class _NeedsAutoml:
    def __init__(self, *args, **kwargs):
        raise ValueError(f"{type(self).__name__}: forecast.autots needs "
                         "automl/, not ported yet (ROADMAP A.6.10)")


class AutoTSEstimator(_NeedsAutoml):
    """Not ported yet (``bigdl_tpu.forecast.autots``, ROADMAP A.6.10)."""


class TSPipeline(_NeedsAutoml):
    """Not ported yet (``bigdl_tpu.forecast.autots``, ROADMAP A.6.10)."""


__all__ = [
    "TSDataset", "XShardsTSDataset", "AutoTSEstimator", "TSPipeline",
    "TCNForecaster", "LSTMForecaster", "Seq2SeqForecaster",
    "NBeatsForecaster", "AutoformerForecaster",
    "ARIMAForecaster", "ProphetForecaster",
    "ThresholdDetector", "AEDetector", "DBScanDetector",
]
