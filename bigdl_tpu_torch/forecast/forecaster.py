"""Forecasters — the port of ``bigdl_tpu.forecast.forecaster``: the fit /
predict / evaluate / save / load harness over the forecast models, on the
port's ``Optimizer`` on ``device`` (None is ``cuda``).

``fit(parallelism=...)`` trains through the declarative layout driver
(``parallel.gspmd.fit_layout``) on every rank of the world.

Not ported, each refused with a ``ValueError`` naming its ROADMAP item:
``optimize_predict`` / ``predict_with_optimized`` (``nano``'s
InferenceOptimizer, A.6.10)."""

import functools
import inspect
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.forecast.autoformer import Autoformer
from bigdl_tpu_torch.forecast.models import (LSTMForecastNet, NBeats,
                                             Seq2SeqNet, TCN)
from bigdl_tpu_torch.forecast.tsdataset import TSDataset
from bigdl_tpu_torch.nn.criterion import MSECriterion
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.optim.optim_method import Adam
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import MAE, MSE
from bigdl_tpu_torch.utils.convert import export_variables


def _as_xy(data) -> Tuple[np.ndarray, np.ndarray]:
    if isinstance(data, TSDataset):
        return data.to_numpy()
    if isinstance(data, (tuple, list)):
        return np.asarray(data[0], np.float32), np.asarray(data[1], np.float32)
    raise TypeError(f"unsupported data {type(data)}")


class BaseForecaster:
    """The fit / predict / evaluate lifecycle of every forecaster.  The
    model is built at construction (its weights drawn from ``seed``), on
    the CPU until the first fit or load moves it to ``device``."""

    def __init_subclass__(cls, **kw):
        # every concrete forecaster records its constructor arguments as
        # self._init_args, so that a saved forecaster can be rebuilt
        super().__init_subclass__(**kw)
        orig = cls.__init__
        sig = inspect.signature(orig)
        var_kw = [p.name for p in sig.parameters.values()
                  if p.kind is inspect.Parameter.VAR_KEYWORD]

        @functools.wraps(orig)
        def wrapped(self, *args, **kwargs):
            if not hasattr(self, "_init_args"):
                ba = sig.bind(self, *args, **kwargs)
                ba.apply_defaults()
                d = dict(ba.arguments)
                d.pop("self", None)
                for name in var_kw:   # flatten **kwargs whatever its name
                    d.update(d.pop(name, None) or {})
                self._init_args = d
            orig(self, *args, **kwargs)

        cls.__init__ = wrapped

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 optimizer: Optional[object] = None, lr: float = 1e-3,
                 loss=None, seed: int = 0, device=None):
        import torch

        self.lookback = past_seq_len
        self.horizon = future_seq_len
        self.in_dim = input_feature_num
        self.out_dim = output_feature_num
        self.optim = optimizer or Adam(learning_rate=lr)
        self.criterion = loss or MSECriterion()
        self.seed = seed
        self.device = resolve_device(device)
        self.generator = torch.Generator().manual_seed(seed)
        self.model = self._build_model()
        self._trained: Optional[TrainedModel] = None

    def _build_model(self):
        raise NotImplementedError

    # ---- lifecycle ----------------------------------------------------------
    def fit(self, data, epochs: int = 10, batch_size: int = 32,
            validation_data=None,
            parallelism: Optional[str] = None) -> "BaseForecaster":
        """Train from the model's current weights; with
        ``validation_data``, MSE at every epoch's end.  ``parallelism=``
        trains through ``fit_layout`` (the layout's stats land on
        ``self._layout_stats``) and, as in the JAX package, refuses
        ``validation_data``."""
        x, y = _as_xy(data)
        if parallelism is not None:
            if validation_data is not None:
                raise ValueError(
                    f"parallelism={parallelism!r} (declarative GSPMD fit) "
                    "does not support validation_data yet — drop it or "
                    "unset parallelism to use the classic ZeRO-1 driver "
                    "(docs/parallelism.md §Declarative layouts)")
            from bigdl_tpu_torch.parallel.gspmd import fit_layout

            self._trained, self._layout_stats = fit_layout(
                self.model, self.criterion, self.optim,
                DataSet.array(x, y), parallelism=str(parallelism),
                batch_size=batch_size, epochs=epochs, seed=self.seed,
                device=self.device)
            return self
        opt = Optimizer(self.model, DataSet.array(x, y), self.criterion,
                        batch_size=batch_size, device=self.device)
        opt.set_optim_method(self.optim)
        opt.set_end_when(Trigger.max_epoch(epochs))
        if validation_data is not None:
            vx, vy = _as_xy(validation_data)
            opt.set_validation(Trigger.every_epoch(),
                               DataSet.array(vx, vy), [MSE()])
        self._trained = opt.optimize()
        return self

    @staticmethod
    def _coerce_x(data) -> np.ndarray:
        if isinstance(data, TSDataset):
            x, _ = data.to_numpy()
            return x
        if isinstance(data, (tuple, list)):
            return np.asarray(data[0], np.float32)
        return np.asarray(data, np.float32)

    def predict(self, data, batch_size: int = 0) -> np.ndarray:
        self._check_fit()
        return self._trained.predict(self._coerce_x(data), batch_size)

    def optimize_predict(self, precision: str = "bf16"):
        raise ValueError("optimize_predict: nano's InferenceOptimizer is "
                         "not ported yet (ROADMAP A.6.10)")

    def predict_with_optimized(self, data):
        raise ValueError("predict_with_optimized: nano's InferenceOptimizer "
                         "is not ported yet (ROADMAP A.6.10)")

    def evaluate(self, data, metrics: Sequence[str] = ("mse",),
                 batch_size: int = 32) -> Dict[str, float]:
        self._check_fit()
        x, y = _as_xy(data)
        table = {"mse": MSE, "mae": MAE}
        methods = [table[m.lower()]() for m in metrics]
        res = self._trained.evaluate(DataSet.array(x, y), methods,
                                     batch_size)
        return {m: r.result for m, r in zip(metrics, res)}

    # ---- persistence --------------------------------------------------------
    def save(self, path: str) -> None:
        """The trained variables in the JAX package's format
        (``utils.serializer``), which either package loads."""
        from bigdl_tpu_torch.utils.serializer import save_model

        self._check_fit()
        save_model(path, self.model, self._trained.variables)

    def load(self, path: str) -> None:
        """Restore weights saved by ``save`` (by either package) into this
        forecaster, which must have the same hyperparameters."""
        from bigdl_tpu_torch.utils.serializer import load_model

        variables = load_model(path, self.model,
                               template=export_variables(self.model))
        self._trained = TrainedModel(self.model.to(self.device), self.device)
        self._trained.set_variables(variables)

    def _check_fit(self):
        if self._trained is None:
            raise RuntimeError("call fit() (or load()) first")


class TCNForecaster(BaseForecaster):
    """Reference ``chronos/forecaster/tcn_forecaster.py``."""

    def __init__(self, past_seq_len, future_seq_len, input_feature_num,
                 output_feature_num, num_channels=(32, 32), kernel_size=3,
                 dropout=0.1, **kw):
        self.num_channels = tuple(num_channels)
        self.kernel_size = kernel_size
        self.dropout = dropout
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kw)

    def _build_model(self):
        return TCN(self.in_dim, self.out_dim, self.horizon,
                   channels=self.num_channels, kernel_size=self.kernel_size,
                   dropout=self.dropout, generator=self.generator)


class LSTMForecaster(BaseForecaster):
    def __init__(self, past_seq_len, future_seq_len, input_feature_num,
                 output_feature_num, hidden_dim=64, layer_num=2,
                 dropout=0.1, **kw):
        self.hidden_dim, self.layer_num = hidden_dim, layer_num
        self.dropout = dropout
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kw)

    def _build_model(self):
        return LSTMForecastNet(self.in_dim, self.out_dim, self.horizon,
                               hidden=self.hidden_dim, layers=self.layer_num,
                               dropout=self.dropout, generator=self.generator)


class Seq2SeqForecaster(BaseForecaster):
    def __init__(self, past_seq_len, future_seq_len, input_feature_num,
                 output_feature_num, lstm_hidden_dim=64, **kw):
        self.hidden_dim = lstm_hidden_dim
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kw)

    def _build_model(self):
        return Seq2SeqNet(self.in_dim, self.out_dim, self.horizon,
                          hidden=self.hidden_dim, generator=self.generator)


class NBeatsForecaster(BaseForecaster):
    def __init__(self, past_seq_len, future_seq_len, input_feature_num,
                 output_feature_num, stacks=2, blocks_per_stack=3,
                 hidden_units=128, **kw):
        self.stacks, self.bps = stacks, blocks_per_stack
        self.units = hidden_units
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kw)

    def _build_model(self):
        return NBeats(self.in_dim, self.out_dim, self.lookback, self.horizon,
                      stacks=self.stacks, blocks_per_stack=self.bps,
                      units=self.units, generator=self.generator)


class AutoformerForecaster(BaseForecaster):
    def __init__(self, past_seq_len, future_seq_len, input_feature_num,
                 output_feature_num, d_model=64, n_heads=4, e_layers=2,
                 d_layers=1, d_ff=128, moving_avg=25, **kw):
        self.d_model, self.n_heads = d_model, n_heads
        self.e_layers, self.d_layers = e_layers, d_layers
        self.d_ff, self.moving_avg = d_ff, moving_avg
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, **kw)

    def _build_model(self):
        return Autoformer(self.in_dim, self.out_dim, self.lookback,
                          self.horizon, hidden=self.d_model,
                          heads=self.n_heads, enc_layers=self.e_layers,
                          dec_layers=self.d_layers, ff=self.d_ff,
                          kernel=self.moving_avg, generator=self.generator)
