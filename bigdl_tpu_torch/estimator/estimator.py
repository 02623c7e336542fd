"""The Orca-style Estimator — the port of
``bigdl_tpu.estimator.estimator``.

Creators are plain callables evaluated in this process; ``fit`` is one
run of the port's ``Optimizer`` on ``device`` (None is ``cuda``), alone
or as one rank of the engine's process group (``init_context
("multihost")`` joins it over ``torch.distributed`` and the step is the
ZeRO-1 ``ShardedParameterStep``).  ``from_torch`` converts a stock
``torch.nn.Module`` once (``utils.torch_convert``: its fx graph
re-emitted as the port's keras ``Model``, NHWC, weights carried over),
so torch's own module never runs on the training path; ``state_dict()``
exports the trained weights back under the module's names.

A declarative layout (``parallelism`` in the config, else the engine's
``EngineConfig.parallelism``, which ``BIGDL_TPU_PARALLELISM`` sets)
trains through ``parallel.gspmd.fit_layout`` on every rank of the world
(``_fit_layout``), with the JAX package's refusals.

Not ported, each refused with a ``ValueError`` naming its ROADMAP item:
``fault_tolerance`` (the supervisor: A.6.9), ``slo_specs`` (A.6.7), and
stock tf.keras models in ``from_keras`` with ``export_to_keras``
(``keras_convert``: A.6.11)."""

import inspect
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.data.shards import XShards, _process_index_count
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import Loss, ValidationMethod
from bigdl_tpu_torch.runtime.engine import Engine, EngineConfig, init_engine
from bigdl_tpu_torch.utils.convert import load_jax_variables


def init_context(cluster_mode: str = "local",
                 coordinator_address: Optional[str] = None,
                 num_processes: Optional[int] = None,
                 process_id: Optional[int] = None, device=None,
                 **mesh_axes) -> Engine:
    """``init_orca_context``: ``"local"`` runs one process;
    ``"multihost"`` joins ``num_processes`` processes over
    ``torch.distributed`` as ``process_id`` (``coordinator_address``, or
    ``BIGDL_TPU_COORDINATOR`` and its siblings), NCCL on the card and
    gloo with ``device="cpu"``."""
    cfg = EngineConfig.from_env()
    if cluster_mode == "multihost":
        if coordinator_address is not None:
            cfg.coordinator_address = coordinator_address
            cfg.num_processes = num_processes
            cfg.process_id = process_id
        if cfg.coordinator_address is None:
            raise ValueError(
                "multihost mode needs coordinator_address (or "
                "BIGDL_TPU_COORDINATOR env)")
    elif cluster_mode != "local":
        raise ValueError(f"unknown cluster_mode {cluster_mode!r}; "
                         "use 'local' or 'multihost'")
    return init_engine(cfg, device=device, **mesh_axes)


def stop_context() -> None:
    Engine.reset()


def _to_xy(data):
    """fit / evaluate inputs as a ``DataSet``: an ``(x, y)`` tuple, a
    dict ``{"x", "y"}``, XShards of either, a DataSet, or a creator
    (called with no argument) of any of these."""
    if isinstance(data, DataSet):
        return data
    if callable(data) and not isinstance(data, (tuple, dict, XShards)):
        data = data()
    if isinstance(data, XShards):
        data = (data.owned_concat() if _process_index_count()[1] > 1
                else data.concat())
    if isinstance(data, dict):
        data = (data["x"], data["y"])
    if isinstance(data, (tuple, list)):
        x, y = data
        if isinstance(x, (tuple, list)):
            x = tuple(np.asarray(a) for a in x)
        else:
            x = np.asarray(x)
        return DataSet.array(x, np.asarray(y))
    raise TypeError(f"unsupported data type {type(data)}")


def _refuse_tf_keras(what: str):
    raise ValueError(f"{what}: stock tf.keras models need "
                     "utils.keras_convert, not ported yet (ROADMAP A.6.11)")


class Estimator:
    """``Estimator.from_module(...)``: the fit / evaluate / predict
    driver on ``device`` (None is ``cuda``)."""

    def __init__(self, model_creator: Callable[[Dict], Any],
                 optimizer_creator: Callable[[Dict], OptimMethod],
                 loss_creator: Callable[[Dict], Any],
                 config: Optional[Dict] = None, backend: str = "jax_tpu",
                 device=None):
        self._setup(config, backend, device)
        self.model = model_creator(self.config)
        self.optim_method = optimizer_creator(self.config)
        self.criterion = loss_creator(self.config)

    def _setup(self, config, backend, device) -> None:
        if backend != "jax_tpu":
            raise ValueError(
                f"backend {backend!r} not supported: one backend, "
                "'jax_tpu', the JAX package's name for it (every "
                "reference backend reduces to sync data-parallel)")
        self.config = dict(config or {})
        self.device = resolve_device(device)
        self._trained: Optional[TrainedModel] = None
        self._loaded_variables: Optional[Dict[str, Any]] = None
        self._initial_variables: Optional[Dict[str, Any]] = None
        self._loaded: Optional[TrainedModel] = None
        self._last_stats: Dict[str, Any] = {}

    # ---- constructors -------------------------------------------------------
    @staticmethod
    def from_module(model_creator, optimizer_creator, loss_creator,
                    config=None, backend="jax_tpu",
                    device=None) -> "Estimator":
        return Estimator(model_creator, optimizer_creator, loss_creator,
                         config, backend, device)

    @staticmethod
    def from_torch(model_creator, optimizer_creator, loss_creator,
                   config=None, backend="jax_tpu", example_input=None,
                   device=None) -> "Estimator":
        """Train a stock ``torch.nn.Module``: ``model_creator(config)`` is
        converted once (``utils.torch_convert.from_torch_module``; the
        model then takes channels-last inputs), ``optimizer_creator(model,
        config)`` returns a ``torch.optim.Optimizer`` whose
        hyperparameters map to the port's method (or ``(config)`` returns
        an ``OptimMethod``), ``loss_creator(config)`` a torch loss (mapped)
        or a criterion.  ``example_input`` (numpy, torch layout) drives
        the shape propagation.  The stock module stays on the CPU
        (``_torch_model``); the converted model trains on ``device``."""
        from bigdl_tpu_torch.utils.torch_convert import (
            convert_torch_loss, convert_torch_optimizer, from_torch_module)

        est = Estimator.__new__(Estimator)
        est._setup(config, backend, device)
        tmodel = model_creator(est.config)
        model, variables = from_torch_module(tmodel, example_input)
        n_args = len(inspect.signature(optimizer_creator).parameters)
        topt = (optimizer_creator(tmodel, est.config) if n_args >= 2
                else optimizer_creator(est.config))
        est.model = model
        est.optim_method = convert_torch_optimizer(topt)
        est.criterion = convert_torch_loss(loss_creator(est.config))
        est._loaded_variables = variables   # predict / evaluate before fit
        est._initial_variables = variables
        est._torch_model = tmodel
        return est

    @staticmethod
    def from_keras(model_creator, config=None, backend="jax_tpu",
                   device=None) -> "Estimator":
        """Train a compiled keras model of the port (``keras.Model.
        compile``): its optimizer and loss drive the fit."""
        est = Estimator.__new__(Estimator)
        est._setup(config, backend, device)
        model = model_creator(est.config)
        mod = type(model).__module__
        if mod.split(".")[0] in ("keras", "tf_keras") or "tensorflow" in mod:
            _refuse_tf_keras("from_keras of a stock tf.keras model")
        compiled = getattr(model, "_compiled", None)
        if compiled is None:
            raise ValueError("from_keras: creator must return a compiled model")
        est.model = model
        est.optim_method = compiled["optimizer"]
        est.criterion = compiled["loss"]
        return est

    def export_to_keras(self):
        _refuse_tf_keras("export_to_keras")

    # ---- training -----------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            validation_data=None,
            validation_methods: Sequence[ValidationMethod] = (),
            checkpoint_path: Optional[str] = None,
            checkpoint_trigger: Optional[Trigger] = None,
            fault_tolerance=False,
            profile_dir: Optional[str] = None) -> Dict[str, Any]:
        """One ``Optimizer`` run of ``epochs`` epochs.  The config's
        ``host_prefetch``, ``streaming``, ``steps_per_call`` (an int or
        ``"auto"``), ``grad_comm`` and ``comm_bucket_bytes`` set the
        Optimizer's attributes of those names; ``profile_dir`` traces a
        window of iterations.  A ``from_torch`` estimator starts every fit
        from the converted weights.  Returns the stats (``train_time_s``,
        ``epochs``, ``num_samples``, and ``recoveries_total`` with
        ``time_lost_to_recovery_s`` when the in-run retry recovered)."""
        ds = _to_xy(data)
        par = self.config.get("parallelism")
        if par is None:
            par = Engine.get().config.parallelism
        if par is not None:
            # what the layout path does not carry fails loudly (a
            # fleet-wide BIGDL_TPU_PARALLELISM must not drop a job's
            # requested resilience)
            unsupported = [n for n, v in (
                ("fault_tolerance", fault_tolerance),
                ("checkpoint_trigger", checkpoint_trigger),
                ("profile_dir", profile_dir)) if v]
            if unsupported:
                raise ValueError(
                    f"parallelism={par!r} (declarative GSPMD fit) does "
                    f"not support {', '.join(unsupported)} yet — drop "
                    "them or unset parallelism to use the classic "
                    "ZeRO-1 driver (docs/parallelism.md §Declarative "
                    "layouts)")
            return self._fit_layout(ds, str(par), epochs, batch_size,
                                    validation_data, validation_methods,
                                    checkpoint_path)
        if fault_tolerance:
            raise ValueError("fit(fault_tolerance=...): the Supervisor is "
                             "not ported yet (ROADMAP A.6.9)")
        if "slo_specs" in self.config:
            raise ValueError("config['slo_specs']: SLO evaluation is not "
                             "ported yet (ROADMAP A.6.7)")
        opt = Optimizer(self.model, ds, self.criterion,
                        batch_size=batch_size, device=self.device)
        if "host_prefetch" in self.config:
            opt.host_prefetch = int(self.config["host_prefetch"])
        if "streaming" in self.config:
            opt.streaming = bool(self.config["streaming"])
        if "steps_per_call" in self.config:
            spc = self.config["steps_per_call"]
            opt.steps_per_call = spc if spc == "auto" else int(spc)
        if "grad_comm" in self.config:
            opt.grad_comm = str(self.config["grad_comm"])
        if "comm_bucket_bytes" in self.config:
            opt.comm_bucket_bytes = int(self.config["comm_bucket_bytes"])
        if profile_dir is not None:
            opt.set_profile(profile_dir)
        if self._initial_variables is not None:
            opt.set_initial_variables(self._initial_variables)
        opt.set_optim_method(self.optim_method)
        opt.set_end_when(Trigger.max_epoch(epochs))
        if validation_data is not None:
            vds = _to_xy(validation_data)
            methods = list(validation_methods) or [Loss(self.criterion)]
            opt.set_validation(Trigger.every_epoch(), vds, methods)
        if checkpoint_path is not None:
            opt.set_checkpoint(checkpoint_path,
                               checkpoint_trigger or Trigger.every_epoch())
        t0 = time.time()
        self._trained = opt.optimize()
        self._loaded = None
        self._last_stats = {"train_time_s": time.time() - t0,
                            "epochs": epochs, "num_samples": ds.size()}
        recov = opt.metrics.counter("recoveries_total")
        if recov:
            self._last_stats["recoveries_total"] = recov
            self._last_stats["time_lost_to_recovery_s"] = \
                opt.metrics.counter("time_lost_to_recovery_s")
        return self._last_stats

    def _fit_layout(self, ds, parallelism: str, epochs: int,
                    batch_size: int, validation_data, validation_methods,
                    checkpoint_path: Optional[str]) -> Dict[str, Any]:
        """The declarative layout fit (``fit_layout``) from the model's
        weights (a ``from_torch`` estimator's converted ones); the same
        seed gives every policy the same data order.  With
        ``checkpoint_path`` rank 0 saves the final weights; with
        ``validation_data`` one validation at the end."""
        from bigdl_tpu_torch.parallel.gspmd import fit_layout

        if self._initial_variables is not None:
            load_jax_variables(self.model.to(self.device),
                               self._initial_variables)
        self._trained, stats = fit_layout(
            self.model, self.criterion, self.optim_method, ds,
            parallelism=parallelism, batch_size=batch_size,
            epochs=epochs, seed=int(self.config.get("seed", 42)),
            log_every=int(self.config.get("log_every", 10)),
            device=self.device)
        self._loaded = None
        if checkpoint_path is not None:
            from bigdl_tpu_torch.utils.serializer import save_model

            variables = self._trained.variables     # every rank gathers
            if _process_index_count()[0] == 0:
                save_model(checkpoint_path, self.model, variables)
        if validation_data is not None:
            vds = _to_xy(validation_data)
            methods = list(validation_methods) or [Loss(self.criterion)]
            res = self._trained.evaluate(vds, methods, batch_size)
            stats["validation"] = {r.name: r.result for r in res}
        losses = stats.pop("losses", None) or []
        if losses:
            stats["first_loss"] = losses[0]
            stats["final_loss"] = losses[-1]
        self._last_stats = stats
        return stats

    # ---- inference ----------------------------------------------------------
    def _model(self) -> TrainedModel:
        """The trained model, else the loaded weights in ``self.model``
        on the device (no train step)."""
        if self._trained is not None:
            return self._trained
        if self._loaded_variables is None:
            raise RuntimeError("call fit() or load() first")
        if self._loaded is None:
            load_jax_variables(self.model.to(self.device),
                               self._loaded_variables)
            self._loaded = TrainedModel(self.model, self.device)
        return self._loaded

    def _predict_array(self, x, batch_size: int):
        return self._model().predict(x, batch_size)

    def predict(self, data, batch_size: int = 0):
        if isinstance(data, XShards):
            return data.transform_shard(
                lambda s: self._predict_array(
                    np.asarray(s if not isinstance(s, dict) else s["x"]),
                    batch_size))
        if isinstance(data, (tuple, list)) and all(
                isinstance(a, np.ndarray) or hasattr(a, "shape")
                for a in data):   # a multi-input pack
            return self._predict_array(
                tuple(np.asarray(a) for a in data), batch_size)
        return self._predict_array(np.asarray(data), batch_size)

    def evaluate(self, data, methods: Sequence[ValidationMethod],
                 batch_size: int = 32) -> Dict[str, float]:
        ds = _to_xy(data)
        res = self._model().evaluate(ds, list(methods), batch_size)
        return {r.name: r.result for r in res}

    def state_dict(self):
        """For a ``from_torch`` estimator: the weights as a torch
        ``state_dict`` (CPU tensors, the original module's keys)."""
        from bigdl_tpu_torch.utils.torch_convert import export_state_dict

        return export_state_dict(self.model, self.get_model())

    # ---- model access -------------------------------------------------------
    def get_model(self):
        if self._trained is not None:
            return self._trained.variables
        if self._loaded_variables is not None:
            return self._loaded_variables
        raise RuntimeError("call fit() or load() first")

    def save(self, path: str) -> None:
        from bigdl_tpu_torch.utils.serializer import save_model

        save_model(path, self.model, self.get_model())

    def load(self, path: str) -> None:
        """Load weights saved by ``save`` (by either package): predict
        and evaluate then run without a fit."""
        from bigdl_tpu_torch.utils.serializer import load_model

        self._loaded_variables = load_model(path)
        self._trained = None
        self._loaded = None
