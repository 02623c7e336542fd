"""compile/fit plumbing — the port of ``bigdl_tpu.keras.training``: the
keras strings of ``compile`` resolved to the port's optim methods,
criteria and validation methods, and ``fit`` as one run of the port's
``Optimizer`` with the JAX package's triggers, validation and
checkpoints, or, with ``parallelism=``, one run of the declarative
layout driver (``parallel.gspmd.fit_layout``) on every rank of the
world.

Sequence-parallel fit (``seq_parallel=True``) is not ported: it raises,
naming its ROADMAP item."""

import logging
from typing import Any, Dict, Sequence

import numpy as np

from bigdl_tpu_torch.data.dataset import ArrayDataSet
from bigdl_tpu_torch.nn import criterion as crit_mod
from bigdl_tpu_torch.nn import criterion_extra as _ce
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.optim import optim_method as _om
from bigdl_tpu_torch.optim import validation as _vm
from bigdl_tpu_torch.optim.optimizer import Optimizer, TrainedModel
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.utils.convert import load_keras_variables

log = logging.getLogger("bigdl_tpu_torch.keras")

_OPTIMIZERS = {
    "sgd": lambda: _om.SGD(learning_rate=1e-2),
    "adam": lambda: _om.Adam(learning_rate=1e-3),
    "rmsprop": lambda: _om.RMSprop(learning_rate=1e-3),
    "adagrad": lambda: _om.Adagrad(learning_rate=1e-2),
    "adadelta": lambda: _om.Adadelta(),
    "adamax": lambda: _om.Adamax(learning_rate=2e-3),
}


def _signed(t):
    """keras hinge takes 0/1 labels; MarginCriterion wants ±1."""
    return 2.0 * (t > 0) - 1.0


_LOSSES = {
    "categorical_crossentropy": crit_mod.CrossEntropyCriterion,
    "sparse_categorical_crossentropy": crit_mod.CrossEntropyCriterion,
    "mse": crit_mod.MSECriterion,
    "mean_squared_error": crit_mod.MSECriterion,
    "mae": crit_mod.AbsCriterion,
    "mean_absolute_error": crit_mod.AbsCriterion,
    "binary_crossentropy": crit_mod.BCECriterion,
    "nll": crit_mod.ClassNLLCriterion,
    "kld": _ce.KullbackLeiblerDivergenceCriterion,
    "kullback_leibler_divergence": _ce.KullbackLeiblerDivergenceCriterion,
    "mape": _ce.MeanAbsolutePercentageCriterion,
    "mean_absolute_percentage_error": _ce.MeanAbsolutePercentageCriterion,
    "msle": _ce.MeanSquaredLogarithmicCriterion,
    "mean_squared_logarithmic_error": _ce.MeanSquaredLogarithmicCriterion,
    "hinge": lambda: _ce.TransformerCriterion(
        _ce.MarginCriterion(), target_transform=_signed),
    "squared_hinge": lambda: _ce.TransformerCriterion(
        _ce.MarginCriterion(squared=True), target_transform=_signed),
    "poisson": _ce.PoissonCriterion,
    "cosine_proximity": _ce.CosineProximityCriterion,
}

_METRICS = {
    "accuracy": _vm.Top1Accuracy,
    "acc": _vm.Top1Accuracy,
    "top1": _vm.Top1Accuracy,
    "top5": _vm.Top5Accuracy,
    "mae": _vm.MAE,
    "loss": _vm.Loss,
    "auc": _vm.AUC,
    "hitratio": _vm.HitRatio,
    "ndcg": _vm.NDCG,
}


def resolve_compile(optimizer, loss, metrics: Sequence) -> Dict[str, Any]:
    """``compile``'s arguments with every string resolved; the metric
    ``"loss"`` is the compiled loss, not a default one."""
    if isinstance(optimizer, str):
        optimizer = _OPTIMIZERS[optimizer.lower()]()
    if isinstance(loss, str):
        loss = _LOSSES[loss.lower()]()
    resolved = []
    for m in metrics:
        if not isinstance(m, str):
            resolved.append(m)
        elif m.lower() == "loss":
            resolved.append(_vm.Loss(loss))
        else:
            resolved.append(_METRICS[m.lower()]())
    return {"optimizer": optimizer, "loss": loss, "metrics": resolved}


def _dataset(pack, x, y, what: str, n_inputs: int) -> ArrayDataSet:
    if isinstance(x, ArrayDataSet):
        return x
    px = pack(x)
    if isinstance(px, tuple) and y is None:
        raise ValueError(f"multi-input model ({n_inputs} inputs) requires "
                         f"labels y{what}")
    return ArrayDataSet(px, None if y is None else np.asarray(y))


def fit_module(model, compiled: Dict[str, Any], x, y=None, batch_size=32,
               nb_epoch=10, validation_data=None, checkpoint_path=None,
               log_every=10, end_trigger=None, seq_parallel=False,
               parallelism=None, device=None) -> TrainedModel:
    """Train ``model`` with the compiled optimizer and loss through one
    ``Optimizer`` run: ``nb_epoch`` epochs (or ``end_trigger``), a
    validation with the compiled metrics (else the loss) and a checkpoint
    at every epoch's end.  ``device=None`` is ``cuda``.  ``log_every`` is
    the layout driver's log period; the port's ``Optimizer`` reports
    every step in its metrics.

    ``parallelism=`` (``"dp"``, ``"fsdp:2,tp:2"``, ...) trains through
    ``fit_layout`` over the world's ranks, then validates once; it keeps
    the JAX package's refusals (``seq_parallel``, ``checkpoint_path``,
    ``end_trigger``)."""
    n_inputs = len(getattr(model, "inputs", ()) or ())
    # one packing rule for fit, predict and evaluate: Model._pack_inputs
    pack = getattr(model, "_pack_inputs", np.asarray)
    if parallelism is not None:
        if seq_parallel:
            raise ValueError(
                "parallelism= and seq_parallel= are exclusive: express "
                "sequence sharding as a layout axis ('dp:2,seq:4')")
        unsupported = [n for n, v in (
            ("checkpoint_path", checkpoint_path),
            ("end_trigger", end_trigger)) if v]
        if unsupported:
            raise ValueError(
                f"parallelism={parallelism!r} (declarative GSPMD fit) "
                f"does not support {', '.join(unsupported)} yet — drop "
                "them or unset parallelism for the classic driver "
                "(docs/parallelism.md §Declarative layouts)")
        from bigdl_tpu_torch.parallel.gspmd import fit_layout

        trained, _ = fit_layout(
            model, compiled["loss"], compiled["optimizer"],
            _dataset(pack, x, y, "", n_inputs),
            parallelism=str(parallelism), batch_size=batch_size,
            epochs=nb_epoch, log_every=log_every, device=device)
        if validation_data is not None:
            if isinstance(validation_data, ArrayDataSet):
                vds = validation_data
            else:
                vx, vy = validation_data
                vds = ArrayDataSet(pack(vx), np.asarray(vy))
            methods = compiled["metrics"] or [_vm.Loss(compiled["loss"])]
            res = trained.evaluate(vds, methods, batch_size=batch_size)
            log.info("[layout %s] validation: %s", parallelism,
                     {r.name: r.result for r in res})
        return trained
    if seq_parallel:
        raise ValueError("fit(seq_parallel=True): sequence parallelism is "
                         "not ported yet (ROADMAP A.4)")
    ds = _dataset(pack, x, y, "", n_inputs)
    opt = Optimizer(model, ds, compiled["loss"], batch_size=batch_size,
                    device=device)
    opt.set_optim_method(compiled["optimizer"])
    opt.set_end_when(end_trigger or Trigger.max_epoch(nb_epoch))
    if validation_data is not None:
        if isinstance(validation_data, ArrayDataSet):
            vds = validation_data
        else:
            vx, vy = validation_data
            vds = ArrayDataSet(pack(vx), np.asarray(vy))
        methods = compiled["metrics"] or [_vm.Loss(compiled["loss"])]
        opt.set_validation(Trigger.every_epoch(), vds, methods,
                           batch_size=batch_size)
    if checkpoint_path:
        opt.set_checkpoint(checkpoint_path, Trigger.every_epoch())
    return opt.optimize()


def make_trained(model, variables, device=None) -> TrainedModel:
    """A ``TrainedModel`` of ``model`` holding ``variables`` (a keras
    model's node-keyed ``{"params", "state"}``), on ``device`` (None is
    ``cuda``), for predict and evaluate without fit."""
    dev = resolve_device(device)
    load_keras_variables(model.to(dev), variables)
    return TrainedModel(model, dev)
