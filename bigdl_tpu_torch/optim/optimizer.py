"""Optimizer — the port of the single-device training loop of
``bigdl_tpu.optim.optimizer``.

The setters and ``optimize()``'s loop are the JAX ``Optimizer``'s: each
epoch walks ``dataset.batches(batch_size, shuffle=True, seed=seed,
epoch=epoch)``, so the same (dataset, batch size, seed) trains on the
same batches in the same order with the same dropout masks
(``TrainStep``'s keys), and the triggers read the same state dict
(``epoch``, ``iteration``, ``epoch_batch``, ``epoch_finished``, ``loss``,
``score``, ``n_validations``).  After every step the validation and
checkpoint triggers are asked, and once more at each epoch's end, each
firing at most once an iteration.  Batches are copied to the device,
never aliased.  Losses stay on the device until the run ends, so the
host runs ahead of the card; a validation or a checkpoint reads the
device at its own iteration only.

``set_checkpoint`` writes the single-writer format of
``optim.checkpoint``; ``optimize()`` first resumes from the newest
checkpoint under the path (parameters, optimizer slots, BatchNorm
buffers, EMA, the loop's state and a ``Plateau``'s state) and goes on
with the epoch's batch order from ``epoch_batch``.  The step's knobs
``accum_steps``, ``remat``, ``remat_policy``, ``ema_decay`` and
``trainable_mask`` are attributes, as on the JAX Optimizer.  A model with
lazy widths (``Linear(out)``, ``BatchNorm()``, ``PReLU()``) is built
from one sample row before its parameters are collected.

Not ported: summaries, the retry loop, the cluster hooks, preemption,
profiling and step bundles (``steps_per_call``); the multi-device ZeRO-1
step and sharded checkpoints."""

import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.nn.freeze import has_frozen, trainable_mask_for
from bigdl_tpu_torch.nn.layers import has_lazy
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.optim import checkpoint as ckpt
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.train_step import (GradientClipping, TrainStep,
                                              evaluate, to_device)
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.tensor.policy import apply_precision_policy
from bigdl_tpu_torch.utils.convert import export_variables, load_jax_variables


class TrainedModel:
    """What ``optimize()`` returns: the trained module, its variables as
    JAX-keyed ``{"params", "state"}`` trees, batched prediction and
    evaluation."""

    def __init__(self, model: torch.nn.Module, device: torch.device,
                 step: Optional[TrainStep] = None):
        self.model = model
        self.device = device
        self._step = step

    @property
    def variables(self) -> Dict[str, Any]:
        return export_variables(self.model)

    @property
    def ema_variables(self) -> Optional[Dict[str, Any]]:
        """The EMA weights (with the live BatchNorm state) when the run
        kept one (``ema_decay``), else None; evaluate them through
        ``set_variables(trained.ema_variables)``."""
        if self._step is None or self._step.ema is None:
            return None
        return self._step.get_variables(ema=True)

    def set_variables(self, variables: Dict[str, Any]) -> None:
        """Copy a ``{"params", "state"}`` tree into the model."""
        load_jax_variables(self.model, variables)

    @torch.no_grad()
    def predict(self, x, batch_size: int = 0) -> np.ndarray:
        """The model's outputs for the host array ``x``, in batches of
        ``batch_size`` rows (all at once for 0)."""
        self.model.train(False)
        n = len(x)
        step = batch_size if batch_size > 0 else max(n, 1)
        return np.concatenate([
            self.model(to_device(x[i:i + step], self.device)).cpu().numpy()
            for i in range(0, n, step)])

    def evaluate(self, dataset: DataSet,
                 methods: Sequence[ValidationMethod],
                 batch_size: int = 128) -> List[ValidationResult]:
        """Every method over ``dataset`` in order, every row once, in
        eval mode on the training device."""
        return evaluate(self.model, list(methods), dataset.batches(
            batch_size, shuffle=False, drop_last=False), self.device)


class Optimizer:
    """Sets up and runs one device's training.  ``device=None``
    is ``cuda``; without CUDA the caller must pass ``device="cpu"``."""

    def __init__(self, model: torch.nn.Module, dataset: DataSet, criterion,
                 batch_size: int = 32, seed: int = 42, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.batch_size = batch_size
        self.seed = seed
        self.optim_method: OptimMethod = SGD(learning_rate=1e-2)
        self.end_when: Trigger = Trigger.max_epoch(10)
        self.clip: Optional[GradientClipping] = None
        # the step's knobs (the JAX Optimizer's attributes)
        self.accum_steps = 1      # gradient-accumulation microbatches
        self.remat = False        # recompute activations in the backward
        self.remat_policy: Optional[str] = None   # None|'nothing'|'dots'
        self.ema_decay = 0.0      # weight EMA (0 = off)
        self.trainable_mask = None  # JAX-keyed bool tree over params
        self._initial_variables: Optional[Dict[str, Any]] = None
        self._ckpt_path: Optional[str] = None
        self._ckpt_trigger: Optional[Trigger] = None
        self._ckpt_async: Optional[ckpt.AsyncCheckpointer] = None
        self._val_trigger: Optional[Trigger] = None
        self._val_dataset: Optional[DataSet] = None
        self._val_methods: List[ValidationMethod] = []
        self._val_batch = batch_size
        self._last_val_iter = -1
        self._last_ckpt_iter = -1
        self._final_state: Optional[Dict[str, Any]] = None
        # the loss of every step of the last optimize(), in order
        self.losses: List[float] = []
        # (iteration, results) of every validation of the last optimize()
        self.validations: List[Tuple[int, List[ValidationResult]]] = []

    # ---- setters ----------------------------------------------------------
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_initial_variables(self, variables: Dict[str, Any]
                              ) -> "Optimizer":
        """Start from a JAX-keyed variables tree (``{"params", "state"}``,
        or the params tree itself), e.g. weights trained by the JAX
        package; copied in by ``utils.convert.load_jax_variables``."""
        self._initial_variables = (variables if "params" in variables
                                   else {"params": variables})
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       async_write: bool = False, sharded="auto",
                       mirror: Optional[str] = None) -> "Optimizer":
        """Checkpoint into the local directory ``path`` whenever
        ``trigger`` fires; ``async_write`` snapshots the tensors to the
        host at the trigger and writes on a background thread, one write
        in flight.  Sharded checkpoints and mirrors come with
        multi-device training (ROADMAP A.2)."""
        if sharded is True or mirror is not None:
            raise ValueError(
                "sharded checkpoints and mirrors need the multi-device "
                "port (ROADMAP A.2); this Optimizer writes the single-writer "
                "format")
        self._ckpt_path = path
        self._ckpt_trigger = trigger
        self._ckpt_async = ckpt.AsyncCheckpointer() if async_write else None
        return self

    def set_validation(self, trigger: Trigger, dataset: DataSet,
                       methods: Sequence[ValidationMethod],
                       batch_size: Optional[int] = None) -> "Optimizer":
        self._val_trigger = trigger
        self._val_dataset = dataset
        self._val_methods = list(methods)
        if batch_size:
            self._val_batch = batch_size
        return self

    def set_gradient_clipping_by_l2_norm(self, norm: float) -> "Optimizer":
        self.clip = self.clip or GradientClipping()
        self.clip.l2_norm = norm
        return self

    def set_constant_gradient_clipping(self, min_v: float, max_v: float
                                       ) -> "Optimizer":
        self.clip = self.clip or GradientClipping()
        self.clip.constant_min = min_v
        self.clip.constant_max = max_v
        return self

    @property
    def final_state(self) -> Optional[Dict[str, Any]]:
        """The loop's state at the end of the last ``optimize()``."""
        return self._final_state

    # ---- the training loop --------------------------------------------------
    def _prepare_model(self) -> torch.nn.Module:
        model = self.model.to(self.device)
        if has_lazy(model):
            sample = next(iter(self.dataset.batches(
                self.batch_size, shuffle=False)))["input"]
            with torch.no_grad():
                model.train(False)
                model(to_device(sample[:1], self.device))
        if self._initial_variables is not None:
            load_jax_variables(model, self._initial_variables)
        return model

    def optimize(self) -> TrainedModel:
        if self.device.type == "cuda":
            apply_precision_policy()
        model = self._prepare_model()
        mask = self.trainable_mask
        if mask is None and has_frozen(model):
            mask = trainable_mask_for(model)
        step = TrainStep(model, self.criterion, self.optim_method,
                         clip=self.clip, seed=self.seed,
                         accum_steps=self.accum_steps,
                         ema_decay=self.ema_decay, remat=self.remat,
                         remat_policy=self.remat_policy,
                         trainable_mask=mask)
        state: Dict[str, Any] = {
            "epoch": 1, "iteration": 0, "epoch_batch": 0,
            "epoch_finished": False, "loss": float("nan"),
            "score": float("-inf"),
        }
        self._last_val_iter = self._last_ckpt_iter = -1
        self.validations = []
        if self._ckpt_path:
            self._try_resume(step, state)
        losses: List[torch.Tensor] = []
        try:
            self._loop(step, state, losses)
            if self._ckpt_async is not None:
                self._ckpt_async.wait()
        finally:
            model.train(False)
        self.losses = (torch.stack(losses).cpu().tolist() if losses
                       else [])
        if losses:
            state["loss"] = self.losses[-1]
        self._final_state = dict(state)
        return TrainedModel(model, self.device, step)

    def _loop(self, step: TrainStep, state, losses) -> None:
        while not self.end_when(state):
            state["epoch_finished"] = False
            skip = int(state.pop("_resume_skip", 0) or 0)
            state["epoch_batch"] = skip
            ran_any = False
            batches = self.dataset.batches(
                self.batch_size, shuffle=True, seed=self.seed,
                epoch=state["epoch"])
            for mb in itertools.islice(batches, skip, None):
                ran_any = True
                loss = step(state["iteration"],
                            to_device(mb["input"], self.device),
                            to_device(mb["target"], self.device))
                losses.append(loss)
                state["loss"] = loss
                state["iteration"] += 1
                state["epoch_batch"] += 1
                self._fire_triggers(step, state)
                if self.end_when(state):
                    break
            else:
                if not ran_any and skip == 0:
                    raise ValueError(
                        f"the dataset's {self.dataset.size()} rows "
                        f"give no batch of {self.batch_size}")
                # a resume whose skip used up the epoch already fired
                # this boundary's triggers before it was written
                if ran_any or skip == 0:
                    state["epoch_finished"] = True
                    self._fire_triggers(step, state)
                state["epoch"] += 1

    def _fire_triggers(self, step: TrainStep, state) -> None:
        it = state["iteration"]
        if (self._val_trigger is not None and self._val_trigger(state)
                and self._last_val_iter != it):
            self._last_val_iter = it
            self._run_validation(step, state)
        if (self._ckpt_trigger is not None and self._ckpt_trigger(state)
                and self._last_ckpt_iter != it):
            self._last_ckpt_iter = it
            self._save_checkpoint(step, state)

    def _run_validation(self, step: TrainStep, state) -> None:
        results = evaluate(step.model, self._val_methods,
                           self._val_dataset.batches(
                               self._val_batch, shuffle=False,
                               drop_last=False), self.device)
        self.validations.append((state["iteration"], results))
        if not results:
            return
        state["score"] = results[0].result
        state["n_validations"] = state.get("n_validations", 0) + 1
        schedule = getattr(self.optim_method, "schedule", None)
        if schedule is not None and hasattr(schedule, "on_score"):
            monitor = getattr(schedule, "monitor", None)
            picked = results[0]
            if monitor is not None:
                matches = [r for r in results if r.name == monitor]
                if not matches:
                    raise ValueError(
                        f"Plateau monitor {monitor!r} not among the "
                        f"validation methods {[r.name for r in results]}")
                picked = matches[0]
            # the next step's learning rate reads the new factor
            schedule.on_score(float(picked.result))

    def _save_checkpoint(self, step: TrainStep, state) -> None:
        state["loss"] = float(state["loss"])
        snapshot = dict(state)
        schedule = getattr(self.optim_method, "schedule", None)
        if schedule is not None and hasattr(schedule, "state_dict"):
            snapshot["schedule_state"] = schedule.state_dict()
        kw = dict(step.checkpoint_arrays(), driver_state=snapshot)
        if self._ckpt_async is not None:
            self._ckpt_async.submit(self._ckpt_path, state["iteration"],
                                    **kw)
        else:
            ckpt.save_checkpoint(self._ckpt_path, state["iteration"], **kw)

    def _try_resume(self, step: TrainStep, state) -> None:
        """Restore the newest checkpoint under the path, if any, and
        skip the batches of its epoch that it had already trained."""
        latest = ckpt.latest_checkpoint(self._ckpt_path)
        if latest is None:
            return
        flat, opt_state, model_state, saved, ema = ckpt.load_checkpoint(
            latest)
        step.restore(flat, opt_state, model_state, ema)
        state.update(saved)
        sched_state = state.pop("schedule_state", None)
        schedule = getattr(self.optim_method, "schedule", None)
        if sched_state is not None and schedule is not None \
                and hasattr(schedule, "load_state_dict"):
            schedule.load_state_dict(sched_state)
        state["epoch_finished"] = False
        it = int(saved.get("iteration", 0) or 0)
        self._last_ckpt_iter = min(self._last_ckpt_iter, it)
        self._last_val_iter = min(self._last_val_iter, it)
        state["epoch_batch"] = int(saved.get("epoch_batch", 0) or 0)
        state["_resume_skip"] = state["epoch_batch"]
