"""Optimizer — the port of the single-device training loop of
``bigdl_tpu.optim.optimizer``.

The setters (``set_optim_method``, ``set_end_when``,
``set_initial_variables``, the two gradient-clipping setters) and
``optimize()``'s loop are the JAX ``Optimizer``'s: each epoch walks
``dataset.batches(batch_size, shuffle=True, seed=seed, epoch=epoch)``,
so the same (dataset, batch size, seed) trains on the same batches in
the same order with the same dropout masks (``TrainStep``'s keys), and
the triggers read the same state dict (``epoch``, ``iteration``,
``epoch_batch``, ``epoch_finished``, ``loss``).  Batches are copied to the device, never aliased.  Losses stay
on the device until the run ends, so the host runs ahead of the card.

Not ported: checkpoints, validation, summaries, retries, the cluster
hooks, profiling and step bundles (``steps_per_call``); the multi-device
ZeRO-1 step."""

import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.data.dataset import DataSet
from bigdl_tpu_torch.ops.common import resolve_device
from bigdl_tpu_torch.optim.optim_method import SGD, OptimMethod
from bigdl_tpu_torch.optim.train_step import GradientClipping, TrainStep
from bigdl_tpu_torch.optim.trigger import Trigger
from bigdl_tpu_torch.tensor.policy import apply_precision_policy
from bigdl_tpu_torch.utils.convert import export_params, load_jax_params


def _to_device(a, device: torch.device):
    """A host batch as a new tensor on ``device`` (never a view of the
    host buffer).  float64 becomes float32, as JAX without x64 does."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if device.type == "cuda":
        # a pinned copy, so the upload can overlap the running step
        return torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
    return torch.tensor(a, device=device)


class TrainedModel:
    """What ``optimize()`` returns: the trained module, its variables as
    a JAX-keyed params tree, and batched prediction."""

    def __init__(self, model: torch.nn.Module, device: torch.device):
        self.model = model
        self.device = device

    @property
    def variables(self) -> Dict[str, Any]:
        return {"params": export_params(self.model)}

    @torch.no_grad()
    def predict(self, x, batch_size: int = 0) -> np.ndarray:
        """The model's outputs for the host array ``x``, in batches of
        ``batch_size`` rows (all at once for 0)."""
        self.model.train(False)
        n = len(x)
        step = batch_size if batch_size > 0 else max(n, 1)
        return np.concatenate([
            self.model(_to_device(x[i:i + step], self.device)).cpu().numpy()
            for i in range(0, n, step)])


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
        self._initial_params: Optional[Dict[str, Any]] = None
        self._final_state: Optional[Dict[str, Any]] = None
        # the loss of every step of the last optimize(), in order
        self.losses: List[float] = []

    # ---- setters ----------------------------------------------------------
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        self.optim_method = method
        return self

    def set_initial_variables(self, variables: Dict[str, Any]
                              ) -> "Optimizer":
        """Start from a JAX-keyed variables tree (``{"params": ...}``, or
        the params tree itself), e.g. weights trained by the JAX package;
        copied in by ``utils.convert.load_jax_params``."""
        self._initial_params = variables.get("params", variables)
        return self

    def set_end_when(self, trigger: Trigger) -> "Optimizer":
        self.end_when = trigger
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
    def optimize(self) -> TrainedModel:
        if self.device.type == "cuda":
            apply_precision_policy()
        model = self.model.to(self.device)
        if self._initial_params is not None:
            load_jax_params(model, self._initial_params)
        step = TrainStep(model, self.criterion, self.optim_method,
                         clip=self.clip, seed=self.seed)
        state: Dict[str, Any] = {
            "epoch": 1, "iteration": 0, "epoch_batch": 0,
            "epoch_finished": False, "loss": float("nan"),
            "score": float("-inf"),
        }
        losses: List[torch.Tensor] = []
        try:
            while not self.end_when(state):
                state["epoch_finished"] = False
                state["epoch_batch"] = 0
                ran_any = False
                for mb in self.dataset.batches(
                        self.batch_size, shuffle=True, seed=self.seed,
                        epoch=state["epoch"]):
                    ran_any = True
                    loss = step(state["iteration"],
                                _to_device(mb["input"], self.device),
                                _to_device(mb["target"], self.device))
                    losses.append(loss)
                    state["loss"] = loss
                    state["iteration"] += 1
                    state["epoch_batch"] += 1
                    if self.end_when(state):
                        break
                else:
                    if not ran_any:
                        raise ValueError(
                            f"the dataset's {self.dataset.size()} rows "
                            f"give no batch of {self.batch_size}")
                    state["epoch_finished"] = True
                    state["epoch"] += 1
        finally:
            model.train(False)
        self.losses = (torch.stack(losses).cpu().tolist() if losses
                       else [])
        state["loss"] = self.losses[-1] if losses else math.nan
        self._final_state = dict(state)
        return TrainedModel(model, self.device)
