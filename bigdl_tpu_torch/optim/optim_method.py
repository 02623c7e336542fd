"""Optimization methods — the port of ``SGD`` and ``Adam`` from
``bigdl_tpu.optim.optim_method``.

The JAX methods are pure: ``update(step, grads, params, state)`` returns
new params and a new state.  Here ``update`` runs under
``torch.no_grad()`` and changes the parameters and the state tensors IN
PLACE, which keeps one copy of each on the device; it returns nothing.
``params`` and ``grads`` are equal-length lists of tensors and the state
holds one list per slot (Adam's ``m`` and ``v``).  ``step`` is the
0-based iteration, as ``Optimizer`` passes it: Adam's bias correction uses
``t = step + 1``, as in the JAX package."""

from typing import Dict, List, Optional

import torch

from bigdl_tpu_torch.optim.schedules import Default, LearningRateSchedule

State = Dict[str, List[torch.Tensor]]


class OptimMethod:
    def init_state(self, params: List[torch.Tensor]) -> State:
        return {}

    def update(self, step: int, grads: List[torch.Tensor],
               params: List[torch.Tensor], state: State) -> None:
        raise NotImplementedError

    def get_learning_rate(self, step: int) -> float:
        return getattr(self, "lr", 0.0)


class SGD(OptimMethod):
    """SGD with momentum, dampening, Nesterov and weight decay, and a
    pluggable learning-rate schedule."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0,
                 weight_decay: float = 0.0, momentum: float = 0.0,
                 dampening: Optional[float] = None, nesterov: bool = False,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.dampening = momentum if dampening is None else dampening
        self.nesterov = nesterov
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)
        if nesterov and (momentum <= 0 or self.dampening != 0):
            self.dampening = 0.0

    def get_learning_rate(self, step):
        return self.schedule(self.lr, step)

    def init_state(self, params):
        if self.momentum > 0:
            return {"velocity": [torch.zeros_like(p) for p in params]}
        return {}

    @torch.no_grad()
    def update(self, step, grads, params, state):
        lr = self.schedule(self.lr, step)
        for i, (g, p) in enumerate(zip(grads, params)):
            if self.weight_decay > 0:
                g = g + self.weight_decay * p
            if self.momentum > 0:
                vel = state["velocity"][i]
                vel.mul_(self.momentum).add_(g, alpha=1 - self.dampening)
                g = g + self.momentum * vel if self.nesterov else vel
            p.sub_(lr * g)


class Adam(OptimMethod):
    """Adam with bias correction; ``m`` and ``v`` live beside the
    parameters on their device."""

    def __init__(self, learning_rate: float = 1e-3,
                 learning_rate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 learning_rate_schedule: Optional[
                     LearningRateSchedule] = None):
        self.lr = learning_rate
        self.beta1, self.beta2, self.eps = beta1, beta2, epsilon
        self.schedule = learning_rate_schedule or Default(learning_rate_decay)

    def get_learning_rate(self, step):
        return self.schedule(self.lr, step)

    def init_state(self, params):
        return {"m": [torch.zeros_like(p) for p in params],
                "v": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, step, grads, params, state):
        lr = self.schedule(self.lr, step)
        t = step + 1
        bc1 = 1 - self.beta1 ** t
        bc2 = 1 - self.beta2 ** t
        for g, p, m, v in zip(grads, params, state["m"], state["v"]):
            m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
            v.mul_(self.beta2).addcmul_(g, g, value=1 - self.beta2)
            p.sub_(lr * (m / bc1) / ((v / bc2).sqrt_().add_(self.eps)))
