"""The train step — the single-device case of
``bigdl_tpu.optim.train_step.ShardedParameterStep``.

One step is the forward in training mode, the criterion, autograd's
backward, optional gradient clipping (constant, then global L2 norm, as
the JAX step clips), and the optimizer's in-place update.  With one rank
the JAX step's reduce-scatter / all-gather cycle is the identity, so
nothing of it is here; gradient accumulation, EMA, rematerialisation,
trainable masks and step bundles are not ported and not accepted.

Dropout is seeded as the JAX driver seeds it: the run's key is
``PRNGKey(seed + 1)``, step ``i`` draws from ``fold_in(key, i)`` and the
one data replica from ``fold_in(step_key, 0)`` — the key the JAX step
hands to the forward of its replica 0."""

from dataclasses import dataclass
from typing import List, Optional

import torch

from bigdl_tpu_torch.nn.layers import Dropout
from bigdl_tpu_torch.optim.optim_method import OptimMethod
from bigdl_tpu_torch.utils import prng


@dataclass
class GradientClipping:
    """Constant clipping to [constant_min, constant_max] (either may be
    None) and clipping of the global L2 norm to ``l2_norm``."""

    constant_min: Optional[float] = None
    constant_max: Optional[float] = None
    l2_norm: Optional[float] = None


@torch.no_grad()
def clip_gradients(grads: List[torch.Tensor],
                   clip: GradientClipping) -> None:
    """Clip ``grads`` in place: constant first, then the global norm
    scaled by min(1, l2_norm / (norm + 1e-12))."""
    if clip.constant_min is not None or clip.constant_max is not None:
        for g in grads:
            g.clamp_(clip.constant_min, clip.constant_max)
    if clip.l2_norm is not None:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.clamp(clip.l2_norm / (norm + 1e-12), max=1.0)
        for g in grads:
            g.mul_(scale)


class TrainStep:
    """Trains ``model``'s parameters in place.  ``step(it, x, y)`` runs
    iteration ``it`` (0-based) on a batch already on the model's device
    and returns the loss as a 0-d tensor on that device (reading it
    waits for the step).  A model with active dropout gets the step's
    key, derived from ``seed``, as ``model(x, key=key)``."""

    def __init__(self, model: torch.nn.Module, criterion,
                 optim_method: OptimMethod,
                 clip: Optional[GradientClipping] = None, seed: int = 42):
        self.model = model
        self.criterion = criterion
        self.optim_method = optim_method
        self.clip = clip
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt_state = optim_method.init_state(self.params)
        self._base_key = None
        if any(isinstance(m, Dropout) and m.p > 0.0
               for m in model.modules()):
            self._base_key = prng.PRNGKey(
                seed + 1, device=next(model.parameters()).device)

    def step_key(self, step: int) -> Optional[torch.Tensor]:
        """Replica 0's dropout key of iteration ``step`` (None when the
        model drops nothing)."""
        if self._base_key is None:
            return None
        return prng.fold_in(prng.fold_in(self._base_key, step), 0)

    def __call__(self, step: int, x, y) -> torch.Tensor:
        self.model.train(True)
        for p in self.params:
            p.grad = None
        key = self.step_key(step)
        out = self.model(x) if key is None else self.model(x, key=key)
        loss = self.criterion(out, y)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip is not None:
            clip_gradients(grads, self.clip)
        self.optim_method.update(step, grads, self.params, self.opt_state)
        return loss.detach()
