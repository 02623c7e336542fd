"""The train step — the single-device case of
``bigdl_tpu.optim.train_step.ShardedParameterStep``.

One step is the forward in training mode, the criterion, autograd's
backward, optional gradient clipping (constant, then global L2 norm, as
the JAX step clips), and the optimizer's in-place update.  With one rank
the JAX step's reduce-scatter / all-gather cycle is the identity, so
nothing of it is here; gradient accumulation, EMA, rematerialisation,
trainable masks and step bundles are not ported and not accepted."""

from dataclasses import dataclass
from typing import List, Optional

import torch

from bigdl_tpu_torch.optim.optim_method import OptimMethod


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
    waits for the step)."""

    def __init__(self, model: torch.nn.Module, criterion,
                 optim_method: OptimMethod,
                 clip: Optional[GradientClipping] = None):
        self.model = model
        self.criterion = criterion
        self.optim_method = optim_method
        self.clip = clip
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.opt_state = optim_method.init_state(self.params)

    def __call__(self, step: int, x, y) -> torch.Tensor:
        self.model.train(True)
        for p in self.params:
            p.grad = None
        loss = self.criterion(self.model(x), y)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip is not None:
            clip_gradients(grads, self.clip)
        self.optim_method.update(step, grads, self.params, self.opt_state)
        return loss.detach()
