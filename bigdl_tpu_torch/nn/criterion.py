"""Loss functions — the port of ``bigdl_tpu.nn.criterion``.

A criterion is a scalar function of (input, target); PyTorch's autograd
gives its gradient.  ``size_average`` (the default) takes the mean over
rows, else the sum.  Integer class labels are 0-based, as in the JAX
package."""

from typing import Optional

import torch


class Criterion:
    def forward(self, input, target):
        raise NotImplementedError

    def __call__(self, input, target=None):
        return self.forward(input, target)


def _reduce(x, size_average: bool):
    return x.mean() if size_average else x.sum()


def _is_soft(target, n_classes: int) -> bool:
    """A float target whose last axis spans the classes is a one-hot or
    soft distribution; anything else is read as integer labels."""
    return (target.ndim >= 1 and target.shape[-1] == n_classes
            and target.is_floating_point())


def _picked(logp, target):
    """``logp`` at each row's label.  A label outside [0, n_classes)
    picks 0, as the JAX package's one-hot of it is all zeros."""
    n = logp.shape[-1]
    tgt = target.long().reshape(logp.shape[:-1])
    valid = (tgt >= 0) & (tgt < n)
    picked = logp.gather(-1, tgt.clamp(0, n - 1)[..., None])[..., 0]
    return torch.where(valid, picked, torch.zeros_like(picked))


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities, optionally with
    per-class ``weights``."""

    def __init__(self, size_average: bool = True,
                 weights: Optional[torch.Tensor] = None):
        self.size_average = size_average
        self.weights = weights

    def forward(self, input, target):
        tgt = target.long().reshape(input.shape[:-1])
        picked = input.gather(-1, tgt[..., None])[..., 0]
        if self.weights is not None:
            w = torch.as_tensor(self.weights, dtype=input.dtype,
                                device=input.device)[tgt]
            return -(picked * w).sum() / (w.sum() if self.size_average
                                          else 1.0)
        return -_reduce(picked, self.size_average)


class CrossEntropyCriterion(Criterion):
    """Softmax cross-entropy over logits.  Integer labels gather the
    log-probability at the label; one-hot or soft float targets (last axis
    the classes) take the one-hot sum.  Both give the JAX package's
    one-hot formula, and the gather builds no (rows, classes) one-hot:
    1 GB less at batch 8 x 1024 tokens over a 32768 vocabulary."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        logp = torch.log_softmax(input, dim=-1)
        if _is_soft(target, input.shape[-1]):
            per_row = (target.to(logp.dtype) * logp).sum(dim=-1)
        else:
            per_row = _picked(logp, target)
        return -_reduce(per_row, self.size_average)


class MSECriterion(Criterion):
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce((input - target) ** 2, self.size_average)


class AbsCriterion(Criterion):
    """L1."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        return _reduce((input - target).abs(), self.size_average)


class SmoothL1Criterion(Criterion):
    """Huber with delta 1."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        d = (input - target).abs()
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class BCECriterion(Criterion):
    """Binary cross-entropy over probabilities, clipped to
    [eps, 1 - eps]."""

    def __init__(self, size_average: bool = True, eps: float = 1e-12):
        self.size_average = size_average
        self.eps = eps

    def forward(self, input, target):
        p = input.clamp(self.eps, 1.0 - self.eps)
        loss = -(target * torch.log(p) + (1.0 - target) * torch.log1p(-p))
        return _reduce(loss, self.size_average)


class BCEWithLogitsCriterion(Criterion):
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        loss = (input.clamp(min=0) - input * target
                + torch.log1p(torch.exp(-input.abs())))
        return _reduce(loss, self.size_average)


class KLDivCriterion(Criterion):
    """KL divergence of ``target`` from the log-probabilities ``input``;
    entries with target 0 add 0."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        safe = torch.where(
            target > 0,
            target * (torch.log(target.clamp(min=1e-30)) - input),
            torch.zeros_like(input))
        return _reduce(safe, self.size_average)


class CosineEmbeddingCriterion(Criterion):
    """Input (x1, x2), target +1 (similar) or -1 (dissimilar)."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = input
        cos = (x1 * x2).sum(-1) / (
            torch.linalg.vector_norm(x1, dim=-1)
            * torch.linalg.vector_norm(x2, dim=-1) + 1e-12)
        loss = torch.where(target > 0, 1.0 - cos,
                           (cos - self.margin).clamp(min=0.0))
        return _reduce(loss, self.size_average)


class MarginRankingCriterion(Criterion):
    """Input (x1, x2), target +1 when x1 should rank higher."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        x1, x2 = input
        return _reduce((-target * (x1 - x2) + self.margin).clamp(min=0.0),
                       self.size_average)


class ParallelCriterion(Criterion):
    """Weighted sum of ``(criterion, weight)`` pairs over tuple inputs
    and targets."""

    def __init__(self, *pairs):
        self.pairs = [(c, w) for c, w in pairs]

    def forward(self, input, target):
        total = 0.0
        for i, (c, w) in enumerate(self.pairs):
            total = total + w * c(input[i], target[i])
        return total


class TimeDistributedCriterion(Criterion):
    """A criterion over (batch, time, ...) inputs; with
    ``size_average=False`` the wrapped mean is scaled by the number of
    time steps."""

    def __init__(self, criterion: Criterion, size_average: bool = True):
        self.criterion = criterion
        self.size_average = size_average

    def forward(self, input, target):
        loss = self.criterion(input, target)
        if not self.size_average:
            loss = loss * input.shape[1]
        return loss
