"""The extended criterion catalog — the port of
``bigdl_tpu.nn.criterion_extra``.

The same conventions as ``criterion``: scalar functions of (input,
target) whose gradients come from autograd, 0-based labels,
``size_average=True`` the mean.  Criterions over a table take a tuple of
tensors as ``input``; the target-free ones (``L1Cost``, ``KLDCriterion``,
``RankHingeCriterion``) ignore ``target``."""

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.criterion import Criterion, KLDivCriterion, _reduce


def _as_onehot(target, n_classes: int):
    """A float target whose last axis spans the classes as it is, else
    the one-hot of integer labels (a label outside [0, n_classes) is all
    zeros, as ``jax.nn.one_hot`` gives it)."""
    if (target.ndim >= 1 and target.shape[-1] == n_classes
            and target.is_floating_point()):
        return target
    classes = torch.arange(n_classes, device=target.device)
    return (target.long()[..., None] == classes).float()


def _cosine(input, target, eps: float):
    t = target.to(input.dtype)
    num = (input * t).sum(dim=-1)
    den = torch.linalg.norm(input, dim=-1) * torch.linalg.norm(t, dim=-1)
    return num / torch.clamp(den, min=eps)


class MultiCriterion(Criterion):
    """Weighted sum of criterions on the same (input, target)."""

    def __init__(self, criterions: Sequence[Criterion] = (),
                 weights: Optional[Sequence[float]] = None):
        self.criterions = list(criterions)
        self.weights = (list(weights) if weights
                        else [1.0] * len(self.criterions))
        if len(self.weights) != len(self.criterions):
            raise ValueError(f"{len(self.criterions)} criterions but "
                             f"{len(self.weights)} weights")

    def add(self, criterion: Criterion,
            weight: float = 1.0) -> "MultiCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def forward(self, input, target):
        return sum(w * c(input, target)
                   for c, w in zip(self.criterions, self.weights))


class MultiLabelSoftMarginCriterion(Criterion):
    """One-vs-all logistic loss over logits, a 0/1 target per label."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        t = target.to(input.dtype)
        per = -(t * F.logsigmoid(input) + (1.0 - t) * F.logsigmoid(-input))
        return _reduce(per.mean(dim=-1), self.size_average)


class MultiMarginCriterion(Criterion):
    """Multi-class hinge: mean_j max(0, margin - x[y] + x[j])^p over the
    classes, the label's own term taken out."""

    def __init__(self, p: int = 1, margin: float = 1.0,
                 size_average: bool = True):
        self.p = p
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        tgt = target.long().reshape(input.shape[:-1])
        x_y = input.gather(-1, tgt[..., None])
        viol = torch.clamp(self.margin - x_y + input, min=0.0) ** self.p
        per = (viol.sum(dim=-1) - self.margin ** self.p) / input.shape[-1]
        return _reduce(per, self.size_average)


class HingeEmbeddingCriterion(Criterion):
    """x where y = +1, max(0, margin - x) where y = -1 (x a distance)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        self.margin = margin
        self.size_average = size_average

    def forward(self, input, target):
        t = target.to(input.dtype)
        per = torch.where(t > 0, input,
                          torch.clamp(self.margin - input, min=0.0))
        return _reduce(per, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """Hinge embedding over the L1 distance of an (x1, x2) table."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def forward(self, input, target):
        x1, x2 = input
        dist = (x1 - x2).abs().sum(dim=-1)
        t = target.to(dist.dtype).reshape(dist.shape)
        per = torch.where(t > 0, dist,
                          torch.clamp(self.margin - dist, min=0.0))
        return per.mean()


class MarginCriterion(Criterion):
    """max(0, margin - y x) on ±1 targets; squared, the L2-SVM loss."""

    def __init__(self, margin: float = 1.0, size_average: bool = True,
                 squared: bool = False):
        self.margin = margin
        self.size_average = size_average
        self.squared = squared

    def forward(self, input, target):
        t = target.to(input.dtype)
        per = torch.clamp(self.margin - t * input, min=0.0)
        if self.squared:
            per = per ** 2
        return _reduce(per, self.size_average)


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y x)) on ±1 targets."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def forward(self, input, target):
        t = target.to(input.dtype)
        return _reduce(F.softplus(-t * input), self.size_average)


class DiceCoefficientCriterion(Criterion):
    """1 - (2 |X ∩ Y| + eps) / (|X| + |Y| + eps) a row, mean over rows."""

    def __init__(self, epsilon: float = 1.0):
        self.epsilon = epsilon

    def forward(self, input, target):
        x = input.reshape(input.shape[0], -1)
        y = target.to(input.dtype).reshape(target.shape[0], -1)
        inter = (x * y).sum(dim=-1)
        denom = x.sum(dim=-1) + y.sum(dim=-1)
        dice = (2.0 * inter + self.epsilon) / (denom + self.epsilon)
        return (1.0 - dice).mean()


class PoissonCriterion(Criterion):
    """Poisson NLL of a rate input: mean(x - t log(x + eps))."""

    def __init__(self, size_average: bool = True, eps: float = 1e-8):
        self.size_average = size_average
        self.eps = eps

    def forward(self, input, target):
        t = target.to(input.dtype)
        return _reduce(input - t * torch.log(input + self.eps),
                       self.size_average)


# the reference's name of KLDivCriterion: one implementation, as in the
# JAX package
DistKLDivCriterion = KLDivCriterion


class KullbackLeiblerDivergenceCriterion(Criterion):
    """keras ``kld`` on probabilities: sum t log(t / p), both clipped to
    [eps, 1]."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps

    def forward(self, input, target):
        p = torch.clamp(input, self.eps, 1.0)
        t = torch.clamp(target.to(input.dtype), self.eps, 1.0)
        return (t * torch.log(t / p)).sum(dim=-1).mean()


class MeanAbsolutePercentageCriterion(Criterion):
    """keras ``mape``: 100 mean(|t - x| / max(|t|, eps))."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps

    def forward(self, input, target):
        t = target.to(input.dtype)
        return 100.0 * ((t - input).abs()
                        / torch.clamp(t.abs(), min=self.eps)).mean()


class MeanSquaredLogarithmicCriterion(Criterion):
    """keras ``msle``: mean((log(t + 1) - log(x + 1))²), negatives at 0."""

    def forward(self, input, target):
        t = target.to(input.dtype)
        return ((torch.log1p(torch.clamp(t, min=0.0))
                 - torch.log1p(torch.clamp(input, min=0.0))) ** 2).mean()


class CategoricalCrossEntropy(Criterion):
    """keras ``categorical_crossentropy`` on probabilities, one-hot or
    soft targets (integer labels are one-hot encoded)."""

    def __init__(self, eps: float = 1e-7):
        self.eps = eps

    def forward(self, input, target):
        p = torch.clamp(input, self.eps, 1.0 - self.eps)
        onehot = _as_onehot(target, input.shape[-1]).to(input.dtype)
        return -(onehot * torch.log(p)).sum(dim=-1).mean()


class CosineDistanceCriterion(Criterion):
    """1 - cos(x, t), the norms' product floored at eps."""

    def __init__(self, size_average: bool = True, eps: float = 1e-8):
        self.size_average = size_average
        self.eps = eps

    def forward(self, input, target):
        return _reduce(1.0 - _cosine(input, target, self.eps),
                       self.size_average)


class CosineProximityCriterion(Criterion):
    """keras ``cosine_proximity``: minus the mean cosine similarity."""

    def __init__(self, eps: float = 1e-8):
        self.eps = eps

    def forward(self, input, target):
        return -_cosine(input, target, self.eps).mean()


class RankHingeCriterion(Criterion):
    """Pairwise ranking hinge over a (pos_score, neg_score) table."""

    def __init__(self, margin: float = 1.0):
        self.margin = margin

    def forward(self, input, target=None):
        pos, neg = input
        return torch.clamp(self.margin - pos + neg, min=0.0).mean()


class GaussianCriterion(Criterion):
    """Negative log-likelihood of a diagonal Gaussian given a (mean,
    log_var) table, summed and divided by the rows."""

    def forward(self, input, target):
        mean, log_var = input
        t = target.to(mean.dtype)
        per = 0.5 * (log_var + math.log(2.0 * math.pi)
                     + (t - mean) ** 2 / torch.exp(log_var))
        return per.sum() / mean.shape[0]


class KLDCriterion(Criterion):
    """KL(q(z|x) ‖ N(0, 1)) from a (mean, log_var) table, summed and
    divided by the rows; the target is ignored."""

    def forward(self, input, target=None):
        mean, log_var = input
        per = -0.5 * (1.0 + log_var - mean ** 2 - torch.exp(log_var))
        return per.sum() / mean.shape[0]


class L1Cost(Criterion):
    """sum(|x|); the target is ignored."""

    def forward(self, input, target=None):
        return input.abs().sum()


class TransformerCriterion(Criterion):
    """An inner criterion on transformed input (and target)."""

    def __init__(self, criterion: Criterion, input_transform=None,
                 target_transform=None):
        self.criterion = criterion
        self.input_transform = input_transform
        self.target_transform = target_transform

    def forward(self, input, target):
        if self.input_transform is not None:
            input = self.input_transform(input)
        if self.target_transform is not None:
            target = self.target_transform(target)
        return self.criterion(input, target)


class TimeDistributedMaskCriterion(Criterion):
    """A criterion applied to each time step of input (b, t, ...) and
    target (b, t, ...), the steps whose target equals ``padding_value``
    left out: the sum over valid steps divided by their number (at
    least 1).  Each step is the inner criterion on that one row
    (``torch.vmap``), so the inner criterion must be written in
    vmappable tensor ops."""

    def __init__(self, criterion, padding_value: int = 0):
        self.criterion = criterion
        self.padding_value = padding_value

    def forward(self, input, target):
        b, t = target.shape[:2]
        mask = (target != self.padding_value).float()
        flat_in = input.reshape((b * t,) + tuple(input.shape[2:]))
        flat_tg = target.reshape((b * t,) + tuple(target.shape[2:]))
        per = torch.vmap(lambda i, tg: self.criterion(i[None], tg[None]))(
            flat_in, flat_tg).reshape(b, t)
        return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)


class PGCriterion(Criterion):
    """Policy gradient: -sum(target log(input)), the (discounted) reward
    on the taken action folded into the one-hot target; with
    ``size_average`` the mean over rows of the row sums."""

    def __init__(self, size_average: bool = False, eps: float = 1e-12):
        self.size_average = size_average
        self.eps = eps

    def forward(self, input, target):
        ll = torch.log(torch.clamp(input, min=self.eps)) * target
        return -(ll.sum(dim=-1).mean() if self.size_average else ll.sum())
