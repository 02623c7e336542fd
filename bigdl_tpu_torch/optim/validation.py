"""Validation methods — the port of ``bigdl_tpu.optim.validation``.

Each method maps one batch's (output, target) to a (sum, count) pair of
0-d tensors on the output's device (``batch_stats``); a
``StatsAccumulator`` adds them up there across batches and reads them
once at the end, and ``fold`` turns the totals into a
``ValidationResult``.  ``weight`` is a per-row weight (padded rows carry
0); the port's evaluation drops padded rows instead, so it passes
none."""

from typing import List, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion

Stats = Tuple[torch.Tensor, torch.Tensor]


class ValidationResult:
    def __init__(self, sum_: float, count: float, name: str):
        self.sum = float(sum_)
        self.count = float(count)
        self.name = name

    @property
    def result(self) -> float:
        return self.sum / max(self.count, 1e-12)

    def __add__(self, other: "ValidationResult") -> "ValidationResult":
        return ValidationResult(self.sum + other.sum,
                                self.count + other.count, self.name)

    def __repr__(self):
        return f"{self.name}: {self.result:.6f} ({int(self.count)} samples)"


class ValidationMethod:
    name = "metric"

    def batch_stats(self, output, target, weight=None) -> Stats:
        raise NotImplementedError

    def fold(self, sum_, count) -> ValidationResult:
        return ValidationResult(sum_, count, self.name)


class StatsAccumulator:
    """Adds per-method (sum, count) pairs on the device across batches;
    ``fetch`` reads them to the host in one copy."""

    def __init__(self):
        self.totals: Optional[List[Stats]] = None

    def add(self, stats: Sequence[Stats]) -> None:
        stats = [(s.float(), c.float()) for s, c in stats]
        if self.totals is None:
            self.totals = stats
        else:
            self.totals = [(a + s, b + c) for (a, b), (s, c)
                           in zip(self.totals, stats)]

    def fetch(self) -> Optional[List[Tuple[float, float]]]:
        if self.totals is None:
            return None
        flat = torch.stack([t for pair in self.totals for t in pair])
        vals = flat.cpu().tolist()
        return list(zip(vals[0::2], vals[1::2]))


def _w(weight, output) -> torch.Tensor:
    if weight is None:
        return torch.ones(output.shape[0], device=output.device)
    return torch.as_tensor(weight, dtype=torch.float32, device=output.device)


def _class_target(output, target):
    """Integer labels, or one-hot / soft targets of the output's shape
    (argmaxed)."""
    if (target.ndim == output.ndim and target.shape == output.shape
            and target.is_floating_point()):
        return target.argmax(dim=-1)
    return target.long()


class Top1Accuracy(ValidationMethod):
    name = "Top1Accuracy"

    def batch_stats(self, output, target, weight=None):
        pred = output.argmax(dim=-1)
        tgt = _class_target(output, target).reshape(pred.shape)
        hits = (pred == tgt).float().reshape(pred.shape[0], -1)
        w = _w(weight, output)
        return (hits * w[:, None]).sum(), w.sum() * hits.shape[1]


class Top5Accuracy(ValidationMethod):
    name = "Top5Accuracy"

    def batch_stats(self, output, target, weight=None):
        if output.shape[-1] <= 5:
            raise ValueError(
                f"Top5Accuracy is degenerate with {output.shape[-1]} "
                "classes (always 1.0); use Top1Accuracy")
        top5 = output.topk(5, dim=-1).indices
        tgt = _class_target(output, target).reshape(
            output.shape[:-1])[..., None]
        hits = (top5 == tgt).any(dim=-1).float().reshape(
            output.shape[0], -1)
        w = _w(weight, output)
        return (hits * w[:, None]).sum(), w.sum() * hits.shape[1]


class Loss(ValidationMethod):
    """The criterion's mean over rows (default: cross-entropy)."""

    name = "Loss"

    def __init__(self, criterion=None):
        self.criterion = criterion or CrossEntropyCriterion()

    def batch_stats(self, output, target, weight=None):
        if weight is None:
            n = torch.tensor(float(output.shape[0]), device=output.device)
            return self.criterion(output, target) * n, n
        # a weighted batch: the criterion row by row
        per = torch.stack([self.criterion(o[None], t[None])
                           for o, t in zip(output, target)])
        w = _w(weight, output)
        return (per * w).sum(), w.sum()


class MAE(ValidationMethod):
    name = "MAE"

    def batch_stats(self, output, target, weight=None):
        per = (output - target).abs().reshape(output.shape[0], -1).mean(-1)
        w = _w(weight, output)
        return (per * w).sum(), w.sum()


class MSE(ValidationMethod):
    name = "MSE"

    def batch_stats(self, output, target, weight=None):
        per = ((output - target) ** 2).reshape(output.shape[0], -1).mean(-1)
        w = _w(weight, output)
        return (per * w).sum(), w.sum()


def _rank_of_positive(output, target):
    """Rank of each row's positive candidate, ties counted half; a row
    with a NaN score ranks last."""
    tgt = target.long().reshape(output.shape[0])
    pos = output.gather(-1, tgt[:, None])
    greater = (output > pos).float().sum(-1)
    ties = (output == pos).float().sum(-1) - 1.0
    rank = greater + 0.5 * ties
    bad = pos[:, 0].isnan() | output.isnan().any(-1)
    return torch.where(bad, torch.full_like(rank, output.shape[-1]), rank)


class Precision(ValidationMethod):
    """TP / predicted positive of ``positive_class``."""

    name = "Precision"

    def __init__(self, positive_class: int = 1):
        self.cls = positive_class

    def batch_stats(self, output, target, weight=None):
        pred = output.argmax(dim=-1).reshape(-1)
        tgt = _class_target(output, target).reshape(pred.shape)
        pp = (pred == self.cls).float() * _w(weight, output)
        return (pp * (tgt == self.cls)).sum(), pp.sum()


class Recall(ValidationMethod):
    """TP / actual positive of ``positive_class``."""

    name = "Recall"

    def __init__(self, positive_class: int = 1):
        self.cls = positive_class

    def batch_stats(self, output, target, weight=None):
        pred = output.argmax(dim=-1).reshape(-1)
        tgt = _class_target(output, target).reshape(pred.shape)
        ap = (tgt == self.cls).float() * _w(weight, output)
        return (ap * (pred == self.cls)).sum(), ap.sum()


class HitRatio(ValidationMethod):
    """HR@k: whether the positive candidate (``target``, 0-based) ranks
    in the top k of the row's scores."""

    def __init__(self, k: int = 10):
        self.k = k
        self.name = f"HitRatio@{k}"

    def batch_stats(self, output, target, weight=None):
        hits = (_rank_of_positive(output, target) < self.k).float()
        w = _w(weight, output)
        return (hits * w).sum(), w.sum()


class NDCG(ValidationMethod):
    """NDCG@k with one positive a row: 1 / log2(rank + 2) inside the top
    k, else 0."""

    def __init__(self, k: int = 10):
        self.k = k
        self.name = f"NDCG@{k}"

    def batch_stats(self, output, target, weight=None):
        rank = _rank_of_positive(output, target)
        gain = torch.where(rank < self.k, 1.0 / torch.log2(rank + 2.0),
                           torch.zeros_like(rank))
        w = _w(weight, output)
        return (gain * w).sum(), w.sum()


class AUC(ValidationMethod):
    """ROC-AUC of each batch (Mann-Whitney U, ties half), folded over
    batches weighted by their positive-negative pairs.  Two-column
    outputs rank by the margin column 1 - column 0, others by the last
    column."""

    name = "AUC"

    def batch_stats(self, output, target, weight=None):
        score = output.reshape(output.shape[0], -1)
        if score.shape[1] == 2:
            score = score[:, 1] - score[:, 0]
        else:
            score = score[:, -1]
        t = target.reshape(-1).float()
        w = _w(weight, output)
        pos = (t > 0.5).float() * w
        neg = (t <= 0.5).float() * w
        s_i, s_j = score[:, None], score[None, :]
        wins = (s_i > s_j).float() + 0.5 * (s_i == s_j).float()
        pair_w = pos[:, None] * neg[None, :]
        return (wins * pair_w).sum(), pair_w.sum()
