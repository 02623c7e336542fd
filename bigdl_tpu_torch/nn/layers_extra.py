"""Extra layers — the part of ``bigdl_tpu.nn.layers_extra`` that the
keras encoder and keras ``Merge`` use: the learnable broadcast bias
``CAdd``, ``Select``, and the table ops ``CMaxTable``, ``CAveTable``,
``DotProduct`` and ``CosineDistance``.  The rest of that module is not
ported yet."""

from typing import Sequence

import torch
from torch import nn

from bigdl_tpu_torch.nn.module import Module, _table


class CAdd(Module):
    """Adds a learnable ``bias`` of shape ``size`` (zeros at init),
    broadcast against the input."""

    def __init__(self, size: Sequence[int], name=None):
        super().__init__(name)
        self.size = tuple(size)
        self.bias = nn.Parameter(torch.zeros(self.size))

    def forward(self, x):
        return x + self.bias


class Select(Module):
    """Takes index ``index`` along ``dim`` and drops that dim (0-based;
    negative indices count from the end)."""

    def __init__(self, dim: int, index: int, name=None):
        super().__init__(name)
        self.dim, self.index = dim, index

    def forward(self, x):
        return x.select(self.dim, self.index)


class CMaxTable(Module):
    """Elementwise maximum of a table input."""

    def forward(self, *xs):
        xs = _table(xs)
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out


class CAveTable(Module):
    """Elementwise mean of a table input."""

    def forward(self, *xs):
        xs = _table(xs)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out / len(xs)


class DotProduct(Module):
    """Dot product of two tensors over the last axis."""

    def forward(self, *xs):
        a, b = _table(xs)
        return (a * b).sum(dim=-1)


class CosineDistance(Module):
    """Cosine similarity of two tensors over the last axis (the
    similarity, as the reference's ``CosineDistance`` outputs), the
    product of the norms floored at ``eps``."""

    def __init__(self, eps: float = 1e-8, name=None):
        super().__init__(name)
        self.eps = eps

    def forward(self, *xs):
        a, b = _table(xs)
        num = (a * b).sum(dim=-1)
        den = (torch.linalg.vector_norm(a, dim=-1)
               * torch.linalg.vector_norm(b, dim=-1))
        return num / torch.clamp(den, min=self.eps)
