"""Core layers — the port of the parts of ``bigdl_tpu.nn.layers`` that
the served Transformer uses.  Layouts and numerics follow the JAX
package: ``Linear`` stores its weight as (in, out) and computes
``x @ W + b``; ``LayerNorm`` takes its statistics in float32 with
eps 1e-6."""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.tensor.policy import cast_compute


def xavier_(t: torch.Tensor, fan_in: int, fan_out: int,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot uniform in place, as ``bigdl_tpu.nn.init.xavier``."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        return t.uniform_(-limit, limit, generator=generator)


class Linear(nn.Module):
    """Fully-connected layer, weight (in, out), forward ``x @ W + b``."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(xavier_(
            torch.empty(in_features, out_features), in_features,
            out_features, generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x):
        xc, wc = cast_compute(x, self.weight)
        # bias added in the float32 accumulation dtype
        return (torch.matmul(xc, wc).float() + self.bias).to(x.dtype)


class LayerNorm(nn.Module):
    """Normalizes over the last axis; statistics in float32."""

    def __init__(self, num_features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class Dropout(nn.Module):
    """Inverted dropout in training; the identity at inference."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if self.training and self.p > 0.0:
            return F.dropout(x, self.p, training=True)
        return x
