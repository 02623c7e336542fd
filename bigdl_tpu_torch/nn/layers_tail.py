"""``GroupNorm`` — the part of ``bigdl_tpu.nn.layers_tail`` that the
stock-torch converter (``utils.torch_convert``) emits.  The rest of that
module is not ported yet (ROADMAP A.6.2)."""

import torch
from torch import nn

from bigdl_tpu_torch.nn.module import Module


class GroupNorm(Module):
    """Group normalization over channels-last input (..., C): each
    sample's channels fall into ``num_groups`` groups, each normalized
    over its channels and every spatial position (the population
    variance); ``weight`` and ``bias`` (C,) when ``affine``."""

    def __init__(self, num_groups: int, num_features: int,
                 eps: float = 1e-5, affine: bool = True, name=None):
        super().__init__(name)
        if num_features % num_groups:
            raise ValueError(f"channels {num_features} not divisible by "
                             f"groups {num_groups}")
        self.num_groups = num_groups
        self.num_features = num_features
        self.eps = eps
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None

    def forward(self, x):
        c, g = x.shape[-1], self.num_groups
        xg = x.reshape(x.shape[0], -1, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
        xn = ((xg - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        if self.affine:
            xn = xn * self.weight + self.bias
        return xn
