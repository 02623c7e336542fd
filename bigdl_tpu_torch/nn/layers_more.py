"""The shrink activations and ``Mish`` — the part of
``bigdl_tpu.nn.layers_more`` that the stock-torch converter
(``utils.torch_convert``) emits.  The rest of that module is not ported
yet (ROADMAP A.6.2)."""

import torch

from bigdl_tpu_torch.nn.layers import _softplus
from bigdl_tpu_torch.nn.module import Module


class HardShrink(Module):
    """``x`` where ``|x| > lam``, else 0."""

    def __init__(self, lam: float = 0.5, name=None):
        super().__init__(name)
        self.lam = float(lam)

    def forward(self, x):
        return torch.where(x.abs() > self.lam, x, torch.zeros_like(x))


class SoftShrink(Module):
    """``sign(x) * max(|x| - lam, 0)``."""

    def __init__(self, lam: float = 0.5, name=None):
        super().__init__(name)
        self.lam = float(lam)

    def forward(self, x):
        return torch.sign(x) * torch.clamp(x.abs() - self.lam, min=0.0)


class TanhShrink(Module):
    """``x - tanh(x)``."""

    def forward(self, x):
        return x - torch.tanh(x)


class Mish(Module):
    """``x * tanh(softplus(x))``."""

    def forward(self, x):
        return x * torch.tanh(_softplus(x))
