"""ResNet — the port of ``bigdl_tpu.models.resnet``: v1 basic blocks for
CIFAR-10 (depth 6n+2) and the bottleneck ResNet-50 for ImageNet, MSRA
init, the last BN of every block zeroed at init (``gamma_zero``), NHWC.
Projection shortcuts are a 1x1 conv with BN.

Every module keeps the JAX params/state keys (``body``, ``proj``,
``f"{i}_{name}"``), so ``utils.convert`` moves variables across."""

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.layers import conv2d_nhwc


class _BN(nn.BatchNorm):
    """BatchNorm whose weight starts at 0 with ``gamma_zero``."""

    def __init__(self, c, gamma_zero=False):
        super().__init__(c)
        self.gamma_zero = gamma_zero
        if gamma_zero:
            with torch.no_grad():
                self.weight.zero_()


def _conv_bn(cin, cout, k, stride=1, pad="SAME", act=True,
             gamma_zero=False, generator=None):
    layers = [nn.Conv2D(cin, cout, k, stride=stride, padding=pad,
                        with_bias=False, weight_init=init_mod.msra,
                        generator=generator),
              _BN(cout, gamma_zero)]
    if act:
        layers.append(nn.ReLU())
    return layers


class SpaceToDepthStem(nn.Module):
    """The ImageNet stem as a 2x2 space-to-depth then a 4x4 stride-1 conv
    over 4 * cin channels, equal to the 7x7 stride-2 SAME conv whose
    kernel :func:`pack_stem_kernel` maps onto it.  The weight is drawn
    with the 7x7 stem's fans, so its variance matches the standard
    stem's."""

    def __init__(self, out_channels: int = 64, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.out_channels = out_channels
        self.weight = torch.nn.Parameter(init_mod.msra(
            generator, (4, 4, 4 * in_channels, out_channels),
            7 * 7 * in_channels, 7 * 7 * out_channels))

    def forward(self, x):
        n, h, w, c = x.shape
        if h % 2 or w % 2:
            raise ValueError(f"H/W must be even for 2x2 space-to-depth, "
                             f"got {tuple(x.shape)}")
        x2 = (x.reshape(n, h // 2, 2, w // 2, 2, c)
              .permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c))
        # window offsets -1..+2 in s2d coordinates == the 7x7/s2 SAME pad
        return conv2d_nhwc(x2, self.weight, None, (1, 1),
                           [(1, 2), (1, 2)], (1, 1), 1)


def pack_stem_kernel(k7: torch.Tensor) -> torch.Tensor:
    """Map a (7, 7, C, out) stride-2 stem kernel onto the (4, 4, 4C, out)
    space-to-depth kernel, so that ``SpaceToDepthStem`` with it equals
    ``Conv2D(k=7, s=2, SAME)`` with ``k7``."""
    kh, kw, c, cout = k7.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"want a 7x7 kernel, got {tuple(k7.shape)}")
    k2 = k7.new_zeros((4, 4, 4 * c, cout))
    for r in range(4):
        for p in range(2):
            di = 2 * r + p
            if di > 6:
                continue
            for s in range(4):
                for q in range(2):
                    dj = 2 * s + q
                    if dj > 6:
                        continue
                    ch = (p * 2 + q) * c
                    k2[r, s, ch:ch + c, :] = k7[di, dj]
    return k2


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (CIFAR, ResNet-18/34)."""

    def __init__(self, cin, cout, stride=1,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        g = generator
        self.body = nn.Sequential(
            _conv_bn(cin, cout, 3, stride, generator=g)
            + _conv_bn(cout, cout, 3, act=False, gamma_zero=True,
                       generator=g))
        self.proj = (nn.Sequential(_conv_bn(cin, cout, 1, stride, act=False,
                                            generator=g))
                     if stride != 1 or cin != cout else None)

    def forward(self, x):
        sc = x if self.proj is None else self.proj(x)
        # max(., 0) as the JAX block takes it: its gradient at exactly 0
        # is 1/2 (F.relu's is 0), which counts at init, where a
        # gamma-zero body adds 0 to the shortcut's exact zeros
        return torch.maximum(self.body(x) + sc, x.new_zeros(()))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50/101/152); the stride is on
    the 3x3 conv."""

    expansion = 4

    def __init__(self, cin, width, stride=1,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        g = generator
        cout = width * self.expansion
        self.body = nn.Sequential(
            _conv_bn(cin, width, 1, generator=g)
            + _conv_bn(width, width, 3, stride, generator=g)
            + _conv_bn(width, cout, 1, act=False, gamma_zero=True,
                       generator=g))
        self.proj = (nn.Sequential(_conv_bn(cin, cout, 1, stride, act=False,
                                            generator=g))
                     if stride != 1 or cin != cout else None)

    forward = BasicBlock.forward


def resnet_cifar(depth: int = 20, classes: int = 10,
                 generator: Optional[torch.Generator] = None
                 ) -> nn.Sequential:
    """CIFAR-10 ResNet of depth 6n+2, NHWC 32x32x3 in."""
    if (depth - 2) % 6:
        raise ValueError(f"depth {depth} is not 6n+2")
    n = (depth - 2) // 6
    g = generator
    layers = _conv_bn(3, 16, 3, generator=g)
    cin = 16
    for stage, width in enumerate([16, 32, 64]):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            layers.append(BasicBlock(cin, width, stride, generator=g))
            cin = width
    layers += [nn.GlobalAvgPool2D(), nn.Linear(64, classes, generator=g),
               nn.LogSoftMax()]
    return nn.Sequential(layers)


def resnet50(classes: int = 1000, include_top: bool = True,
             stem: str = "conv",
             generator: Optional[torch.Generator] = None) -> nn.Sequential:
    """ImageNet ResNet-50, NHWC 224x224x3 in.  ``stem="s2d"`` swaps the
    7x7/s2 conv for the equivalent :class:`SpaceToDepthStem`."""
    g = generator
    if stem == "s2d":
        layers = [SpaceToDepthStem(64, generator=g), _BN(64), nn.ReLU()]
    elif stem == "conv":
        layers = _conv_bn(3, 64, 7, stride=2, generator=g)
    else:
        raise ValueError(f"stem {stem!r}: conv | s2d")
    layers.append(nn.MaxPool2D(3, 2, padding=1))
    cin = 64
    for stage, (width, blocks) in enumerate([(64, 3), (128, 4), (256, 6),
                                             (512, 3)]):
        for b in range(blocks):
            stride = 2 if (stage > 0 and b == 0) else 1
            layers.append(Bottleneck(cin, width, stride, generator=g))
            cin = width * Bottleneck.expansion
    layers.append(nn.GlobalAvgPool2D())
    if include_top:
        layers += [nn.Linear(2048, classes, generator=g), nn.LogSoftMax()]
    return nn.Sequential(layers)
