"""Inception — the port of ``bigdl_tpu.models.inception``: Inception-v1
(GoogLeNet, the main tower) and Inception-v2 (BN-Inception), each
module four towers run by a ``Concat`` and joined on channels, NHWC.
Weights come from ``generator`` (a ``torch.Generator``; None: torch's
global one)."""

from typing import Optional

import torch

from bigdl_tpu_torch import nn


def _tower(*layers):
    return nn.Sequential(list(layers))


def inception_module(cin, c1, c3r, c3, c5r, c5, pool_proj,
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Concat:
    """Four towers: 1x1 / 3x3 after a 1x1 reduction / 5x5 after a 1x1
    reduction / a 3x3 max pool then a 1x1 projection."""
    g = generator
    return nn.Concat([
        _tower(nn.Conv2D(cin, c1, 1, generator=g), nn.ReLU()),
        _tower(nn.Conv2D(cin, c3r, 1, generator=g), nn.ReLU(),
               nn.Conv2D(c3r, c3, 3, padding="SAME", generator=g),
               nn.ReLU()),
        _tower(nn.Conv2D(cin, c5r, 1, generator=g), nn.ReLU(),
               nn.Conv2D(c5r, c5, 5, padding="SAME", generator=g),
               nn.ReLU()),
        _tower(nn.MaxPool2D(3, 1, padding=1),
               nn.Conv2D(cin, pool_proj, 1, generator=g), nn.ReLU()),
    ], dim=-1)


def inception_v1(classes: int = 1000, dropout: float = 0.4,
                 generator: Optional[torch.Generator] = None
                 ) -> nn.Sequential:
    """Inception-v1's main tower (the reference's two auxiliary
    classifiers are not part of the JAX model either)."""
    g = generator

    def mod(*widths):
        return inception_module(*widths, generator=g)

    return nn.Sequential([
        nn.Conv2D(3, 64, 7, stride=2, padding="SAME", generator=g),
        nn.ReLU(),
        nn.MaxPool2D(3, 2, padding=1),
        nn.Conv2D(64, 64, 1, generator=g), nn.ReLU(),
        nn.Conv2D(64, 192, 3, padding="SAME", generator=g), nn.ReLU(),
        nn.MaxPool2D(3, 2, padding=1),
        mod(192, 64, 96, 128, 16, 32, 32),       # 3a -> 256
        mod(256, 128, 128, 192, 32, 96, 64),     # 3b -> 480
        nn.MaxPool2D(3, 2, padding=1),
        mod(480, 192, 96, 208, 16, 48, 64),      # 4a -> 512
        mod(512, 160, 112, 224, 24, 64, 64),     # 4b
        mod(512, 128, 128, 256, 24, 64, 64),     # 4c
        mod(512, 112, 144, 288, 32, 64, 64),     # 4d -> 528
        mod(528, 256, 160, 320, 32, 128, 128),   # 4e -> 832
        nn.MaxPool2D(3, 2, padding=1),
        mod(832, 256, 160, 320, 32, 128, 128),   # 5a
        mod(832, 384, 192, 384, 48, 128, 128),   # 5b -> 1024
        nn.GlobalAvgPool2D(),
        nn.Dropout(dropout),
        nn.Linear(1024, classes, generator=g),
        nn.LogSoftMax(),
    ])


def _cbr(cin, cout, k, stride=1, generator=None):
    """Conv (no bias), BatchNorm, ReLU."""
    return [nn.Conv2D(cin, cout, k, stride=stride, padding="SAME",
                      with_bias=False, generator=generator),
            nn.BatchNorm(cout), nn.ReLU()]


def inception_v2_module(cin, c1, c3r, c3, d3r, d3, pool_proj,
                        pool: str = "avg", stride: int = 1,
                        generator: Optional[torch.Generator] = None
                        ) -> nn.Concat:
    """BN-Inception module.  ``stride=2`` is the grid-reduction form: no
    1x1 tower, and the pool tower passes through unprojected."""
    g = generator
    towers = []
    if stride == 1 and c1 > 0:
        towers.append(_tower(*_cbr(cin, c1, 1, generator=g)))
    towers.append(_tower(*(_cbr(cin, c3r, 1, generator=g)
                           + _cbr(c3r, c3, 3, stride, generator=g))))
    towers.append(_tower(*(_cbr(cin, d3r, 1, generator=g)
                           + _cbr(d3r, d3, 3, generator=g)
                           + _cbr(d3, d3, 3, stride, generator=g))))
    if stride == 1:
        pool_l = (nn.AvgPool2D(3, 1, padding=1) if pool == "avg"
                  else nn.MaxPool2D(3, 1, padding=1))
        towers.append(_tower(pool_l, *_cbr(cin, pool_proj, 1, generator=g)))
    else:
        towers.append(_tower(nn.MaxPool2D(3, 2, padding=1)))
    return nn.Concat(towers, dim=-1)


def inception_v2(classes: int = 1000,
                 generator: Optional[torch.Generator] = None
                 ) -> nn.Sequential:
    g = generator

    def mod(*widths, **kw):
        return inception_v2_module(*widths, generator=g, **kw)

    return nn.Sequential(
        _cbr(3, 64, 7, 2, generator=g) + [nn.MaxPool2D(3, 2, padding=1)]
        + _cbr(64, 64, 1, generator=g) + _cbr(64, 192, 3, generator=g)
        + [nn.MaxPool2D(3, 2, padding=1)]
        + [
            mod(192, 64, 64, 64, 64, 96, 32),                  # 3a -> 256
            mod(256, 64, 64, 96, 64, 96, 64),                  # 3b -> 320
            mod(320, 0, 128, 160, 64, 96, 0, stride=2),        # 3c -> 576
            mod(576, 224, 64, 96, 96, 128, 128),               # 4a -> 576
            mod(576, 192, 96, 128, 96, 128, 128),              # 4b
            mod(576, 160, 128, 160, 128, 160, 96),             # 4c
            mod(576, 96, 128, 192, 160, 192, 96),              # 4d
            mod(576, 0, 128, 192, 192, 256, 0, stride=2),      # 4e -> 1024
            mod(1024, 352, 192, 320, 160, 224, 128),           # 5a
            mod(1024, 352, 192, 320, 192, 224, 128, pool="max"),  # 5b
            nn.GlobalAvgPool2D(),
            nn.Linear(1024, classes, generator=g),
            nn.LogSoftMax(),
        ])
