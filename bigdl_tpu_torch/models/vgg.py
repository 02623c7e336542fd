"""VGG — the port of ``bigdl_tpu.models.vgg``: VGG-16 for ImageNet
(NHWC 224x224) and VggForCifar10 (BatchNorm after every conv, two
fc512 layers).  Weights come from ``generator``."""

from typing import Optional

import torch

from bigdl_tpu_torch import nn

_CFG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]


def _features(bn: bool, g) -> list:
    layers, cin = [], 3
    for v in _CFG16:
        if v == "M":
            layers.append(nn.MaxPool2D(2, 2))
            continue
        layers.append(nn.Conv2D(cin, v, 3, padding="SAME", generator=g))
        if bn:
            layers.append(nn.BatchNorm(v))
        layers.append(nn.ReLU())
        cin = v
    return layers


def vgg16(classes: int = 1000, dropout: float = 0.5,
          generator: Optional[torch.Generator] = None) -> nn.Sequential:
    g = generator
    return nn.Sequential(_features(False, g) + [
        nn.Flatten(),
        nn.Linear(512 * 7 * 7, 4096, generator=g), nn.ReLU(),
        nn.Dropout(dropout),
        nn.Linear(4096, 4096, generator=g), nn.ReLU(), nn.Dropout(dropout),
        nn.Linear(4096, classes, generator=g), nn.LogSoftMax(),
    ])


def vgg_cifar10(classes: int = 10,
                generator: Optional[torch.Generator] = None
                ) -> nn.Sequential:
    g = generator
    return nn.Sequential(_features(True, g) + [
        nn.Flatten(),
        nn.Linear(512, 512, generator=g), nn.BatchNorm(512), nn.ReLU(),
        nn.Dropout(0.5),
        nn.Linear(512, classes, generator=g), nn.LogSoftMax(),
    ])
