"""LeNet-5 — the port of ``bigdl_tpu.models.lenet``: conv6@5x5 (SAME)
-> tanh -> pool -> conv12@5x5 -> tanh -> pool -> fc100 -> tanh ->
fc(classes) -> logsoftmax, NHWC 28x28x1 in."""

from typing import Optional

import torch

from bigdl_tpu_torch import nn


def LeNet5(class_num: int = 10,
           generator: Optional[torch.Generator] = None) -> nn.Sequential:
    g = generator
    return nn.Sequential([
        nn.Conv2D(1, 6, 5, padding="SAME", generator=g), nn.Tanh(),
        nn.MaxPool2D(2, 2),
        nn.Conv2D(6, 12, 5, generator=g), nn.Tanh(),
        nn.MaxPool2D(2, 2),
        nn.Flatten(),
        nn.Linear(12 * 5 * 5, 100, generator=g), nn.Tanh(),
        nn.Linear(100, class_num, generator=g),
        nn.LogSoftMax(),
    ])
