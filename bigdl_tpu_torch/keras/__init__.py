"""Keras-style API — the port of ``bigdl_tpu.keras``: keras-1 layer names
over the port's nn layers, and functional ``Model(inputs, outputs)`` /
``Sequential`` graphs.  Only names whose layers the port has are here;
the keras training surface (``compile`` / ``fit`` / ...) is not ported
yet."""

from bigdl_tpu_torch import nn as _nn
from bigdl_tpu_torch.keras.engine import Input, Model, Node, Sequential
from bigdl_tpu_torch.keras.layers import (AtrousConvolution1D,
                                          AtrousConvolution2D, Merge)
from bigdl_tpu_torch.nn import (ELU, GELU, Dense, Dropout, Embedding,
                                Flatten, HardSigmoid, LayerNorm, LeakyReLU,
                                LogSoftMax, MultiHeadAttention, ReLU, Reshape,
                                Sigmoid, SoftMax, SoftPlus, SoftSign, Tanh,
                                TransformerLayer, ZeroPadding2D)
from bigdl_tpu_torch.nn.layers import AvgPool2D
from bigdl_tpu_torch.nn.layers import AvgPool2D as AveragePooling2D
from bigdl_tpu_torch.nn.layers import BatchNorm as BatchNormalization
from bigdl_tpu_torch.nn.layers import Conv1D
from bigdl_tpu_torch.nn.layers import Conv1D as Convolution1D
from bigdl_tpu_torch.nn.layers import Conv2D
from bigdl_tpu_torch.nn.layers import Conv2D as Convolution2D
from bigdl_tpu_torch.nn.layers import GlobalAvgPool2D as GlobalAveragePooling2D
from bigdl_tpu_torch.nn.layers import MaxPool2D
from bigdl_tpu_torch.nn.layers import MaxPool2D as MaxPooling2D

InputLayer = Input

_ACTIVATIONS = {
    "relu": _nn.ReLU, "relu6": _nn.ReLU6, "tanh": _nn.Tanh,
    "sigmoid": _nn.Sigmoid, "hard_sigmoid": _nn.HardSigmoid,
    "softmax": _nn.SoftMax, "log_softmax": _nn.LogSoftMax,
    "softplus": _nn.SoftPlus, "softsign": _nn.SoftSign, "gelu": _nn.GELU,
    "elu": _nn.ELU, "silu": _nn.SiLU, "swish": _nn.Swish,
    "linear": _nn.Identity,
}


def Activation(name: str):
    """Keras ``Activation("relu")``: the matching nn layer."""
    try:
        return _ACTIVATIONS[name.lower()]()
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; one of "
                         f"{sorted(_ACTIVATIONS)}") from None


__all__ = [
    "Activation", "AtrousConvolution1D", "AtrousConvolution2D",
    "AveragePooling2D", "AvgPool2D", "BatchNormalization", "Conv1D",
    "Conv2D", "Convolution1D", "Convolution2D", "Dense", "Dropout", "ELU",
    "Embedding", "Flatten", "GELU", "GlobalAveragePooling2D", "HardSigmoid",
    "Input", "InputLayer", "LayerNorm", "LeakyReLU", "LogSoftMax",
    "MaxPool2D", "MaxPooling2D", "Merge", "Model", "MultiHeadAttention",
    "Node", "ReLU", "Reshape", "Sequential", "Sigmoid", "SoftMax",
    "SoftPlus", "SoftSign", "Tanh", "TransformerLayer", "ZeroPadding2D",
]
