"""Keras-style API — the port of ``bigdl_tpu.keras``: keras-1 layer names
over the port's nn layers, and functional ``Model(inputs, outputs)`` /
``Sequential`` graphs with the keras training surface (``compile``,
``fit``, ``evaluate``, ``predict``, ``get_weights`` / ``set_weights``,
``summary``).  Only names whose layers the port has are here."""

from bigdl_tpu_torch import nn as _nn
from bigdl_tpu_torch.keras.engine import Input, Model, Node, Sequential
from bigdl_tpu_torch.keras.layers import (AtrousConvolution1D,
                                          AtrousConvolution2D, Bidirectional,
                                          MaxoutDense, Merge)
from bigdl_tpu_torch.nn import (ELU, GELU, GRU, LSTM, Dense, Dropout,
                                Embedding, Flatten, HardSigmoid, LayerNorm,
                                LeakyReLU, LogSoftMax, MultiHeadAttention,
                                ReLU, Reshape, Sigmoid, SimpleRNN, SoftMax,
                                SoftPlus, SoftSign, Tanh, TimeDistributed,
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
    "AveragePooling2D", "AvgPool2D", "BatchNormalization", "Bidirectional",
    "Conv1D",
    "Conv2D", "Convolution1D", "Convolution2D", "Dense", "Dropout", "ELU",
    "Embedding", "Flatten", "GELU", "GRU", "GlobalAveragePooling2D",
    "HardSigmoid", "Input", "InputLayer", "LSTM", "LayerNorm", "LeakyReLU",
    "LogSoftMax", "MaxPool2D", "MaxPooling2D", "MaxoutDense", "Merge",
    "Model", "MultiHeadAttention", "Node", "ReLU", "Reshape", "Sequential",
    "Sigmoid", "SimpleRNN", "SoftMax", "SoftPlus", "SoftSign", "Tanh",
    "TimeDistributed", "TransformerLayer", "ZeroPadding2D",
]
