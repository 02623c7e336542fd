"""Keras-1 layers that need more than a re-export — the port of
``bigdl_tpu.keras.layers``: ``Merge``, ``Bidirectional``,
``MaxoutDense`` and the atrous (dilated) convolutions."""

from typing import Optional

from bigdl_tpu_torch.nn import layers_extra as LX
from bigdl_tpu_torch.nn.layers import Conv1D, Conv2D
from bigdl_tpu_torch.nn.module import CAddTable, CMulTable, JoinTable, Module
from bigdl_tpu_torch.nn.rnn import BiRecurrent, _RNNBase


class Merge(Module):
    """Keras-1 merge layer, used as ``Merge(mode)([node_a, node_b])``;
    modes sum | mul | ave | max | concat | dot | cosine.  Each mode
    delegates to the table op with the same semantics (CAddTable,
    CMulTable, CAveTable, CMaxTable, JoinTable, DotProduct,
    CosineDistance); dot and cosine keep a trailing feature axis."""

    MODES = ("sum", "mul", "ave", "max", "concat", "dot", "cosine")

    def __init__(self, mode: str = "sum", concat_axis: int = -1, name=None):
        super().__init__(name)
        if mode not in self.MODES:
            raise ValueError(f"mode {mode!r}: one of {self.MODES}")
        self.mode = mode
        self.concat_axis = concat_axis
        self._op = {
            "sum": CAddTable, "mul": CMulTable, "ave": LX.CAveTable,
            "max": LX.CMaxTable, "dot": LX.DotProduct,
            "cosine": LX.CosineDistance,
            "concat": lambda: JoinTable(concat_axis),
        }[mode]()

    def forward(self, *xs):
        y = self._op(*xs)
        return y[..., None] if self.mode in ("dot", "cosine") else y


def Bidirectional(layer: _RNNBase, merge_mode: str = "concat",
                  name: Optional[str] = None) -> BiRecurrent:
    """keras ``Bidirectional(LSTM(...))``: the nn ``BiRecurrent``."""
    return BiRecurrent(layer, merge=merge_mode, name=name)


def MaxoutDense(in_features: int, out_features: int, nb_feature: int = 4,
                name=None) -> LX.Maxout:
    """keras-1 ``MaxoutDense``: the nn ``Maxout`` with keras names."""
    return LX.Maxout(in_features, out_features, pool_size=nb_feature,
                     name=name)


def AtrousConvolution2D(in_channels, out_channels, kernel_size,
                        atrous_rate=1, stride=1, padding="VALID",
                        with_bias=True, name=None) -> Conv2D:
    """Keras-1 ``AtrousConvolution2D``: a dilated ``Conv2D``."""
    return Conv2D(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, dilation=atrous_rate, with_bias=with_bias,
                  name=name)


def AtrousConvolution1D(in_channels, out_channels, kernel_size,
                        atrous_rate=1, stride=1, padding="VALID",
                        with_bias=True, name=None) -> Conv1D:
    """Keras-1 ``AtrousConvolution1D``: a dilated ``Conv1D``."""
    return Conv1D(in_channels, out_channels, kernel_size, stride=stride,
                  padding=padding, dilation=atrous_rate, with_bias=with_bias,
                  name=name)
