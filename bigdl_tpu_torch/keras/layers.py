"""Keras-1 layers that need more than a re-export — the port of
``bigdl_tpu.keras.layers``: ``Merge`` and the atrous (dilated)
convolutions.  ``Bidirectional`` and ``MaxoutDense`` wait for the
recurrent layers and ``Maxout``."""

from bigdl_tpu_torch.nn import layers_extra as LX
from bigdl_tpu_torch.nn.layers import Conv1D, Conv2D
from bigdl_tpu_torch.nn.module import CAddTable, CMulTable, JoinTable, Module


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
