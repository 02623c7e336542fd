"""Extra layers — the part of ``bigdl_tpu.nn.layers_extra`` that the
keras encoder, keras ``Merge``, keras ``MaxoutDense`` and the stock-torch
converter (``utils.torch_convert``) use: the learnable broadcast bias
``CAdd``, ``Select``, the table ops ``CMaxTable``, ``CAveTable``,
``CSubTable``, ``CDivTable``, ``DotProduct`` and ``CosineDistance``,
``Maxout``, ``Conv2DTranspose``, ``UpSampling2D``, ``AddConstant``,
``MulConstant``, ``LogSigmoid`` and ``Mean``.  The rest of that module is
not ported yet (ROADMAP A.6.2)."""

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.layers import _pair
from bigdl_tpu_torch.nn.module import Module, _table
from bigdl_tpu_torch.tensor.policy import cast_compute


class CAdd(Module):
    """Adds a learnable ``bias`` of shape ``size`` (zeros at init),
    broadcast against the input."""

    def __init__(self, size: Sequence[int], name=None):
        super().__init__(name)
        self.size = tuple(size)
        self.bias = nn.Parameter(torch.zeros(self.size))

    def forward(self, x):
        return x + self.bias


class Select(Module):
    """Takes index ``index`` along ``dim`` and drops that dim (0-based;
    negative indices count from the end)."""

    def __init__(self, dim: int, index: int, name=None):
        super().__init__(name)
        self.dim, self.index = dim, index

    def forward(self, x):
        return x.select(self.dim, self.index)


class CMaxTable(Module):
    """Elementwise maximum of a table input."""

    def forward(self, *xs):
        xs = _table(xs)
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out


class CAveTable(Module):
    """Elementwise mean of a table input."""

    def forward(self, *xs):
        xs = _table(xs)
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out / len(xs)


class DotProduct(Module):
    """Dot product of two tensors over the last axis."""

    def forward(self, *xs):
        a, b = _table(xs)
        return (a * b).sum(dim=-1)


class CosineDistance(Module):
    """Cosine similarity of two tensors over the last axis (the
    similarity, as the reference's ``CosineDistance`` outputs), the
    product of the norms floored at ``eps``."""

    def __init__(self, eps: float = 1e-8, name=None):
        super().__init__(name)
        self.eps = eps

    def forward(self, *xs):
        a, b = _table(xs)
        num = (a * b).sum(dim=-1)
        den = (torch.linalg.vector_norm(a, dim=-1)
               * torch.linalg.vector_norm(b, dim=-1))
        return num / torch.clamp(den, min=self.eps)


class Maxout(Module):
    """A Linear to ``out_features * pool_size`` units (``weight`` (in,
    out * pool), ``bias``), then the max over each run of ``pool_size``
    (the JAX layer's plain float32 product)."""

    def __init__(self, in_features: int, out_features: int,
                 pool_size: int = 2,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.in_features = in_features
        self.out_features = out_features
        self.pool_size = pool_size
        total = out_features * pool_size
        self.weight = nn.Parameter(init_mod.xavier(
            generator, (in_features, total), in_features, total))
        self.bias = nn.Parameter(torch.zeros(total))

    def forward(self, x):
        y = x @ self.weight + self.bias
        y = y.reshape(*y.shape[:-1], self.out_features, self.pool_size)
        return y.amax(dim=-1)


class CSubTable(Module):
    """``a - b`` of a two-tensor table input."""

    def forward(self, *xs):
        a, b = _table(xs)
        return a - b


class CDivTable(Module):
    """``a / b`` of a two-tensor table input."""

    def forward(self, *xs):
        a, b = _table(xs)
        return a / b


class AddConstant(Module):
    def __init__(self, constant: float, name=None):
        super().__init__(name)
        self.constant = constant

    def forward(self, x):
        return x + self.constant


class MulConstant(Module):
    def __init__(self, constant: float, name=None):
        super().__init__(name)
        self.constant = constant

    def forward(self, x):
        return x * self.constant


class LogSigmoid(Module):
    def forward(self, x):
        return F.logsigmoid(x)


class Mean(Module):
    """The mean over ``dim`` (0-based)."""

    def __init__(self, dim: int = 1, keepdims: bool = False, name=None):
        super().__init__(name)
        self.dim, self.keepdims = dim, keepdims

    def forward(self, x):
        return x.mean(dim=self.dim, keepdim=self.keepdims)


def _transpose_pads(k: int, s: int, padding: str):
    """``jax.lax.conv_transpose``'s (before, after) pad of one spatial
    dim for a string padding."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    elif padding == "VALID":
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    else:
        raise ValueError(f"padding {padding!r}: 'SAME', 'VALID' or ints")
    return pad_a, pad_len - pad_a


class Conv2DTranspose(Module):
    """Transposed 2-D convolution, NHWC, as the JAX layer computes it
    (``lax.conv_transpose(..., transpose_kernel=True)``): the weight is
    stored (kh, kw, out, in), in forward-conv orientation, and an integer
    ``padding`` trims the output as torch's ``ConvTranspose2d`` does.
    The input is dilated by the stride, padded and convolved with the
    spatially flipped kernel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding: Union[str, int] = 0,
                 with_bias: bool = True, weight_init=init_mod.msra,
                 bias_init=init_mod.zeros,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        self.with_bias = with_bias
        kh, kw = self.kernel_size
        fan_in = in_channels * kh * kw
        fan_out = out_channels * kh * kw
        self.weight = nn.Parameter(weight_init(
            generator, (kh, kw, out_channels, in_channels), fan_in,
            fan_out).float())
        self.bias = (nn.Parameter(bias_init(
            generator, (out_channels,), fan_in, fan_out).float())
            if with_bias else None)

    def _pads(self):
        if isinstance(self.padding, str):
            return [_transpose_pads(k, s, self.padding.upper())
                    for k, s in zip(self.kernel_size, self.stride)]
        return [(k - 1 - p, k - 1 - p)
                for k, p in zip(self.kernel_size, _pair(self.padding))]

    def forward(self, x):
        xc, wc = cast_compute(x, self.weight)
        xn = xc.permute(0, 3, 1, 2)
        n, c, h, w = xn.shape
        sh, sw = self.stride
        if (sh, sw) != (1, 1):
            z = xn.new_zeros(n, c, (h - 1) * sh + 1, (w - 1) * sw + 1)
            z[:, :, ::sh, ::sw] = xn
            xn = z
        (ha, hb), (wa, wb) = self._pads()
        xn = F.pad(xn, (wa, wb, ha, hb))
        # (kh, kw, out, in) flipped in space -> torch (out, in, kh, kw)
        k = torch.flip(wc, (0, 1)).permute(2, 3, 0, 1)
        y = F.conv2d(xn, k).permute(0, 2, 3, 1)
        if self.bias is not None:
            y = y.float() + self.bias
        return y.to(x.dtype)


class UpSampling2D(Module):
    """NHWC upsampling by integer factors: ``"nearest"`` repeats rows and
    columns, ``"bilinear"`` samples at half-pixel centres (the JAX
    ``jax.image.resize``; torch's ``align_corners=False``)."""

    def __init__(self, size=2, mode: str = "nearest", name=None):
        super().__init__(name)
        self.size = _pair(size)
        self.mode = mode

    def forward(self, x):
        sh, sw = self.size
        if self.mode == "nearest":
            return x.repeat_interleave(sh, dim=1).repeat_interleave(sw,
                                                                    dim=2)
        y = F.interpolate(x.permute(0, 3, 1, 2),
                          size=(x.shape[1] * sh, x.shape[2] * sw),
                          mode="bilinear", align_corners=False)
        return y.permute(0, 2, 3, 1)
