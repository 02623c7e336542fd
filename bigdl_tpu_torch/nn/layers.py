"""Core layers — the port of ``bigdl_tpu.nn.layers``.

Layouts and numerics follow the JAX package:

- ``Linear`` stores its weight (in, out) and computes ``x @ W + b``.
- Images are NHWC at every interface and conv kernels are stored HWIO.
  Inside, ``x.permute(0, 3, 1, 2)`` is an NCHW view of the same
  (channels-last) memory, which ``F.conv2d`` and the pools take.
- ``"SAME"`` padding is XLA's: the total pad of a dim goes ``total // 2``
  before and the rest after, so a stride-2 conv pads more after than
  before (torch's ``padding=`` is symmetric).  Pads are computed here
  and applied with ``F.pad``.
- Matmuls and convs take their inputs in the compute dtype
  (``tensor.policy``) and add the bias in float32.  A matmul's result
  is float32 unrounded (``policy.matmul_f32``); a bfloat16 conv's
  output rounds to bfloat16 and is widened before the bias, as the JAX
  ``_conv_accum`` leaves it.
- BatchNorm keeps ``running_mean`` / ``running_var`` as buffers and
  updates them in place in training mode (the JAX package returns them
  as new state), with the JAX single-pass shifted statistics.

Layers draw their weights from an explicit ``torch.Generator``
(``nn.init``) and need their input widths at construction, except
``Linear(out)``, ``BatchNorm()`` and ``PReLU()``: as the JAX ``build``
does, these take their width from their first input (:class:`_LazyWidth`;
``Optimizer`` runs one sample row through a model that has any)."""

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from bigdl_tpu_torch.nn import init as init_mod
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.tensor.policy import cast_compute, matmul_f32
from bigdl_tpu_torch.utils import prng

PadLike = Union[str, int, Tuple[int, int]]


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t.float())


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------


class _LazyWidth:
    """Mixin of a layer whose width may come from its first input: its
    tensors start as torch's uninitialized parameters and buffers, and
    a forward pre-hook calls ``_build(width, device)`` once, with the
    last dim of that input, then removes itself."""

    def _defer(self) -> None:
        self._lazy_hook = self.register_forward_pre_hook(
            _LazyWidth._first_call)

    @staticmethod
    def _first_call(module, args):
        x = args[0]
        with torch.no_grad():
            module._build(x.shape[-1], x.device)
        module._lazy_hook.remove()
        del module._lazy_hook


def _materialize(t, value: torch.Tensor, device) -> None:
    t.materialize(tuple(value.shape), device=device, dtype=torch.float32)
    t.copy_(value)


def has_lazy(module: nn.Module) -> bool:
    """Whether any tensor of ``module`` waits for its first input."""
    return any(isinstance(t, (UninitializedParameter, UninitializedBuffer))
               for t in list(module.parameters()) + list(module.buffers()))


class Linear(_LazyWidth, Module):
    """Fully-connected layer, weight (in, out), forward ``x @ W + b``.
    ``Linear(out)`` takes ``in`` from its first input."""

    def __init__(self, in_features: Optional[int] = None,
                 out_features: int = 0, with_bias: bool = True,
                 weight_init=init_mod.xavier, bias_init=init_mod.zeros,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        if out_features == 0 and in_features is not None:
            in_features, out_features = None, in_features
        self.in_features = in_features
        self.out_features = out_features
        self.with_bias = with_bias
        init = (weight_init, bias_init, generator)
        if in_features is None:
            self.weight = UninitializedParameter()
            self.bias = UninitializedParameter() if with_bias else None
            self._lazy_init = init      # dropped once built
            self._defer()
        else:
            w, b = self._draw(in_features, *init)
            self.weight = _param(w)
            self.bias = _param(b) if with_bias else None

    def _draw(self, fan_in: int, weight_init, bias_init, g):
        out = self.out_features
        w = weight_init(g, (fan_in, out), fan_in, out)
        b = bias_init(g, (out,), fan_in, out) if self.with_bias else None
        return w, b

    def _build(self, width: int, device) -> None:
        self.in_features = width
        w, b = self._draw(width, *self._lazy_init)
        del self._lazy_init
        _materialize(self.weight, w, device)
        if self.bias is not None:
            _materialize(self.bias, b, device)

    def forward(self, x):
        y = matmul_f32(x, self.weight)
        if self.bias is not None:
            y = y + self.bias          # added in the float32 accumulation
        return y.to(x.dtype)


Dense = Linear


# ---------------------------------------------------------------------------
# Convolutions (NHWC / HWIO)
# ---------------------------------------------------------------------------


def same_pads(n: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim of size ``n`` for a
    window ``k`` with stride ``s`` and dilation ``d``: (before, after)."""
    out = -(-n // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
    return total // 2, total - total // 2


def conv_pads(padding: PadLike, spatial: Sequence[int],
              kernel: Sequence[int], stride: Sequence[int],
              dilation: Sequence[int]):
    """(before, after) pads of each spatial dim, as the JAX package pads:
    ``"SAME"`` / ``"VALID"`` (any case), or an int or a pair
    (symmetric)."""
    if isinstance(padding, str):
        mode = padding.upper()
        if mode not in ("SAME", "VALID"):
            raise ValueError(f"padding {padding!r}: SAME | VALID | ints")
    else:
        pads = _pair(padding) if len(spatial) == 2 else (padding,)
        # -1 is the reference's spelling of SAME for 2-D convs
        mode = ("SAME" if len(spatial) == 2 and all(p == -1 for p in pads)
                else None)
    if mode == "SAME":
        return [same_pads(n, k, s, d) for n, k, s, d in
                zip(spatial, kernel, stride, dilation)]
    if mode == "VALID":
        return [(0, 0)] * len(spatial)
    return [(int(p), int(p)) for p in pads]


def _pad_nchw(x, pads, value=0.0):
    """``F.pad`` of the trailing spatial dims by ``pads`` (outer first)."""
    flat = [p for before_after in reversed(pads) for p in before_after]
    return F.pad(x, flat, value=value) if any(flat) else x


def conv2d_nhwc(x, w, bias, stride, pads, dilation, groups):
    """NHWC conv with an HWIO kernel ``w`` and explicit (before, after)
    ``pads`` per spatial dim; the bias is added in float32.  In the
    compute dtype bfloat16 the conv's output is bfloat16 (float32 sums
    inside, one rounding out), widened before the bias."""
    xc, wc = cast_compute(x, w)
    xn = _pad_nchw(xc.permute(0, 3, 1, 2), pads)
    y = F.conv2d(xn, wc.permute(3, 2, 0, 1), None, stride, 0, dilation,
                 groups).permute(0, 2, 3, 1)
    if bias is not None:
        y = y.float() + bias
    return y.to(x.dtype)


class Conv2D(Module):
    """2-D convolution, NHWC in and out, weight (kh, kw, cin/groups,
    cout), with ``groups`` and ``dilation``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size,
                 stride=1, padding: PadLike = 0, dilation=1,
                 groups: int = 1, with_bias: bool = True,
                 weight_init=init_mod.msra, bias_init=init_mod.zeros,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"channels {in_channels} -> {out_channels} "
                             f"do not split into {groups} groups")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = padding
        self.dilation = _pair(dilation)
        self.groups = groups
        self.with_bias = with_bias
        kh, kw = self.kernel_size
        fan_in = in_channels * kh * kw // groups
        fan_out = out_channels * kh * kw // groups
        self.weight = _param(weight_init(
            generator, (kh, kw, in_channels // groups, out_channels),
            fan_in, fan_out))
        self.bias = (_param(bias_init(generator, (out_channels,), fan_in,
                                      fan_out)) if with_bias else None)

    def pads(self, x):
        """The (before, after) pads of H and W for input ``x``."""
        return conv_pads(self.padding, x.shape[1:3], self.kernel_size,
                         self.stride, self.dilation)

    def forward(self, x):
        return conv2d_nhwc(x, self.weight, self.bias, self.stride,
                           self.pads(x), self.dilation, self.groups)


SpatialConvolution = Conv2D


class Conv1D(Module):
    """1-D convolution (NWC, weight (k, cin/groups, cout)), with causal
    padding and dilation."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1,
                 padding: Union[str, int] = 0, dilation: int = 1,
                 groups: int = 1, with_bias: bool = True,
                 causal: bool = False, weight_init=init_mod.msra,
                 bias_init=init_mod.zeros,
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.kernel_size, self.stride = kernel_size, stride
        self.padding, self.dilation = padding, dilation
        self.groups, self.causal = groups, causal
        fan_in = in_channels * kernel_size // groups
        fan_out = out_channels * kernel_size // groups
        self.weight = _param(weight_init(
            generator, (kernel_size, in_channels // groups, out_channels),
            fan_in, fan_out))
        self.bias = (_param(bias_init(generator, (out_channels,), fan_in,
                                      fan_out)) if with_bias else None)

    def forward(self, x):
        if self.causal:
            pads = [((self.kernel_size - 1) * self.dilation, 0)]
        else:
            pads = conv_pads(self.padding, x.shape[1:2],
                             (self.kernel_size,), (self.stride,),
                             (self.dilation,))
        xc, wc = cast_compute(x, self.weight)
        xn = _pad_nchw(xc.permute(0, 2, 1), pads)
        y = F.conv1d(xn, wc.permute(2, 1, 0), None, self.stride, 0,
                     self.dilation, self.groups).permute(0, 2, 1)
        if self.bias is not None:
            y = y.float() + self.bias
        return y.to(x.dtype)


TemporalConvolution = Conv1D


# ---------------------------------------------------------------------------
# Pooling (NHWC)
# ---------------------------------------------------------------------------


class _Pool2D(Module):
    def __init__(self, kernel_size, stride=None, padding: PadLike = 0,
                 ceil_mode: bool = False, name=None):
        super().__init__(name)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride if stride is not None else kernel_size)
        self.padding = padding
        self.ceil_mode = ceil_mode

    def _pads(self, x):
        if isinstance(self.padding, str):
            if self.ceil_mode:
                raise NotImplementedError("ceil_mode with string padding")
            return conv_pads(self.padding, x.shape[1:3], self.kernel_size,
                             self.stride, (1, 1))
        pads = [[p, p] for p in _pair(self.padding)]
        if self.ceil_mode:
            # extra bottom/right padding so the last partial window counts
            for i, (n, k, s) in enumerate(
                    zip(x.shape[1:3], self.kernel_size, self.stride)):
                p = pads[i][0]
                ceil_out = -(-(n + 2 * p - k) // s) + 1
                pads[i][1] += max(0, (ceil_out - 1) * s + k - (n + 2 * p))
        return pads

    def _pool(self, x, fn, fill):
        from bigdl_tpu_torch.parallel import local_ops

        if local_ops.is_dtensor(x):
            # a layout: each rank pools its own rows and channels
            return local_ops.spatial(lambda t: self._pool(t, fn, fill), x)
        xn = _pad_nchw(x.permute(0, 3, 1, 2), self._pads(x), fill)
        return fn(xn, self.kernel_size, self.stride).permute(0, 2, 3, 1)


class MaxPool2D(_Pool2D):
    """Max pooling over -inf padding (NHWC)."""

    def forward(self, x):
        return self._pool(x, F.max_pool2d, float("-inf"))


class AvgPool2D(_Pool2D):
    """Average pooling over zero padding; every window divides by
    kh * kw (padding counted)."""

    def forward(self, x):
        return self._pool(x, F.avg_pool2d, 0.0)


class GlobalAvgPool2D(Module):
    def forward(self, x):
        return x.mean(dim=(1, 2))


SpatialMaxPooling = MaxPool2D
SpatialAveragePooling = AvgPool2D


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


class BatchNorm(_LazyWidth, Module):
    """Batch normalization over every axis but the last (NHWC images, or
    (N, C)).  eps 1e-5, momentum 0.1.  In training mode the statistics
    are the batch's, taken in one pass shifted by the running mean as
    the JAX layer takes them, and the running buffers move towards them
    (with the biased variance); in eval mode the running buffers are
    used.  ``BatchNorm()`` takes its width from its first input."""

    def __init__(self, num_features: Optional[int] = None,
                 eps: float = 1e-5, momentum: float = 0.1,
                 affine: bool = True, name=None):
        super().__init__(name)
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if num_features is None:
            if affine:
                self.weight = UninitializedParameter()
                self.bias = UninitializedParameter()
            else:
                self.weight = self.bias = None
            self.register_buffer("running_mean", UninitializedBuffer())
            self.register_buffer("running_var", UninitializedBuffer())
            self._defer()
            return
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.weight = self.bias = None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def _build(self, width: int, device) -> None:
        self.num_features = width
        if self.affine:
            _materialize(self.weight, torch.ones(width), device)
            _materialize(self.bias, torch.zeros(width), device)
        _materialize(self.running_mean, torch.zeros(width), device)
        _materialize(self.running_var, torch.ones(width), device)

    # set by the train step's remat while it recomputes this layer: the
    # running mean the first run shifted by; the recompute takes it and
    # leaves the running buffers alone
    replay_shift: Optional[torch.Tensor] = None

    def forward(self, x):
        if self.training:
            axes = tuple(range(x.ndim - 1))
            replay = self.replay_shift
            shift = (self.running_mean if replay is None else replay).float()
            d = x.float() - shift
            dmean = d.mean(dim=axes)
            var = torch.clamp(d.square().mean(dim=axes) - dmean.square(),
                              min=0.0)
            mean = dmean + shift
            if replay is None:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_((1 - m) * self.running_mean
                                            + m * mean)
                    self.running_var.copy_((1 - m) * self.running_var
                                           + m * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight + self.bias
        return y.to(x.dtype)


BatchNormalization = BatchNorm
SpatialBatchNormalization = BatchNorm


class LayerNorm(Module):
    """Normalizes over the last axis; statistics in float32, eps 1e-6."""

    def __init__(self, num_features: int, eps: float = 1e-6, name=None):
        super().__init__(name)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class RMSNorm(Module):
    """RMS normalization over the last axis."""

    def __init__(self, num_features: int, eps: float = 1e-6, name=None):
        super().__init__(name)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))

    def forward(self, x):
        x32 = x.float()
        y = x32 * torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True)
                              + self.eps)
        return (y * self.weight).to(x.dtype)


# ---------------------------------------------------------------------------
# Regularization / shape / embedding
# ---------------------------------------------------------------------------


class Dropout(Module):
    """Inverted dropout in training; the identity at inference.  ``p`` is
    the drop probability.  The mask is ``prng.bernoulli(key, 1 - p,
    x.shape)``, the JAX package's draw bit for bit, so the same key drops
    the same elements."""

    def __init__(self, p: float = 0.5, name=None):
        super().__init__(name)
        self.p = float(p)

    def forward(self, x, key=None):
        if not self.training or self.p == 0.0:
            return x
        if key is None:
            raise ValueError("Dropout in training mode requires a key "
                             "(utils.prng)")
        keep = 1.0 - self.p
        mask = prng.bernoulli(key, keep, x.shape)
        return torch.where(mask, x / keep, 0.0).to(x.dtype)


class Reshape(Module):
    """Reshape of the non-batch dims (or of the whole tensor with
    ``batch_mode=False``)."""

    def __init__(self, shape: Sequence[int], batch_mode: bool = True,
                 name=None):
        super().__init__(name)
        self.shape = tuple(shape)
        self.batch_mode = batch_mode

    def forward(self, x):
        if self.batch_mode:
            return x.reshape((x.shape[0],) + self.shape)
        return x.reshape(self.shape)


class View(Reshape):
    pass


class Flatten(Module):
    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Squeeze(Module):
    def __init__(self, dim=None, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return x.squeeze() if self.dim is None else x.squeeze(self.dim)


class Unsqueeze(Module):
    def __init__(self, dim: int, name=None):
        super().__init__(name)
        self.dim = dim

    def forward(self, x):
        return x.unsqueeze(self.dim)


class Transpose(Module):
    def __init__(self, perm: Sequence[int], name=None):
        super().__init__(name)
        self.perm = tuple(perm)

    def forward(self, x):
        return x.permute(self.perm)


class Embedding(Module):
    """Lookup table (0-based indices), weight (num, dim)."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_init=init_mod.random_normal(0.0, 1.0),
                 generator: Optional[torch.Generator] = None, name=None):
        super().__init__(name)
        self.weight = _param(weight_init(
            generator, (num_embeddings, embedding_dim), num_embeddings,
            embedding_dim))

    def forward(self, x):
        return self.weight[x.long()]


LookupTable = Embedding


class ZeroPadding2D(Module):
    """Zero padding of H and W (NHWC)."""

    def __init__(self, padding, name=None):
        super().__init__(name)
        self.padding = _pair(padding)

    def forward(self, x):
        ph, pw = self.padding
        return F.pad(x, (0, 0, pw, pw, ph, ph))


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _act(fn, cls_name):
    class _Act(Module):
        def __init__(self, name=None):
            super().__init__(name or cls_name)

        def forward(self, x):
            return fn(x)

    _Act.__name__ = _Act.__qualname__ = cls_name
    return _Act


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


ReLU = _act(torch.relu, "ReLU")
ReLU6 = _act(F.relu6, "ReLU6")
Tanh = _act(torch.tanh, "Tanh")
Sigmoid = _act(torch.sigmoid, "Sigmoid")
# jax.nn.gelu defaults to the tanh approximation
GELU = _act(lambda x: F.gelu(x, approximate="tanh"), "GELU")
SiLU = _act(F.silu, "SiLU")
Swish = SiLU
SoftPlus = _act(_softplus, "SoftPlus")
SoftSign = _act(F.softsign, "SoftSign")
HardSigmoid = _act(F.hardsigmoid, "HardSigmoid")   # relu6(x + 3) / 6
HardSwish = _act(F.hardswish, "HardSwish")         # x * relu6(x + 3) / 6


class SoftMax(Module):
    def __init__(self, axis: int = -1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.softmax(x, dim=self.axis)


class LogSoftMax(Module):
    def __init__(self, axis: int = -1, name=None):
        super().__init__(name)
        self.axis = axis

    def forward(self, x):
        return torch.log_softmax(x, dim=self.axis)


class LeakyReLU(Module):
    def __init__(self, negval: float = 0.01, name=None):
        super().__init__(name)
        self.negval = negval

    def forward(self, x):
        return F.leaky_relu(x, self.negval)


class ELU(Module):
    def __init__(self, alpha: float = 1.0, name=None):
        super().__init__(name)
        self.alpha = alpha

    def forward(self, x):
        return F.elu(x, self.alpha)


class PReLU(_LazyWidth, Module):
    """x where x >= 0, else alpha * x, with one learned ``alpha`` per
    channel (the last axis), initialised to ``init_alpha``; the width
    comes from the first input unless ``num_features`` is given."""

    def __init__(self, init_alpha: float = 0.25,
                 num_features: Optional[int] = None, name=None):
        super().__init__(name)
        self.init_alpha = init_alpha
        if num_features is None:
            self.alpha = UninitializedParameter()
            self._defer()
        else:
            self.alpha = _param(torch.full((num_features,), init_alpha))

    def _build(self, width: int, device) -> None:
        _materialize(self.alpha, torch.full((width,), self.init_alpha),
                     device)

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class HardTanh(Module):
    def __init__(self, min_value=-1.0, max_value=1.0, name=None):
        super().__init__(name)
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x):
        return torch.clamp(x, self.min_value, self.max_value)
