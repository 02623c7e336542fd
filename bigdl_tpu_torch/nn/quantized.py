"""Int8 quantization of trained modules — the port of
``bigdl_tpu.nn.quantized``.

Two halves:

- The module swap.  :func:`quantize` returns a new module in which every
  ``Linear`` and ``Conv2D`` is an int8 twin: :class:`QuantizedLinear` /
  :class:`QuantizedConv2D`, whose forward quantizes its activations and
  multiplies on the int8 matmul kernel (``ops.quantized``), or with
  ``weight_only=True`` :class:`WeightOnlyLinear` /
  :class:`WeightOnlyConv2D`, int8 weights dequantized at each call.
  :func:`calibrate` derives static activation scales for it.  The twins
  hold their int8 weights, scales and bias as buffers named as the JAX
  twins' params (``weight_q``, ``scales``, ``act_scale``, ``bias``).
- Weight-only int8 storage of a params tree (``quantize_params`` /
  ``dequantize_params`` / ``is_quantized_params``).  A params tree is a
  nested dict of tensors (``utils.convert.export_params`` keys, or a flat
  ``{name: tensor}`` dict of ``named_parameters()``).  Every floating 2-D
  leaf with both dims >= ``min_dim`` (embedding, attention projections,
  FFN weights) becomes ``{"__w8__": int8 (in, out), "scale": float32
  (out,)}``, per-out-column abs-max scales; biases and LayerNorm vectors
  stay float32.  :class:`Int8Weights` holds a copy of a module with its
  matmul weights that way at rest and lends the copy a float32 view for
  the length of a ``with`` block.

One divergence from the JAX package: its ``quantize`` and ``calibrate``
recurse only through containers, so the convs inside a ResNet
``BasicBlock`` / ``Bottleneck`` (modules with ``body`` / ``proj``) stay
float there; here every ``Linear`` and ``Conv2D`` of the module tree is
swapped and calibrated."""

import copy
import threading
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers import Conv2D, Linear, conv2d_nhwc, conv_pads
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.quantized import quantize_int8, quantized_linear
from bigdl_tpu_torch.tensor.policy import cast_compute, get_compute_dtype

_Q8_KEY = "__w8__"


def quantize_params(params: Dict[str, Any], min_dim: int = 16
                    ) -> Dict[str, Any]:
    """Weight-only int8 quantization of a params tree (a new tree; the
    input is not changed).  Idempotent on an already-quantized tree."""

    def rec(p):
        if isinstance(p, dict):
            if _Q8_KEY in p:
                return p
            return {k: rec(v) for k, v in p.items()}
        if (isinstance(p, torch.Tensor) and p.ndim == 2
                and p.shape[0] >= min_dim and p.shape[1] >= min_dim
                and p.is_floating_point()):
            w_q, scales = quantize_int8(p.detach().float(), axis=0)
            return {_Q8_KEY: w_q, "scale": scales}
        return p

    return rec(params)


def dequantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`quantize_params`: every ``__w8__`` subtree back
    to its float32 matrix."""

    def rec(p):
        if isinstance(p, dict):
            if _Q8_KEY in p:
                return p[_Q8_KEY].float() * p["scale"]
            return {k: rec(v) for k, v in p.items()}
        return p

    return rec(params)


def is_quantized_params(params) -> bool:
    """True when the tree holds at least one ``__w8__`` subtree."""
    if isinstance(params, dict):
        if _Q8_KEY in params:
            return True
        return any(is_quantized_params(v) for v in params.values())
    return False


class Int8Weights:
    """A copy of ``module`` whose matmul weights are stored int8 at rest.

    ``self.module`` is a twin of ``module`` (the caller's module and its
    parameters are left as they are).  In the twin every parameter
    :func:`quantize_params` quantizes starts as an empty tensor; its int8
    payload and scales are kept here.  ``with weights.view():`` gives
    each of them its dequantized float32 value for the length of the
    block and empties it again afterwards, so the float32 copy exists
    only while a call runs.  Other holders of the twin's ``Parameter``
    objects (a weight-sharing draft) see the same view.  A view is held
    by one thread at a time (an engine call, or a caller's forward
    between calls)."""

    def __init__(self, module: torch.nn.Module, min_dim: int = 16):
        named = dict(module.named_parameters())
        q = quantize_params(named, min_dim=min_dim)
        self._q = {}
        # the quantized leaves enter the copy as empty parameters, so
        # their float32 data is never duplicated
        memo = {}
        for name, leaf in q.items():
            if isinstance(leaf, dict):
                p = named[name]
                twin = torch.nn.Parameter(p.data.new_empty((0,)),
                                          requires_grad=p.requires_grad)
                memo[id(p)] = twin
                self._q[name] = (twin, leaf[_Q8_KEY], leaf["scale"])
        self.module = copy.deepcopy(module, memo)
        self._depth = 0
        self._lock = threading.RLock()

    @property
    def names(self):
        return sorted(self._q)

    def nbytes(self) -> int:
        """Bytes held at rest: int8 payloads and float32 scales."""
        return sum(w.numel() + 4 * s.numel() for _, w, s in self._q.values())

    @contextmanager
    def view(self):
        """Dequantized float32 weights for the length of the block
        (re-entrant: the outermost block builds and releases them; another
        thread's block waits for it)."""
        with self._lock:
            if self._depth == 0:
                with torch.no_grad():
                    for p, w, s in self._q.values():
                        p.data = w.float() * s
            self._depth += 1
            try:
                yield
            finally:
                self._depth -= 1
                if self._depth == 0:
                    for p, _, _ in self._q.values():
                        p.data = p.data.new_empty((0,))


# ---------------------------------------------------------------------------
# the module swap
# ---------------------------------------------------------------------------


def _f32(v, device) -> Optional[torch.Tensor]:
    return (None if v is None
            else torch.as_tensor(v, dtype=torch.float32, device=device))


def _detached(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().float().clone()


def _k_major(w_q: torch.Tensor) -> torch.Tensor:
    """An int8 weight (..., K, N) with the same values and bytes, held
    K-major: a transposed view of a contiguous (..., N, K), the layout the
    int8 kernel reads its weight in.  Copies only a weight not yet held
    that way; ``.to()``, ``deepcopy`` and ``load_state_dict`` keep the
    layout."""
    return w_q.transpose(-1, -2).contiguous().transpose(-1, -2)


class QuantizedLinear(Module):
    """Int8 twin of ``Linear``: an (in, out) int8 weight with per-out-column
    scales, activations quantized per row (dynamic) or by a calibrated
    ``act_scale``, the product and its rescale on the int8 kernel
    (:func:`ops.quantized.quantized_linear`).  ``weight_q`` reads (in,
    out), as the JAX twin's, but is held K-major (see :func:`_k_major`)."""

    def __init__(self, weight_q, scales, bias=None, act_scale=None,
                 name=None):
        super().__init__(name)
        self.out_features = weight_q.shape[1]
        self.with_bias = bias is not None
        self.register_buffer("weight_q", _k_major(weight_q))
        self.register_buffer("scales", scales)
        self.register_buffer("act_scale", act_scale)
        self.register_buffer("bias", bias)

    @staticmethod
    def from_linear(layer: Linear, act_scale=None) -> "QuantizedLinear":
        w = layer.weight.detach().float()
        if act_scale is not None and np.ndim(act_scale) == 1:
            # per-channel activation scales fold into the weight rows; the
            # output rescale then needs no activation factor
            w = w * _f32(act_scale, w.device)[:, None]
        w_q, scales = quantize_int8(w, axis=0)
        return QuantizedLinear(w_q, scales, _detached(layer.bias),
                               _f32(act_scale, w.device), name=layer.name)

    def forward(self, x):
        return quantized_linear(x, self.weight_q, self.scales, self.bias,
                                act_scale=self.act_scale)


class _ConvConfig(Module):
    """The geometry of a ``Conv2D`` (not its float weight)."""

    def __init__(self, conv: Conv2D, bias, name=None):
        super().__init__(name or conv.name)
        self.kernel_size, self.stride = conv.kernel_size, conv.stride
        self.padding, self.dilation = conv.padding, conv.dilation
        self.groups = conv.groups
        self.out_channels = conv.out_channels
        self.with_bias = bias is not None
        self.register_buffer("bias", bias)

    def pads(self, x):
        return conv_pads(self.padding, x.shape[1:3], self.kernel_size,
                         self.stride, self.dilation)


class QuantizedConv2D(_ConvConfig):
    """Int8 twin of ``Conv2D``: the conv lowered to patch extraction
    (im2col) and the int8 matmul kernel.  Patch features are
    channel-major ``(C, kh, kw)``, the order of the JAX
    ``conv_general_dilated_patches``, and the weight's rows are stored in
    that order.  ``groups > 1`` multiplies each group on its own
    kernel launch.  ``weight_q`` reads as the JAX twin's but is held
    K-major (see :func:`_k_major`)."""

    def __init__(self, conv: Conv2D, weight_q, scales, bias=None,
                 act_scale=None, name=None):
        super().__init__(conv, bias, name)
        # (rows, out), or (g, rows, out / g) with groups
        self.register_buffer("weight_q", _k_major(weight_q))
        self.register_buffer("scales", scales)
        self.register_buffer("act_scale", act_scale)

    @staticmethod
    def from_conv(layer: Conv2D, act_scale=None) -> "QuantizedConv2D":
        w = layer.weight.detach().float()
        kh, kw, cin_g, cout = w.shape
        g = layer.groups
        w2 = w.permute(2, 0, 1, 3).reshape(cin_g * kh * kw, cout)
        if g > 1:
            # group j's output columns consume its input channels' rows
            og = cout // g
            w2 = torch.stack([w2[:, j * og:(j + 1) * og] for j in range(g)])
        if act_scale is not None and np.ndim(act_scale) == 1:
            # per-input-channel scales, expanded to the channel-major patch
            # rows and folded into the weight
            act_scale = np.repeat(np.asarray(act_scale, np.float32)
                                  .reshape(g, cin_g), kh * kw, axis=1)
            if g == 1:
                act_scale = act_scale[0]
            a = _f32(act_scale, w.device)
            w2 = w2 * (a[:, None] if g == 1 else a[:, :, None])
        w_q, scales = quantize_int8(w2, axis=0 if g == 1 else 1)
        return QuantizedConv2D(layer, w_q, scales, _detached(layer.bias),
                               _f32(act_scale, w.device), name=layer.name)

    def patches(self, x):
        """(n * oh * ow, C * kh * kw) float32 patches of NHWC ``x``, the
        features channel-major, and (n, oh, ow): a strided view of the
        padded input, gathered by one copy (none for a 1x1 stride-1
        conv).  Runs in the profiler range ``int8_im2col``."""
        (kh, kw), (sh, sw), (dh, dw) = (self.kernel_size, self.stride,
                                        self.dilation)
        (pt, pb), (pl, pr) = self.pads(x)
        with torch.profiler.record_function("int8_im2col"):
            xp = x.float()
            if pt or pb or pl or pr:
                xp = F.pad(xp, (0, 0, pl, pr, pt, pb))
            n, hp, wp, c = xp.shape
            oh = (hp - dh * (kh - 1) - 1) // sh + 1
            ow = (wp - dw * (kw - 1) - 1) // sw + 1
            s_n, s_h, s_w, s_c = xp.stride()
            windows = xp.as_strided(
                (n, oh, ow, c, kh, kw),
                (s_n, s_h * sh, s_w * sw, s_c, s_h * dh, s_w * dw),
                xp.storage_offset())
            p = windows.reshape(n * oh * ow, c * kh * kw)
        return p, (n, oh, ow)

    def forward(self, x):
        p, (n, oh, ow) = self.patches(x)
        g = self.groups
        if g == 1:
            y = quantized_linear(p, self.weight_q, self.scales, self.bias,
                                 act_scale=self.act_scale)
            return y.reshape(n, oh, ow, -1).to(x.dtype)
        # the channel-major rows put each group's features together; a
        # group is a dense int8 layer of its own (per-channel scales (g,
        # rows) give it its row)
        xg = p.reshape(p.shape[0], g, -1)
        act = self.act_scale
        y = torch.cat([quantized_linear(
            xg[:, j], self.weight_q[j], self.scales[j],
            act_scale=act[j] if act is not None and act.ndim == 2 else act)
            for j in range(g)], dim=1).reshape(n, oh, ow, -1)
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


def _weight_only(w: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    dt = get_compute_dtype()
    return w.to(dt) * scales.to(dt)


class WeightOnlyLinear(Module):
    """Weight-only int8 ``Linear``: the weight is stored int8 with
    per-out-column scales and dequantized into the compute dtype at each
    call; activations stay float."""

    def __init__(self, weight_q, scales, bias=None, name=None):
        super().__init__(name)
        self.out_features = weight_q.shape[1]
        self.with_bias = bias is not None
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("scales", scales)
        self.register_buffer("bias", bias)

    @staticmethod
    def from_linear(layer: Linear) -> "WeightOnlyLinear":
        w_q, scales = quantize_int8(layer.weight.detach().float(), axis=0)
        return WeightOnlyLinear(w_q, scales, _detached(layer.bias),
                                name=layer.name)

    def forward(self, x):
        y = torch.matmul(cast_compute(x),
                         _weight_only(self.weight_q, self.scales)).float()
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class WeightOnlyConv2D(_ConvConfig):
    """Weight-only int8 ``Conv2D`` (see :class:`WeightOnlyLinear`):
    per-out-channel scales over the (kh, kw, cin/groups) axes."""

    def __init__(self, conv: Conv2D, weight_q, scales, bias=None,
                 name=None):
        super().__init__(conv, bias, name)
        self.register_buffer("weight_q", weight_q)   # HWIO int8
        self.register_buffer("scales", scales)

    @staticmethod
    def from_conv(layer: Conv2D) -> "WeightOnlyConv2D":
        w = layer.weight.detach().float()
        scales = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-8) / 127.0
        w_q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
        return WeightOnlyConv2D(layer, w_q, scales, _detached(layer.bias),
                                name=layer.name)

    def forward(self, x):
        return conv2d_nhwc(x, _weight_only(self.weight_q, self.scales),
                           self.bias, self.stride, self.pads(x),
                           self.dilation, self.groups)


def _twin(leaf, calib, weight_only):
    # exact types: a subclass (BlockSparseLinear and its mask) keeps its
    # own forward
    if type(leaf) is Linear:
        return (WeightOnlyLinear.from_linear(leaf) if weight_only else
                QuantizedLinear.from_linear(leaf, calib.get(id(leaf))))
    if type(leaf) is Conv2D:
        return (WeightOnlyConv2D.from_conv(leaf) if weight_only else
                QuantizedConv2D.from_conv(leaf, calib.get(id(leaf))))
    return None


def refuse_keras_quantization(model, what: str) -> None:
    """Raise ``ValueError`` for a keras ``Model``: the JAX package
    quantizes one by swapping its nodes' layers, which the port does not
    do yet (ROADMAP item 7.1, the keras surface)."""
    from bigdl_tpu_torch.keras.engine import Model

    if isinstance(model, Model):
        raise ValueError(f"{what} of a keras Model is not ported yet "
                         f"(ROADMAP item 7.1); quantize a Container or "
                         f"the Transformer LM")


def quantize(module: torch.nn.Module,
             calib: Optional[Dict[int, Any]] = None,
             weight_only: bool = False) -> torch.nn.Module:
    """Post-training quantization: a new module (the caller's is left as
    it is) in which every ``Linear`` / ``Conv2D`` is an int8 twin on the
    same device, and every other module a copy.

    ``calib``: ``{id(leaf): activation scale}`` from :func:`calibrate`;
    a calibrated leaf quantizes its activations statically (a scalar, or
    per input channel), the others per row at each call.
    ``weight_only=True``: int8 weights, float activations."""
    if not isinstance(module, torch.nn.Module):
        raise ValueError(f"quantize takes a module of the port, got "
                         f"{type(module).__name__}")
    refuse_keras_quantization(module, "quantize()")
    calib = calib or {}
    memo = {}
    for leaf in module.modules():
        twin = _twin(leaf, calib, weight_only)
        if twin is not None:
            memo[id(leaf)] = twin
    # the twins enter the copy in their leaves' places, so the float
    # weights they replace are never copied
    if id(module) in memo:
        return memo[id(module)]
    return copy.deepcopy(module, memo)


def calibrate(module: torch.nn.Module, batches: Iterable,
              method: str = "percentile", percentile: float = 99.9,
              granularity: str = "tensor") -> Dict[int, Any]:
    """Run a calibration set through ``module`` (in eval mode, no grad)
    and derive static activation scales for every ``Linear`` and
    ``Conv2D`` with ``groups == 1``, from the absolute values of its
    inputs (at most 8192 a batch, a fixed-stride subsample of rows).

    ``method``: ``"minmax"`` (abs-max over the set) or ``"percentile"``
    (the given abs-percentile).  ``granularity``: ``"tensor"`` (one
    scalar a leaf) or ``"channel"`` (one scale per input channel, folded
    into the weight rows by :func:`quantize`).  Returns ``{id(leaf):
    scale}`` for :func:`quantize`'s ``calib``."""
    refuse_keras_quantization(module, "calibrate()")
    if method not in ("minmax", "percentile"):
        raise ValueError("method: minmax | percentile")
    if granularity not in ("tensor", "channel"):
        raise ValueError("granularity: tensor | channel")
    store: Dict[int, list] = {}
    cap = 8192

    def record(leaf, inputs):
        x = inputs[0]
        a = np.abs(x.detach().float().cpu().numpy()).reshape(-1, x.shape[-1])
        if a.shape[0] * a.shape[1] > cap:
            stride = max(1, (a.shape[0] * a.shape[1]) // cap)
            a = a[::stride][: max(1, cap // a.shape[1])]
        store.setdefault(id(leaf), []).append(a)

    hooks = [m.register_forward_pre_hook(record) for m in module.modules()
             if type(m) is Linear or (type(m) is Conv2D and m.groups == 1)]
    was_training = module.training
    module.eval()
    try:
        with torch.no_grad():
            for x in batches:
                module(x if isinstance(x, torch.Tensor)
                       else torch.as_tensor(np.asarray(x)))
    finally:
        for h in hooks:
            h.remove()
        module.train(was_training)
    out: Dict[int, Any] = {}
    for key, chunks in store.items():
        a = np.concatenate(chunks)
        if granularity == "channel":
            amax = (a.max(axis=0) if method == "minmax"
                    else np.percentile(a, percentile, axis=0))
            out[key] = np.maximum(amax, 1e-8).astype(np.float32) / 127.0
        else:
            amax = (float(np.max(a)) if method == "minmax"
                    else float(np.percentile(a, percentile)))
            out[key] = max(amax, 1e-8) / 127.0
    return out
