"""Quantization-aware training — the port of ``bigdl_tpu.nn.qat``.

:func:`prepare_qat` wraps every ``Linear`` and ``Conv2D`` in a
fake-quant twin that simulates int8 (symmetric per-out-channel weight
scales and a per-tensor activation range tracked by an EMA), with
straight-through gradients, so a few fine-tuning epochs let the weights
adapt to the int8 grid.  :func:`convert_qat` then gives the same
``QuantizedLinear`` / ``QuantizedConv2D`` model as
:func:`~bigdl_tpu_torch.nn.quantized.quantize`: the tracked ranges
become static activation scales, and inference runs the int8 matmul
kernel.

A twin holds its layer as the child ``inlined`` (the JAX paths leave it
out, ``utils.convert``), so its parameters keep the layer's JAX keys, and
its ``act_amax`` buffer is the JAX state leaf of that name.  The EMA
update is a device write in the training forward, with no host read, so
a captured step bundle replays it.

The walk is the port's ``quantize``'s: every ``Linear`` / ``Conv2D`` of
the module tree (a keras ``Model``'s node layers), where the JAX walk
recurses through containers and keras graphs only (ROADMAP C.5)."""

import copy
from typing import Dict

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.layers import Conv2D, Linear, _pad_nchw
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.quantized import quantize, swap_leaves
from bigdl_tpu_torch.ops.quantized import div127
from bigdl_tpu_torch.tensor.policy import cast_compute

__all__ = ["QATLinear", "QATConv2D", "prepare_qat", "convert_qat",
           "fake_quant"]


def fake_quant(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 fake quantization with a straight-through
    estimator: the forward rounds onto the int8 grid (half to even, as
    ``jnp.round``), the backward passes the gradient through unchanged."""
    q = torch.clamp(torch.round(x / scale), -127, 127) * scale
    return x + (q - x).detach()


def _track_amax(amax: torch.Tensor, x: torch.Tensor, ema: float,
                training: bool) -> torch.Tensor:
    """The EMA of the activation abs-max: in training the buffer
    ``amax`` is updated in place (the first tracked batch sets it)."""
    if not training:
        return amax
    with torch.no_grad():
        cur = x.detach().abs().max().float()
        new = torch.where(amax > 0, ema * amax + (1 - ema) * cur, cur)
        amax.copy_(new)
    return amax


def _fq_act(x: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
    """Fake-quantize an activation with the tracked range; an untracked
    range (``amax == 0``, an eval before any training step) passes the
    activation through as it is."""
    scale = div127(torch.clamp(amax, min=1e-8))
    return torch.where(amax > 0, fake_quant(x, scale), x)


class _QAT(Module):
    def __init__(self, inner: torch.nn.Module, ema: float = 0.99):
        super().__init__(inner.name)
        self.inlined = inner
        self.ema = float(ema)
        self.register_buffer("act_amax", torch.zeros(
            (), dtype=torch.float32, device=inner.weight.device))

    def _inputs(self, x):
        amax = _track_amax(self.act_amax, x, self.ema, self.training)
        xc, wc = cast_compute(x, self.inlined.weight)
        return _fq_act(xc.float(), amax), wc.float()


class QATLinear(_QAT):
    """Fake-quant twin of ``Linear``: its parameters, plus the
    ``act_amax`` buffer."""

    def forward(self, x):
        xq, w = self._inputs(x)
        w_scale = div127(torch.clamp(w.abs().amax(dim=0), min=1e-8))
        y = torch.matmul(xq, fake_quant(w, w_scale))
        if self.inlined.bias is not None:
            y = y + self.inlined.bias
        return y.to(x.dtype)


class QATConv2D(_QAT):
    """Fake-quant twin of ``Conv2D`` (per-out-channel weight scales); the
    conv runs in float32, as the JAX twin's."""

    def forward(self, x):
        c = self.inlined
        xq, w = self._inputs(x)
        w_scale = div127(torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-8))
        wq = fake_quant(w, w_scale)
        xn = _pad_nchw(xq.permute(0, 3, 1, 2), c.pads(x))
        y = F.conv2d(xn, wq.permute(3, 2, 0, 1), None, c.stride, 0,
                     c.dilation, c.groups).permute(0, 2, 3, 1)
        if c.bias is not None:
            y = y + c.bias
        return y.to(x.dtype)


def _wrap(leaf, ema):
    if type(leaf) is Linear:
        return QATLinear(copy.deepcopy(leaf), ema)
    if type(leaf) is Conv2D:
        return QATConv2D(copy.deepcopy(leaf), ema)
    return None


def prepare_qat(module: torch.nn.Module, ema: float = 0.99
                ) -> torch.nn.Module:
    """A new module (the caller's is left as it is) in which every
    ``Linear`` / ``Conv2D`` is a fake-quant twin over a copy of it, with
    ``act_amax`` at 0 (untracked).  Fine-tune it with any driver, then
    :func:`convert_qat`."""
    return swap_leaves(module, lambda leaf: _wrap(leaf, ema))


def convert_qat(module: torch.nn.Module) -> torch.nn.Module:
    """QAT model -> int8 inference model: each twin's tracked range
    becomes its layer's static per-tensor activation scale ``amax /
    127`` (an untracked one stays dynamic), and the unwrapped model goes
    through :func:`~bigdl_tpu_torch.nn.quantized.quantize`, so its
    layers run the int8 matmul kernel."""
    calib: Dict[int, float] = {}

    def unwrap(mod):
        if not isinstance(mod, _QAT):
            return None
        amax = float(mod.act_amax)
        if amax > 0:
            calib[id(mod.inlined)] = amax / 127.0
        return mod.inlined

    return quantize(swap_leaves(module, unwrap), calib=calib)
