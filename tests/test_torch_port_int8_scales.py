"""The int8 scales are the correctly rounded quotient amax / 127
(ROADMAP C.16): ``ops.quantized.abs_max_scales``, ``quantize_pages``
(with and without a floor) and ``nn.quantized.WeightOnlyConv2D.
from_conv`` against the float64 quotient rounded to float32, on seeded
data where the multiply by float32(1/127) — what a division by a Python
scalar computes on CUDA — is shown to give other scales.  On the CPU
this holds the port to JAX's division; the card tests
(tests/test_torch_port_cuda.py) hold the card to the CPU's bits."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.quantized import WeightOnlyConv2D
from bigdl_tpu_torch.ops.quantized import (abs_max_scales, div127,
                                           quantize_pages)


def _amax_data(shape, seed):
    return np.random.RandomState(seed).uniform(-9.0, 9.0, shape).astype(
        np.float32)


def _exact(amax):
    """amax / 127 in float64, rounded once to float32."""
    return (np.asarray(amax, np.float64) / 127.0).astype(np.float32)


def _reciprocal(amax):
    return np.asarray(amax, np.float32) * np.float32(1.0 / 127.0)


def _differs(amax):
    """The data tells the two apart: some scales differ."""
    return int((_exact(amax) != _reciprocal(amax)).sum())


def test_div127_is_the_correctly_rounded_quotient():
    a = np.abs(_amax_data((4096,), 0))
    assert _differs(a) > 50
    np.testing.assert_array_equal(div127(torch.from_numpy(a)).numpy(),
                                  _exact(a))


@pytest.mark.parametrize("axis", [0, 1])
def test_abs_max_scales(axis):
    x = _amax_data((256, 300), 1)
    amax = np.abs(x).max(axis=axis)
    assert _differs(amax) > 0
    np.testing.assert_array_equal(
        abs_max_scales(torch.from_numpy(x), axis).numpy(), _exact(amax))


@pytest.mark.parametrize("floor", [False, True])
def test_quantize_pages(floor):
    pages = _amax_data((64, 2, 4, 8), 2)
    amax = np.abs(pages).reshape(64, -1).max(axis=1)
    assert _differs(amax) > 0
    floors = None
    if floor:
        floors = torch.zeros(64)
        floors[::4] = 0.09          # a floor above some scales
    _, scales = quantize_pages(torch.from_numpy(pages), floors)
    want = _exact(amax)
    if floor:
        want = np.maximum(want, floors.numpy())
    np.testing.assert_array_equal(scales.numpy(), want)


def test_weight_only_conv_from_conv():
    conv = nn.Conv2D(16, 256, 3, generator=torch.Generator().manual_seed(3))
    w = conv.weight.detach().numpy()
    amax = np.maximum(np.abs(w).max(axis=(0, 1, 2)), 1e-8)
    assert _differs(amax) > 0
    q = WeightOnlyConv2D.from_conv(conv)
    np.testing.assert_array_equal(q.scales.numpy(), _exact(amax))
    np.testing.assert_array_equal(
        q.weight_q.numpy(),
        np.clip(np.round(w / _exact(amax)), -127, 127).astype(np.int8))
