"""The int8 kernel's plan, arithmetic and weight layout
(``int8_matmul.cu``), argued on the CPU before any card run.

- The plan (``int8_plan``): tiles and K splits from (M, K, N) alone;
  the splits cover K exactly and none is empty, at every product of a
  ResNet-50 forward at buckets 1, 4, 16 and 64 and at LeNet-5's ragged
  shapes; the head splits at every bucket.
- The arithmetic: int32 partials of the plan's K splits, summed in split
  order, then the fused epilogue's float32 steps (``acc * sx``, ``*
  w_scales``, ``+ bias``, each rounded once, as ``__fmul_rn`` /
  ``__fadd_rn`` round) are bit-equal to ``quantized_linear``'s tail in
  its three activation modes.
- The layout: the int8 modules hold their weights K-major in the bytes
  they held before, read ``weight_q`` in the JAX (in, out) layout, and
  keep the layout through ``deepcopy``, ``.to()`` and a state-dict round
  trip; activations come in rows padded to 16 bytes."""

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import resnet50
from bigdl_tpu_torch.nn import quantized as nq
from bigdl_tpu_torch.ops import quantized as q8
from bigdl_tpu_torch.ops.common import cdiv

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)


@pytest.fixture(scope="module")
def resnet_rows():
    """(M, K, N) of the 54 products of a batch-1 ResNet-50 forward; M
    scales with the batch."""
    model = resnet50(classes=1000, stem="conv",
                     generator=torch.Generator().manual_seed(0)).eval()
    shapes = smoke.int8_shapes(model, 1, "cpu")
    assert len(shapes) == smoke.RESNET_INT8_CALLS
    return shapes


def _check_plan(m, k, n):
    bm, bn, splits, per = q8.int8_plan(m, k, n)
    assert (bm, bn) == (128, 64 if n <= 64 else 128)
    k_tiles = cdiv(k, q8.INT8_BK)
    assert splits >= 1 and per >= 1
    # the runs of k-tiles cover K exactly, each non-empty
    runs = [(z * per, min((z + 1) * per, k_tiles)) for z in range(splits)]
    assert runs[-1][1] == k_tiles and all(a < b for a, b in runs)
    assert sum(b - a for a, b in runs) == k_tiles
    if splits > 1:
        assert cdiv(m, bm) * cdiv(n, bn) < 66 and per >= 4
    assert q8.int8_plan(m, k, n) == (bm, bn, splits, per)
    return splits


@pytest.mark.parametrize("bucket", smoke.RESNET_BUCKETS)
def test_plan_covers_k_at_every_resnet_product(resnet_rows, bucket):
    splits = [_check_plan(m * bucket, k, n) for m, k, n in resnet_rows]
    assert splits[-1] > 1                      # the head, (bucket, 2048, 1000)
    if bucket <= 4:                            # the last stage's 3x3 conv
        late = [s for (m, k, n), s in zip(resnet_rows, splits) if k == 4608]
        assert late and min(late) > 1


def test_plan_covers_k_at_lenet_and_edge_shapes():
    for m, k, n in list(smoke.LENET_INT8_SHAPES) + [(1, 147, 64),
                                                   (1, 1, 1), (3, 65, 7)]:
        _check_plan(m, k, n)
    assert q8.int8_plan(5, 0, 3)[2] == 1       # K = 0: one empty split


def _split_k_sum(x_q, w_q, per):
    """int32 partials of the K splits of ``per`` k-tiles, summed in split
    order, as the kernel's second pass sums them."""
    k = x_q.shape[1]
    step = per * q8.INT8_BK
    acc = torch.zeros(x_q.shape[0], w_q.shape[1], dtype=torch.int32)
    for k0 in range(0, k, step):
        part = x_q[:, k0:k0 + step].long() @ w_q[k0:k0 + step].long()
        assert part.abs().max() < 2 ** 31
        acc = acc + part.to(torch.int32)
    return acc


def _epilogue(acc, sx, sw, bias):
    """The fused epilogue, one float32 rounding a step: (float)acc, times
    sx (per row, scalar, or none), times sw[n], plus bias[n]."""
    y = acc.numpy().astype(np.float32)
    if sx is not None:
        y = y * np.asarray(sx, np.float32).reshape(-1, 1)
    y = y * sw.numpy().astype(np.float32)[None, :]
    if bias is not None:
        y = y + bias.numpy().astype(np.float32)[None, :]
    return torch.from_numpy(y.astype(np.float32))


# the head at bucket 16 and a late-stage 3x3 at bucket 1, both split
@pytest.mark.parametrize("mode", ["dynamic", "static", "channel"])
@pytest.mark.parametrize("m,k,n", [(16, 2048, 1000), (49, 4608, 48)])
def test_split_k_and_epilogue_equal_the_plain_tail(mode, m, k, n):
    rs = np.random.RandomState(k + n)
    x = torch.from_numpy((rs.randn(m, k) * 2).astype(np.float32))
    w = torch.from_numpy((rs.randn(k, n) * 0.1).astype(np.float32))
    b = torch.from_numpy((rs.randn(n) * 0.01).astype(np.float32))
    act = {"dynamic": None, "static": 0.03,
           "channel": rs.uniform(0.01, 0.05, k).astype(np.float32)}[mode]
    wf = w * torch.from_numpy(act)[:, None] if mode == "channel" else w
    w_q, sw = q8.quantize_int8(wf, axis=0)
    x_q, sx, per_channel = q8.quantize_activations(x, act, row_align=16)
    assert per_channel == (mode == "channel")
    _, _, splits, per = q8.int8_plan(m, k, n)
    assert splits > 1
    acc = _split_k_sum(x_q, w_q, per)
    assert torch.equal(acc, q8.int8_matmul_plain(x_q, w_q))
    model = _epilogue(acc, None if per_channel else sx, sw, b)
    # quantized_linear's tail as it stood before the epilogue was fused
    tail = acc.float() * sw[None, :] if per_channel \
        else acc.float() * sx * sw[None, :]
    tail = tail + b
    got = q8.quantized_linear(x, w_q, sw, b, act_scale=act)
    assert torch.equal(model, tail) and torch.equal(got, tail)
    # the entry the layers call, on the K-major weight
    assert torch.equal(q8.int8_matmul_nk(
        x_q, w_q.t().contiguous(), sw, None if per_channel else sx, b), tail)


def test_int8_matmul_nk_takes_padded_rows_on_the_cpu():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(37, 147).astype(np.float32))
    w_q = torch.from_numpy(rs.randint(-127, 128, (147, 64)).astype(np.int8))
    padded, sx, _ = q8.quantize_activations(x, row_align=16)
    flat, sx2, _ = q8.quantize_activations(x)
    assert padded.stride() == (160, 1) and flat.is_contiguous()
    assert torch.equal(padded, flat) and torch.equal(sx, sx2)
    want = q8.int8_matmul_plain(flat, w_q)
    assert torch.equal(q8.int8_matmul_nk(padded, w_q.t().contiguous()), want)
    assert torch.equal(q8.int8_matmul(flat, w_q), want)
    # rows already a multiple of 16 bytes stay contiguous
    assert q8.quantize_activations(x[:, :144], row_align=16)[0] \
        .is_contiguous()


def _k_major_ok(w):
    assert w.transpose(-1, -2).is_contiguous()
    assert w.untyped_storage().nbytes() == w.numel()   # one copy, 1 B each


@pytest.mark.parametrize("kind", ["linear", "conv", "conv_groups"])
def test_int8_modules_hold_k_major_weights_in_the_same_bytes(kind):
    torch.manual_seed(0)
    if kind == "linear":
        layer = nn.Linear(48, 40)
        w = layer.weight.detach()
        q = nq.QuantizedLinear.from_linear(layer)
        x = torch.randn(3, 48)
    else:
        g = 2 if kind == "conv_groups" else 1
        layer = nn.Conv2D(8, 16, 3, 1, "SAME", groups=g)
        q = nq.QuantizedConv2D.from_conv(layer)
        kh, kw, cin, cout = layer.weight.shape
        w = layer.weight.detach().permute(2, 0, 1, 3).reshape(-1, cout)
        if g > 1:
            w = torch.stack(w.chunk(g, dim=1))
        x = torch.randn(2, 5, 6, 8)
    # the payload quantize_int8 gives, read (in, out) as the JAX twin's
    want, _ = q8.quantize_int8(w.float(), axis=w.ndim - 2)
    assert torch.equal(q.weight_q, want)
    _k_major_ok(q.weight_q)
    y = q(x)
    for moved in (copy.deepcopy(q), q._apply(lambda t: t.clone())):
        _k_major_ok(moved.weight_q)
        assert torch.equal(moved(x), y)
    fresh = copy.deepcopy(q)
    fresh.weight_q.zero_()
    fresh.load_state_dict(q.state_dict())
    _k_major_ok(fresh.weight_q)
    assert torch.equal(fresh(x), y)
