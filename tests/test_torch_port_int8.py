"""The port's int8 matmul path against the JAX package: the plain
``int8_matmul`` against the Pallas kernel in interpret mode,
``quantized_linear`` in its three activation modes, the module swap
(``QuantizedLinear``, ``QuantizedConv2D`` with groups, ``WeightOnly*``,
``quantize``, ``calibrate``), whole int8 models, and
``InferenceModel.predict`` with batch buckets and ``weight_quant``.

Tolerances: the int8 products are exact (int32 equality).  A layer fed
the same numpy input quantizes it to the same int8 payload, so its
output differs from the JAX one only by float32 rounding of the rescale:
within ``RTOL_LAYER`` of the largest |output|.  A whole model's float
layers round differently in the two packages (sums in another order), so
an activation can sit on the other side of an int8 rounding boundary:
``RTOL_MODEL`` of the largest |output|, measured at 1e-7."""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import quantized as jnq
from bigdl_tpu.nn.attention import Transformer as JaxTransformer
from bigdl_tpu.ops import quantized as jq
from bigdl_tpu.serving.inference_model import \
    InferenceModel as JaxInferenceModel
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import quantized as nq
from bigdl_tpu_torch.nn.attention import Transformer
from bigdl_tpu_torch.ops import LAUNCHES
from bigdl_tpu_torch.ops import quantized as q8
from bigdl_tpu_torch.serving import InferenceModel
from bigdl_tpu_torch.utils import export_variables, load_jax_params
from test_torch_port_vision import _close, _x, port_and_jax

RTOL_LAYER = 1e-6
RTOL_MODEL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the int8 matmul
# ---------------------------------------------------------------------------

# ragged shapes of the main path: M = 1, LeNet's K = 25 / 150 and N = 6 /
# 12, the stem's K = 147, the head's N = 1000
SHAPES = [(50, 70, 30), (1, 147, 64), (3, 25, 6), (7, 150, 12),
          (2, 300, 100), (5, 64, 1000), (33, 576, 17)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_plain_equals_pallas(m, k, n):
    rs = np.random.RandomState(m * k + n)
    x = rs.randint(-127, 128, (m, k)).astype(np.int8)
    w = rs.randint(-127, 128, (k, n)).astype(np.int8)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w),
                                     block_m=32, block_n=128, block_k=128,
                                     interpret=True))
    got = q8.int8_matmul_plain(_t(x), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # on CPU tensors the wrapper takes the plain version, launching nothing
    before = dict(LAUNCHES)
    np.testing.assert_array_equal(q8.int8_matmul(_t(x), _t(w)).numpy(), want)
    assert dict(LAUNCHES) == before


def test_int8_matmul_plain_is_exact_past_float32():
    """K = 4608 of 127 * 127 products: 7.4e7, past float32's 2^24."""
    x = torch.full((2, 4608), 127, dtype=torch.int8)
    w = torch.full((4608, 3), 127, dtype=torch.int8)
    w[0, 0] = 126
    got = q8.int8_matmul_plain(x, w)
    assert got[0, 0].item() == 127 * 127 * 4608 - 127
    assert got[0, 1].item() == 127 * 127 * 4608


def test_int8_matmul_refuses_what_it_does_not_take():
    x = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8 operands"):
        q8.int8_matmul(x.float(), torch.zeros(8, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match="x"):
        q8.int8_matmul(x, torch.zeros(7, 3, dtype=torch.int8))
    with pytest.raises(ValueError, match=r"\(M, K\)"):
        q8.int8_matmul(x[None], torch.zeros(8, 3, dtype=torch.int8))


@pytest.mark.parametrize("mode", ["dynamic", "static", "channel"])
def test_quantized_linear_modes(mode):
    rs = np.random.RandomState(2)
    x = (rs.randn(3, 9, 64) * 2).astype(np.float32)
    w = (rs.randn(64, 48) * 0.1).astype(np.float32)
    b = (rs.randn(48) * 0.01).astype(np.float32)
    act = {"dynamic": None, "static": 0.03,
           "channel": rs.uniform(0.01, 0.05, 64).astype(np.float32)}[mode]
    wf = w * act[:, None] if mode == "channel" else w
    jw, js = jq.quantize_int8(jnp.asarray(wf), axis=0)
    tw, ts = q8.quantize_int8(_t(wf), axis=0)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    want = jq.quantized_linear(jnp.asarray(x), jw, js, jnp.asarray(b),
                               act_scale=act, interpret=True)
    got = q8.quantized_linear(_t(x), tw, ts, _t(b), act_scale=act)
    _close(got, want, RTOL_LAYER)


def test_activation_quantization_of_strided_rows_is_row_major():
    """The int8 rows handed to the kernel are row-major whatever the
    strides of the float rows."""
    x = torch.randn(40, 7).t()
    x_q, sx, _ = q8.quantize_activations(x)
    assert x_q.is_contiguous() and x_q.shape == (7, 40)
    assert torch.equal(x_q, q8.quantize_activations(x.contiguous())[0])


# ---------------------------------------------------------------------------
# the module swap
# ---------------------------------------------------------------------------

def _conv_pair(groups, stride, padding, seed=3, cin=8, cout=16):
    jl = jnn.Conv2D(cin, cout, 3, stride, padding, groups=groups)
    tl = nn.Conv2D(cin, cout, 3, stride, padding, groups=groups)
    x = _x((2, 9, 10, cin), seed=seed, scale=2.0)
    p = jax.tree_util.tree_map(np.asarray, jl.init(jax.random.PRNGKey(seed),
                                                   x)["params"])
    p["bias"] = (np.random.RandomState(seed).randn(cout) * 0.1).astype(
        np.float32)
    load_jax_params(tl, p)
    return jl, tl, p, x


@pytest.mark.parametrize("k,dilation", [(3, 1), (1, 1), (3, 2)])
@pytest.mark.parametrize("padding", ["SAME", (1, 2)])
@pytest.mark.parametrize("stride", [1, 2])
def test_patch_feature_order_is_jax(stride, padding, k, dilation):
    """The patches are conv_general_dilated_patches', features
    channel-major (C, kh, kw), as the weight rows are stored."""
    tl = nn.Conv2D(8, 4, k, stride, padding, dilation=dilation)
    x = _x((2, 9, 10, 8), seed=3)
    q = nq.QuantizedConv2D.from_conv(tl)
    got, (n, oh, ow) = q.patches(_t(x))
    pads = padding if isinstance(padding, str) else [(1, 1), (2, 2)]
    want = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), (k, k), (stride, stride), pads,
        rhs_dilation=(dilation, dilation),
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(n * oh * ow, -1))


@pytest.mark.parametrize("calibrated", [None, "tensor", "channel"])
@pytest.mark.parametrize("groups,stride,padding", [
    (1, 1, "SAME"), (1, 2, "SAME"), (1, 2, (1, 2)), (2, 1, "SAME"),
    (2, 2, (1, 2)), (8, 2, "SAME")])
def test_quantized_conv2d_matches_jax(groups, stride, padding, calibrated):
    jl, tl, p, x = _conv_pair(groups, stride, padding)
    act = None
    if calibrated == "tensor":
        act = float(np.abs(x).max()) / 127.0
    elif calibrated == "channel":
        act = (np.abs(x).reshape(-1, x.shape[-1]).max(0) / 127.0).astype(
            np.float32)
    jq_layer, jqp = jnq.QuantizedConv2D.from_conv(jl, p, act)
    tq = nq.QuantizedConv2D.from_conv(tl, act)
    np.testing.assert_array_equal(tq.weight_q.numpy(),
                                  np.asarray(jqp["weight_q"]))
    np.testing.assert_array_equal(tq.scales.numpy(),
                                  np.asarray(jqp["scales"]))
    _close(tq(_t(x)), jq_layer.apply({"params": jqp}, x)[0], RTOL_LAYER)


def test_weight_only_modules_match_jax():
    jl, tl, p, x = _conv_pair(2, 2, "SAME")
    jw, jwp = jnq.WeightOnlyConv2D.from_conv(jl, p)
    tw = nq.WeightOnlyConv2D.from_conv(tl)
    np.testing.assert_array_equal(tw.weight_q.numpy(),
                                  np.asarray(jwp["weight_q"]))
    _close(tw(_t(x)), jw.apply({"params": jwp}, x)[0], 1e-5)
    jlin, tlin = jnn.Linear(16, 5), nn.Linear(16, 5)
    xl = _x((4, 16), seed=8)
    lp = jax.tree_util.tree_map(np.asarray, jlin.init(jax.random.PRNGKey(8),
                                                      xl)["params"])
    load_jax_params(tlin, lp)
    jw, jwp = jnq.WeightOnlyLinear.from_linear(jlin, lp)
    tw = nq.WeightOnlyLinear.from_linear(tlin)
    _close(tw(_t(xl)), jw.apply({"params": jwp}, xl)[0], 1e-5)


def _jax_quantize_all(model, variables, calib=None, weight_only=False):
    """The JAX package's ``quantize``, carried into the ResNet blocks too
    (it recurses only through containers, and a block is not one)."""
    qm, qv = jnq.quantize(model, variables, calib, weight_only)
    qm.layers = list(qm.layers)
    params = dict(qv["params"])
    for i, layer in enumerate(qm.layers):
        if not hasattr(layer, "body"):
            continue
        k, new, pk = qm._key(i), copy.copy(layer), dict(params[qm._key(i)])
        for part in ("body", "proj"):
            if getattr(layer, part) is not None:
                sub, sv = jnq.quantize(getattr(layer, part),
                                       {"params": pk[part]}, calib,
                                       weight_only)
                setattr(new, part, sub)
                pk[part] = sv["params"]
        qm.layers[i], params[k] = new, pk
    return qm, {"params": params, "state": qv["state"]}


def _jax_forward(model, variables, x):
    """The JAX model's eval forward, jitted (eager interpret-mode Pallas
    takes ten times as long)."""
    return jax.jit(lambda v, x: model.apply(v, x)[0])(variables, x)


def _kinds(modules):
    return [type(m).__name__ for m in modules]


@pytest.mark.parametrize("weight_only", [False, True])
def test_quantize_swaps_the_jax_leaves_and_leaves_the_original(weight_only):
    jm, tm, v, x = port_and_jax("lenet5")
    before = export_variables(tm)
    y_before = tm(_t(x)).detach()
    jqm, _ = jnq.quantize(jm, v, weight_only=weight_only)
    tq = nq.quantize(tm, weight_only=weight_only)
    assert _kinds(tq.layers) == _kinds(jqm.layers)
    assert [n for n, _ in tq.named_children()] == \
        [jqm._key(i) for i in range(len(jqm.layers))]
    # the caller's model is untouched and shares nothing with the twin
    after = export_variables(tm)
    for a, b in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(tm(_t(x)).detach(), y_before)
    assert not {id(m) for m in tq.modules()} & {id(m) for m in tm.modules()}
    assert isinstance(nq.quantize(tm.layers[0]), nq.QuantizedConv2D)
    with pytest.raises(ValueError, match="module of the port"):
        nq.quantize(jm)


def test_quantize_reaches_every_resnet_conv():
    from bigdl_tpu_torch.models import resnet50

    q = nq.quantize(resnet50(generator=torch.Generator().manual_seed(0)))
    kinds = _kinds(q.modules())
    assert kinds.count("QuantizedConv2D") == 53
    assert kinds.count("QuantizedLinear") == 1
    assert "Conv2D" not in kinds and "Linear" not in kinds


@pytest.mark.parametrize("granularity", ["tensor", "channel"])
@pytest.mark.parametrize("method", ["minmax", "percentile"])
def test_calibrate_matches_jax(method, granularity):
    jm, tm, v, _ = port_and_jax("lenet5")
    batches = [_x((4, 28, 28, 1), seed=s) for s in (10, 11)]
    jc = jnq.calibrate(jm, v, batches, method=method,
                       granularity=granularity)
    tc = nq.calibrate(tm, batches, method=method, granularity=granularity)
    jleaves = [l for l in jm.layers
               if isinstance(l, (jnn.Linear, jnn.Conv2D))]
    tleaves = [l for l in tm.layers if isinstance(l, (nn.Linear, nn.Conv2D))]
    assert len(jc) == len(tc) == len(tleaves) == 4
    for jl, tl in zip(jleaves, tleaves):
        np.testing.assert_allclose(np.asarray(tc[id(tl)]),
                                   np.asarray(jc[id(jl)]), rtol=1e-6)
    # the calibrated int8 model: static activation quantization
    x = batches[0]
    jqm, jqv = jnq.quantize(jm, v, jc)
    tq = nq.quantize(tm, tc)
    _close(tq(_t(x)), _jax_forward(jqm, jqv, x), RTOL_MODEL)
    with pytest.raises(ValueError, match="method"):
        nq.calibrate(tm, batches, method="mean")


@pytest.mark.parametrize("name", ["lenet5", "resnet_cifar8", "bottlenecks"])
def test_int8_model_matches_jax(name):
    jm, tm, v, x = port_and_jax(name)
    jqm, jqv = _jax_quantize_all(jm, v)
    tq = nq.quantize(tm)
    with torch.no_grad():
        got = tq(_t(x))
    _close(got, _jax_forward(jqm, jqv, x), RTOL_MODEL)


# ---------------------------------------------------------------------------
# InferenceModel.predict
# ---------------------------------------------------------------------------

def test_predict_buckets_and_chunking():
    """As tests/test_serving.py: buckets (4, 16), requests of 1, 3, 4, 9
    and 33 rows (33 > 16 chunks), the same rows as a direct forward."""
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential([nn.Linear(4, 8, generator=g), nn.ReLU(),
                           nn.Linear(8, 2, generator=g)])
    x = np.random.RandomState(0).rand(33, 4).astype(np.float32)
    want = model(_t(x)).detach().numpy()
    im = InferenceModel(model, device="cpu", batch_buckets=(4, 16))
    seen = []
    hook = im.model.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].shape[0]))
    for n in (1, 3, 4, 9, 33):
        out = im.predict(x[:n])
        assert out.shape == (n, 2) and isinstance(out, np.ndarray)
        np.testing.assert_allclose(out, want[:n], rtol=1e-5, atol=1e-6)
    hook.remove()
    assert seen == [4, 4, 4, 16, 16, 16, 4]
    assert set(seen) <= {4, 16}
    im.warmup(x[:1])


@pytest.mark.parametrize("name", ["lenet5", "bottlenecks"])
def test_predict_layered_int8_matches_jax(name):
    jm, tm, v, x = port_and_jax(name)
    x = np.concatenate([x, x[:1] * 0.5])            # 3 rows: bucket 4
    want_f = JaxInferenceModel(jm, v).predict(x)
    want_q = JaxInferenceModel(*_jax_quantize_all(jm, v)).predict(x) \
        if name != "lenet5" else \
        JaxInferenceModel(jm, v, weight_quant="int8").predict(x)
    im = InferenceModel(tm, device="cpu")
    _close(im.predict(x), want_f, 1e-5)
    qim = InferenceModel(tm, device="cpu", weight_quant="int8")
    assert isinstance(qim.model, nn.Sequential) and qim.model is not tm
    _close(qim.predict(x), want_q, RTOL_MODEL)


def test_predict_lm_int8_without_decode_matches_jax():
    """As tests/test_quant_serving.py::test_weight_quant_inference_model:
    int8 serving weights through predict, without a decode engine."""
    jmodel = JaxTransformer(vocab_size=32, hidden_size=16, num_heads=2,
                            num_layers=2, dropout=0.0, mode="lm")
    ids = np.arange(6, dtype=np.int32)[None]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jmodel.init(jax.random.PRNGKey(0), ids)["params"])
    tmodel = load_jax_params(Transformer(32, 16, 2, num_layers=2,
                                         dropout=0.0), params)
    ref = np.asarray(JaxInferenceModel(jmodel,
                                       {"params": params}).predict(ids))
    want = np.asarray(JaxInferenceModel(jmodel, {"params": params},
                                        weight_quant="int8").predict(ids))
    _close(InferenceModel(tmodel, device="cpu").predict(ids), ref, 1e-5)
    im = InferenceModel(tmodel, device="cpu", weight_quant="int8")
    got = im.predict(ids)
    _close(got, want, 1e-5)
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.05
    assert im.model is not tmodel and im.model.embedding.numel() == 0
    with pytest.raises(ValueError, match="weight_quant"):
        InferenceModel(tmodel, device="cpu", weight_quant="int4")
