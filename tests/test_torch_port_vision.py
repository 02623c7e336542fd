"""The port's vision nn core against the JAX package: ``nn.init``,
``nn.module`` containers, the layers of ``nn.layers`` that LeNet and
ResNet use (and the cheap rest), ``models.lenet`` / ``models.resnet``,
and ``utils.convert`` carrying whole ``{"params", "state"}`` trees.

Both packages run the same numpy inputs on the same weights: a layer's
JAX params are copied into the port layer, and a model's port variables
(random, every BatchNorm's affine and running statistics redrawn so no
residual body is zero) are exported into the JAX forward.  JAX matmuls
and convs run at "highest" precision (tests/conftest.py) and the port
pins float32 without TF32, so the two agree to float32 rounding: every
output within ``RTOL`` of the largest |output| (sums of up to 4608
products in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.models.lenet import LeNet5 as JaxLeNet5
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.models import (LeNet5, SpaceToDepthStem, resnet50,
                                    resnet_cifar)
from bigdl_tpu_torch.models import resnet as tresnet
from bigdl_tpu_torch.nn import init
from bigdl_tpu_torch.utils import (export_variables, load_jax_params,
                                   load_jax_variables)

RTOL = 1e-5


def _x(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def redraw_bn(model, seed=1):
    """Every BatchNorm: weight U(0.5, 1.5), bias N(0, 0.1), running mean
    N(0, 0.1), running variance U(0.5, 1.5), from numpy ``seed``."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm):
                c = m.num_features
                for t, v in ((m.weight, rs.uniform(0.5, 1.5, c)),
                             (m.bias, rs.randn(c) * 0.1),
                             (m.running_mean, rs.randn(c) * 0.1),
                             (m.running_var, rs.uniform(0.5, 1.5, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def jax_variables_of(jmodel, tmodel, x):
    """The port model's variables as a JAX tree, after checking that it
    has exactly the JAX model's leaves with the JAX shapes."""
    want = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), x))
    got = export_variables(tmodel)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape
    return got


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn,check", [
    (init.zeros, lambda t: bool((t == 0).all())),
    (init.ones, lambda t: bool((t == 1).all())),
    (init.const(0.25), lambda t: bool((t == 0.25).all())),
    (init.random_uniform(-0.5, 0.5), lambda t: t.abs().max() <= 0.5),
    (init.random_normal(2.0, 0.1), lambda t: abs(t.mean() - 2.0) < 0.01),
    (init.xavier, lambda t: t.abs().max() <= (6.0 / (64 + 32)) ** 0.5),
    (init.msra, lambda t: abs(t.std() - (2.0 / 32) ** 0.5) < 0.01),
    (init.kaiming_in, lambda t: abs(t.std() - (2.0 / 64) ** 0.5) < 0.01),
    (init.default_bias, lambda t: t.abs().max() <= 64 ** -0.5),
])
def test_init_distributions_and_generator(fn, check):
    draw = lambda: fn(torch.Generator().manual_seed(3), (128, 96), 64, 32)
    t = draw()
    assert t.shape == (128, 96) and t.dtype == torch.float32
    assert check(t)
    assert torch.equal(t, draw())       # the generator fixes the draw


# ---------------------------------------------------------------------------
# layers: JAX params copied into the port layer, same input
# ---------------------------------------------------------------------------

def _layer_pair(jax_layer, port_layer, x, training=False):
    v = _np_tree(jax_layer.init(jax.random.PRNGKey(1), x))
    load_jax_variables(port_layer, v)
    port_layer.train(training)
    want, state = jax_layer.apply(v, x, training=training)
    return port_layer(torch.from_numpy(x)), want, state


LAYERS = [
    ("linear", lambda: (jnn.Linear(12, 7), nn.Linear(12, 7)), (3, 5, 12)),
    ("linear_nobias", lambda: (jnn.Linear(12, 7, with_bias=False),
                               nn.Linear(12, 7, with_bias=False)), (4, 12)),
    ("conv_same_s1", lambda: (jnn.Conv2D(3, 5, 3, padding="SAME"),
                              nn.Conv2D(3, 5, 3, padding="SAME")),
     (2, 9, 9, 3)),
    ("conv_same_s2_k7", lambda: (jnn.Conv2D(3, 4, 7, 2, "SAME"),
                                 nn.Conv2D(3, 4, 7, 2, "SAME")),
     (1, 16, 16, 3)),
    ("conv_same_s2_odd", lambda: (jnn.Conv2D(4, 4, 3, 2, "same"),
                                  nn.Conv2D(4, 4, 3, 2, "same")),
     (1, 9, 10, 4)),
    ("conv_explicit", lambda: (jnn.Conv2D(3, 6, (3, 5), (2, 1), (1, 2)),
                               nn.Conv2D(3, 6, (3, 5), (2, 1), (1, 2))),
     (2, 8, 7, 3)),
    ("conv_minus1", lambda: (jnn.Conv2D(3, 4, 3, 1, -1),
                             nn.Conv2D(3, 4, 3, 1, -1)), (1, 6, 6, 3)),
    ("conv_valid_dil_groups", lambda: (
        jnn.Conv2D(8, 4, 3, padding="VALID", dilation=2, groups=4),
        nn.Conv2D(8, 4, 3, padding="VALID", dilation=2, groups=4)),
     (2, 9, 9, 8)),
    ("conv1d_causal", lambda: (jnn.Conv1D(4, 6, 3, dilation=2, causal=True),
                               nn.Conv1D(4, 6, 3, dilation=2, causal=True)),
     (2, 11, 4)),
    ("conv1d_same_s2", lambda: (jnn.Conv1D(4, 6, 4, stride=2,
                                           padding="SAME"),
                                nn.Conv1D(4, 6, 4, stride=2,
                                          padding="SAME")), (2, 11, 4)),
    ("maxpool_pad", lambda: (jnn.MaxPool2D(3, 2, padding=1),
                             nn.MaxPool2D(3, 2, padding=1)), (2, 9, 8, 3)),
    ("maxpool_ceil", lambda: (jnn.MaxPool2D(2, 2, ceil_mode=True),
                              nn.MaxPool2D(2, 2, ceil_mode=True)),
     (1, 7, 7, 2)),
    ("maxpool_same", lambda: (jnn.MaxPool2D(3, 2, padding="SAME"),
                              nn.MaxPool2D(3, 2, padding="SAME")),
     (1, 8, 7, 2)),
    ("avgpool_pad_ceil", lambda: (jnn.AvgPool2D(3, 2, 1, ceil_mode=True),
                                  nn.AvgPool2D(3, 2, 1, ceil_mode=True)),
     (2, 8, 9, 3)),
    ("avgpool_valid", lambda: (jnn.AvgPool2D(2), nn.AvgPool2D(2)),
     (1, 6, 6, 2)),
    ("gap", lambda: (jnn.GlobalAvgPool2D(), nn.GlobalAvgPool2D()),
     (2, 5, 4, 3)),
    ("layernorm", lambda: (jnn.LayerNorm(6), nn.LayerNorm(6)), (3, 6)),
    ("rmsnorm", lambda: (jnn.RMSNorm(6), nn.RMSNorm(6)), (3, 6)),
    ("zeropad", lambda: (jnn.ZeroPadding2D((1, 2)), nn.ZeroPadding2D((1, 2))),
     (1, 3, 3, 2)),
    ("reshape", lambda: (jnn.Reshape((6, 2)), nn.Reshape((6, 2))),
     (2, 3, 4)),
    ("view_nobatch", lambda: (jnn.View((4, 6), batch_mode=False),
                              nn.View((4, 6), batch_mode=False)), (2, 3, 4)),
    ("flatten", lambda: (jnn.Flatten(), nn.Flatten()), (2, 3, 4, 5)),
    ("squeeze", lambda: (jnn.Squeeze(2), nn.Squeeze(2)), (2, 3, 1, 4)),
    ("squeeze_all", lambda: (jnn.Squeeze(), nn.Squeeze()), (2, 1, 4, 1)),
    ("unsqueeze", lambda: (jnn.Unsqueeze(1), nn.Unsqueeze(1)), (2, 3)),
    ("transpose", lambda: (jnn.Transpose((0, 2, 1)), nn.Transpose((0, 2, 1))),
     (2, 3, 4)),
    ("softmax", lambda: (jnn.SoftMax(1), nn.SoftMax(1)), (2, 5, 3)),
    ("logsoftmax", lambda: (jnn.LogSoftMax(), nn.LogSoftMax()), (2, 5)),
    ("leakyrelu", lambda: (jnn.LeakyReLU(0.2), nn.LeakyReLU(0.2)), (3, 7)),
    ("elu", lambda: (jnn.ELU(0.7), nn.ELU(0.7)), (3, 7)),
    ("hardtanh", lambda: (jnn.HardTanh(-0.5, 2.0), nn.HardTanh(-0.5, 2.0)),
     (3, 7)),
] + [(name.lower(), (lambda n=name: (getattr(jnn, n)(), getattr(nn, n)())),
      (3, 7)) for name in ("ReLU", "ReLU6", "Tanh", "Sigmoid", "GELU",
                           "SiLU", "SoftPlus", "SoftSign", "HardSigmoid",
                           "HardSwish")]


@pytest.mark.parametrize("name,make,shape", LAYERS,
                         ids=[layer[0] for layer in LAYERS])
def test_layer_matches_jax(name, make, shape):
    jl, tl = make()
    x = _x(shape, scale=3.0)
    got, want, _ = _layer_pair(jl, tl, x)
    _close(got, want)


def test_embedding_matches_jax():
    jl, tl = jnn.Embedding(11, 4), nn.Embedding(11, 4)
    ids = np.array([[0, 3, 10], [5, 5, 1]], np.int32)
    got, want, _ = _layer_pair(jl, tl, ids)
    _close(got, want)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("shape", [(4, 6), (2, 5, 3, 6)])
def test_batchnorm_both_modes(training, shape):
    jl, tl = jnn.BatchNorm(6), nn.BatchNorm(6)
    x = _x(shape, scale=2.0) + 3.0
    v = _np_tree(jl.init(jax.random.PRNGKey(0), x))
    rs = np.random.RandomState(2)
    v["params"] = {"weight": rs.uniform(0.5, 1.5, 6).astype(np.float32),
                   "bias": (rs.randn(6) * 0.1).astype(np.float32)}
    v["state"] = {"running_mean": (rs.randn(6) * 0.1).astype(np.float32),
                  "running_var": rs.uniform(0.5, 1.5, 6).astype(np.float32)}
    load_jax_variables(tl, v)
    tl.train(training)
    want, new_state = jl.apply(v, x, training=training)
    _close(tl(torch.from_numpy(x)), want)
    st = new_state if training else v["state"]
    _close(tl.running_mean, st["running_mean"])
    _close(tl.running_var, st["running_var"])


def test_containers_and_tables_match_jax():
    def build(m):
        return m.Sequential([
            m.ConcatTable([m.Linear(6, 4), m.Sequential([m.Linear(6, 4),
                                                         m.Tanh()])]),
            m.ParallelTable([m.ReLU(), m.Identity()]),
            m.ConcatTable([m.CAddTable(), m.CMulTable(), m.JoinTable(),
                           m.SelectTable(1)]),
            m.JoinTable(),
            m.Lambda(lambda y: y * 2.0, name="double"),
            m.Concat([m.Linear(20, 3), m.Linear(20, 2)]),
        ])

    jm, tm = build(jnn), build(nn)
    x = _x((5, 6))
    v = _np_tree(jm.init(jax.random.PRNGKey(2), x))
    assert (sorted(n for n, _ in tm.named_parameters())
            == sorted(".".join(str(k.key) for k in path) for path, _ in
                      jax.tree_util.tree_leaves_with_path(v["params"])))
    load_jax_variables(tm, v)
    _close(tm(torch.from_numpy(x)), jm.apply(v, x)[0])
    assert [type(c).__name__ for c in tm.layers][:2] == ["ConcatTable",
                                                        "ParallelTable"]
    assert len(tm) == 6 and tm[4].name == "double"


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def narrow_bottlenecks(m, g=None):
    """A narrow Bottleneck stack: a stride-1 block with a projection
    (cin != cout), a stride-2 block with a projection, an identity
    block."""
    kw = {} if g is None else {"generator": g}
    return m.Sequential(
        m_conv_bn(m, g) + [
            (jresnet if m is jnn else tresnet).Bottleneck(8, 4, 1, **kw),
            (jresnet if m is jnn else tresnet).Bottleneck(16, 8, 2, **kw),
            (jresnet if m is jnn else tresnet).Bottleneck(32, 8, 1, **kw),
            m.GlobalAvgPool2D(), m.Linear(32, 5, **kw), m.LogSoftMax()])


def m_conv_bn(m, g):
    if m is jnn:
        return jresnet._conv_bn(3, 8, 3)
    return tresnet._conv_bn(3, 8, 3, generator=g)


MODELS = {
    "lenet5": (lambda: JaxLeNet5(10), lambda g: LeNet5(10, generator=g),
               (2, 28, 28, 1)),
    "resnet_cifar8": (lambda: jresnet.resnet_cifar(8),
                      lambda g: resnet_cifar(8, generator=g),
                      (2, 16, 16, 3)),
    "bottlenecks": (lambda: narrow_bottlenecks(jnn),
                    lambda g: narrow_bottlenecks(nn, g), (2, 12, 12, 3)),
    "resnet50_32px": (lambda: jresnet.resnet50(), lambda g: resnet50(
        generator=g), (1, 32, 32, 3)),
}


def port_and_jax(name, seed=0):
    """(JAX model, port model with BN redrawn, its variables for JAX,
    input)."""
    jf, tf, shape = MODELS[name]
    jm, tm = jf(), tf(torch.Generator().manual_seed(seed))
    redraw_bn(tm).eval()
    x = _x(shape, seed=seed)
    return jm, tm, jax_variables_of(jm, tm, x), x


@pytest.mark.parametrize("name", list(MODELS))
def test_model_float_matches_jax(name):
    jm, tm, v, x = port_and_jax(name)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jm.apply(v, x)[0])


def test_resnet50_variables_round_trip():
    """Every leaf of the JAX ResNet-50 tree (params and state) has a port
    counterpart of its shape, none is left over, and the values come
    back as they went in."""
    jm = jresnet.resnet50()
    x = np.zeros((1, 32, 32, 3), np.float32)
    tm = redraw_bn(resnet50(generator=torch.Generator().manual_seed(5)))
    v = jax_variables_of(jm, tm, x)
    assert len(jax.tree_util.tree_leaves(v["params"])) == 161
    assert len(jax.tree_util.tree_leaves(v["state"])) == 106
    back = export_variables(load_jax_variables(resnet50(), v))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        load_jax_variables(resnet50(), {"state": {"1__BN": {"nope": x}}})


def test_gamma_zero_and_resnet50_shape():
    m = resnet50(generator=torch.Generator().manual_seed(0))
    last = [blk.body[7] for blk in m.layers if hasattr(blk, "body")]
    assert len(last) == 16 and all(bool((b.weight == 0).all()) for b in last)
    assert sum(p.numel() for p in m.parameters()) == 25_557_032
    with pytest.raises(ValueError, match="stem"):
        resnet50(stem="nope")


def test_pack_stem_kernel_and_s2d_stem():
    k7 = _x((7, 7, 3, 8), seed=4)
    packed = tresnet.pack_stem_kernel(torch.from_numpy(k7))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(
        jresnet.pack_stem_kernel(jnp.asarray(k7))))
    x = _x((2, 16, 16, 3), seed=5)
    conv = nn.Conv2D(3, 8, 7, 2, "SAME", with_bias=False)
    load_jax_params(conv, {"weight": k7})
    stem = SpaceToDepthStem(8)
    load_jax_params(stem, {"weight": packed.numpy()})
    with torch.no_grad():
        got = stem(torch.from_numpy(x))
        _close(got, conv(torch.from_numpy(x)))
    jstem = jresnet.SpaceToDepthStem(8)
    _close(got, jstem.apply({"params": {"weight": packed.numpy()}}, x)[0])
    with pytest.raises(ValueError, match="even"):
        stem(torch.zeros(1, 15, 16, 3))


def test_s2d_resnet50_matches_jax():
    jm, tm = jresnet.resnet50(stem="s2d", include_top=False), resnet50(
        stem="s2d", include_top=False,
        generator=torch.Generator().manual_seed(1))
    redraw_bn(tm).eval()
    x = _x((1, 32, 32, 3), seed=1)
    v = jax_variables_of(jm, tm, x)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), jm.apply(v, x)[0])


def test_vision_modules_import_no_jax():
    import subprocess
    import sys

    code = ("import sys, bigdl_tpu_torch.nn, bigdl_tpu_torch.models, "
            "bigdl_tpu_torch.serving, bigdl_tpu_torch.ops.quantized;"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bigdl_tpu'));"
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
