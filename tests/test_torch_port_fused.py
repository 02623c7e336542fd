"""The port's fused LayerNorm and inference IR rewrite against the JAX
package: ``ops.fused`` (the plain version and the CPU path of
``fused_layernorm``, forward and gradients, against the JAX
``fused_layernorm`` in interpret mode) and ``utils.intermediate`` (the
cases of ``tests/test_intermediate.py``: identity rebuild, the
Conv2D/Linear + BatchNorm folds, LayerNorm retargeting, functional
graphs), each port graph built from the JAX graph's variables.

Tolerances: the LayerNorm forward and gradients agree within ``LN_TOL``
of the largest |value| (float32 sums of up to 768 terms in another
order); folded weights within ``FOLD_TOL`` of the JAX fold's (both fold
in float64 and round to float32); model outputs within ``RTOL`` of the
largest |output|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.keras.engine import Input as JInput
from bigdl_tpu.keras.engine import Model as JModel
from bigdl_tpu.nn.module import Sequential as JSequential
from bigdl_tpu.ops import fused_layernorm as jax_fused_layernorm
from bigdl_tpu.utils.intermediate import IRGraph as JIRGraph
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.keras.engine import Input, Model
from bigdl_tpu_torch.models import resnet_cifar
from bigdl_tpu_torch.ops.fused import fused_layernorm, fused_layernorm_plain
from bigdl_tpu_torch.utils import (load_jax_keras_variables,
                                   load_jax_variables)
from bigdl_tpu_torch.utils.intermediate import FusedLayerNorm, IRGraph

LN_TOL = 1e-5
FOLD_TOL = 1e-6
RTOL = 1e-5


def _close(got, want, tol):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor)
                 else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _ln_inputs(shape, seed):
    rs = np.random.RandomState(seed)
    d = shape[-1]
    x = (rs.randn(*shape) * 2.0 + 0.5).astype(np.float32)
    gamma = (1.0 + 0.3 * rs.randn(d)).astype(np.float32)
    beta = (0.2 * rs.randn(d)).astype(np.float32)
    return x, gamma, beta


# ---------------------------------------------------------------------------
# ops.fused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("lead", [(7,), (2, 5)])
@pytest.mark.parametrize("d", [16, 37, 768])
def test_layernorm_matches_jax_kernel(d, lead, eps):
    x, gamma, beta = _ln_inputs(lead + (d,), seed=d + len(lead))
    want = jax_fused_layernorm(jnp.asarray(x), jnp.asarray(gamma),
                               jnp.asarray(beta), eps=eps, interpret=True)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, gamma, beta))
    _close(fused_layernorm_plain(tx, tg, tb, eps), want, LN_TOL)
    _close(fused_layernorm(tx, tg, tb, eps=eps), want, LN_TOL)


@pytest.mark.parametrize("eps", [1e-5, 1e-12])
@pytest.mark.parametrize("d,lead", [(16, (4,)), (37, (3, 5)), (768, (6,))])
def test_layernorm_gradients_match_jax(d, lead, eps):
    x, gamma, beta = _ln_inputs(lead + (d,), seed=3 * d)
    up = np.random.RandomState(d).randn(*x.shape).astype(np.float32)

    def loss(x, g, b):
        y = jax_fused_layernorm(x, g, b, eps=eps, interpret=True)
        return jnp.sum(y * up)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (x, gamma, beta))
    (fused_layernorm(tx, tg, tb, eps=eps) * torch.from_numpy(up)).sum(
    ).backward()
    for got, w in zip((tx.grad, tg.grad, tb.grad), want):
        _close(got, w, LN_TOL)


def test_layernorm_gradients_keep_each_primal_dtype():
    x, gamma, beta = _ln_inputs((4, 16), seed=0)
    tx = torch.from_numpy(x).double().requires_grad_()
    tg = torch.from_numpy(gamma).requires_grad_()
    tb = torch.from_numpy(beta).requires_grad_()
    y = fused_layernorm(tx, tg, tb)
    assert y.dtype == torch.float64
    y.sum().backward()
    assert (tx.grad.dtype, tg.grad.dtype, tb.grad.dtype) == (
        torch.float64, torch.float32, torch.float32)


def test_layernorm_of_a_transposed_view_and_a_constant_row():
    x, gamma, beta = _ln_inputs((16, 9), seed=5)
    tx = torch.from_numpy(x).t()                 # (9, 16), not contiguous
    tg, tb = torch.from_numpy(gamma[:1].repeat(16)), torch.from_numpy(
        beta[:1].repeat(16))
    want = fused_layernorm_plain(tx.contiguous(), tg, tb, 1e-12)
    _close(fused_layernorm(tx, tg, tb, eps=1e-12), want, LN_TOL)
    # a constant row has variance 0: rsqrt(eps) times 0, so beta, no NaN
    y = fused_layernorm(torch.full((2, 16), 3.0), tg, tb, eps=1e-12)
    assert torch.isfinite(y).all() and torch.equal(y, tb.expand(2, 16))


def test_layernorm_refuses_what_it_does_not_take():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="gamma and beta"):
        fused_layernorm(x, torch.ones(7), torch.zeros(8))
    with pytest.raises(ValueError, match="different devices"):
        fused_layernorm(x, torch.ones(8, device="meta"), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fused_layernorm(*(t.to("meta") for t in (x, torch.ones(8),
                                                  torch.zeros(8))))


# ---------------------------------------------------------------------------
# utils.intermediate
# ---------------------------------------------------------------------------


def _bn_stats(variables, rs):
    """Nontrivial running statistics (and affine) for every BatchNorm."""
    for tree in (variables["params"], variables["state"]):
        for key in tree:
            if "BatchNorm" not in key:
                continue
            for name, a in tree[key].items():
                c = np.asarray(a).shape[0]
                tree[key][name] = {
                    "running_mean": rs.randn(c) * 0.2,
                    "running_var": 1.0 + 0.3 * rs.rand(c),
                    "weight": 1.0 + 0.2 * rs.randn(c),
                    "bias": 0.1 * rs.randn(c)}[name].astype(np.float32)
    return variables


def _sequential_pair(jlayers, tlayers, x, seed):
    jm = JSequential(jlayers)
    variables = _bn_stats(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x)),
        np.random.RandomState(seed))
    tm = load_jax_variables(nn.Sequential(tlayers), variables).eval()
    return jm, variables, tm


def _keras_pair(build, x, seed):
    jm = build(jnn, JInput, JModel)
    variables = _bn_stats(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), x)),
        np.random.RandomState(seed))
    tm = load_jax_keras_variables(build(nn, Input, Model), jm,
                                  variables).eval()
    return jm, variables, tm


def _layers(model, cls):
    return [n.layer for n in model.order if isinstance(n.layer, cls)]


def _conv_bn_layers(m, with_bias=True, dropout=False):
    out = [m.Conv2D(2, 4, 3, padding="SAME", with_bias=with_bias),
           m.BatchNorm(4), m.ReLU()]
    if dropout:
        out.append(m.Dropout(0.5))
    return out + [m.Flatten(), m.Linear(4 * 6 * 6, 5)]


def test_xla_engine_identity_rebuild():
    x = np.random.RandomState(0).randn(2, 6, 6, 2).astype(np.float32)
    jm, v, tm = _sequential_pair(_conv_bn_layers(jnn), _conv_bn_layers(nn),
                                 x, 0)
    m2 = IRGraph.from_model(tm).to_model("xla")
    assert not m2.training
    want, _ = jm.apply(v, x)
    _close(m2(torch.from_numpy(x)), want, RTOL)
    _close(tm(torch.from_numpy(x)), want, RTOL)


@pytest.mark.parametrize("with_bias", [True, False])
def test_fused_engine_folds_conv_bn_and_drops_dropout(with_bias):
    x = np.random.RandomState(1).randn(2, 6, 6, 2).astype(np.float32)
    jm, v, tm = _sequential_pair(
        _conv_bn_layers(jnn, with_bias, dropout=True),
        _conv_bn_layers(nn, with_bias, dropout=True), x, 1)
    m2 = IRGraph.from_model(tm).to_model("fused")
    assert not _layers(m2, nn.BatchNorm) and not _layers(m2, nn.Dropout)
    (conv,) = _layers(m2, nn.Conv2D)
    assert conv.with_bias and conv.bias is not None
    # the caller's model is untouched
    assert len(_layers(IRGraph.from_model(tm).to_model("xla"),
                       nn.BatchNorm)) == 1
    assert tm[0].with_bias == with_bias

    jf, jv = JIRGraph.from_model(jm, v).to_model("fused")
    (jconv,) = [n for n in jf.order if isinstance(n.layer, jnn.Conv2D)]
    _close(conv.weight, jv["params"][jconv.name]["weight"], FOLD_TOL)
    _close(conv.bias, jv["params"][jconv.name]["bias"], FOLD_TOL)
    want, _ = jm.apply(v, x)
    _close(m2(torch.from_numpy(x)), want, 1e-4)
    _close(m2(torch.from_numpy(x)), jf.apply(jv, x)[0], RTOL)


def test_fused_linear_bn_fold():
    def layers(m):
        return [m.Linear(8, 6), m.BatchNorm(6), m.Tanh()]

    x = np.random.RandomState(3).randn(4, 8).astype(np.float32)
    jm, v, tm = _sequential_pair(layers(jnn), layers(nn), x, 3)
    m2 = IRGraph.from_model(tm).to_model("fused")
    assert not _layers(m2, nn.BatchNorm)
    jf, jv = JIRGraph.from_model(jm, v).to_model("fused")
    (jlin,) = [n for n in jf.order if isinstance(n.layer, jnn.Linear)]
    (lin,) = _layers(m2, nn.Linear)
    _close(lin.weight, jv["params"][jlin.name]["weight"], FOLD_TOL)
    _close(lin.bias, jv["params"][jlin.name]["bias"], FOLD_TOL)
    _close(m2(torch.from_numpy(x)), model_out(jm, v, x), 1e-4)


def model_out(jm, v, x):
    return jm.apply(v, x)[0]


def test_bn_not_folded_when_conv_has_two_consumers():
    def build(m, Inp, Mod):
        inp = Inp((5, 5, 3))
        conv = m.Conv2D(3, 3, 3, padding="SAME")(inp)
        bn = m.BatchNorm(3)(conv)
        return Mod(inp, m.CAddTable()([bn, conv]))

    x = np.random.RandomState(4).randn(2, 5, 5, 3).astype(np.float32)
    jm, v, tm = _keras_pair(build, x, 4)
    m2 = IRGraph.from_model(tm).to_model("fused")
    assert len(_layers(m2, nn.BatchNorm)) == 1
    _close(m2(torch.from_numpy(x)), model_out(jm, v, x), RTOL)


def test_fused_residual_graph_matches():
    def build(m, Inp, Mod):
        inp = Inp((6, 6, 4))
        a = m.Conv2D(4, 4, 3, padding="SAME", with_bias=False)(inp)
        r = m.ReLU()(m.BatchNorm(4)(a))
        return Mod(inp, m.CAddTable()([r, inp]))

    x = np.random.RandomState(5).randn(2, 6, 6, 4).astype(np.float32)
    jm, v, tm = _keras_pair(build, x, 5)
    m2 = IRGraph.from_model(tm).to_model("fused")
    assert not _layers(m2, nn.BatchNorm)
    jf, jv = JIRGraph.from_model(jm, v).to_model("fused")
    _close(m2(torch.from_numpy(x)), jf.apply(jv, x)[0], RTOL)
    _close(m2(torch.from_numpy(x)), model_out(jm, v, x), 1e-4)


def test_layernorm_retargets_to_the_kernel_twin():
    def layers(m):
        return [m.Linear(16, 16), m.LayerNorm(16, eps=1e-12), m.GELU()]

    rs = np.random.RandomState(6)
    x = rs.randn(4, 16).astype(np.float32)
    jm = JSequential(layers(jnn))
    v = jax.tree_util.tree_map(np.asarray,
                               jm.init(jax.random.PRNGKey(0), x))
    v["params"]["1_LayerNorm"] = {
        "weight": (1 + 0.1 * rs.randn(16)).astype(np.float32),
        "bias": (0.1 * rs.randn(16)).astype(np.float32)}
    tm = load_jax_variables(nn.Sequential(layers(nn)), v)
    m2 = IRGraph.from_model(tm).to_model("fused")
    (ln,) = _layers(m2, FusedLayerNorm)
    assert not _layers(m2, nn.LayerNorm) and ln.eps == 1e-12
    assert ln.name == "LayerNorm"
    jf, jv = JIRGraph.from_model(jm, v).to_model("fused")
    _close(m2(torch.from_numpy(x)), jf.apply(jv, x)[0], RTOL)
    _close(m2(torch.from_numpy(x)), model_out(jm, v, x), RTOL)


def test_ir_from_functional_multi_output():
    def build(m, Inp, Mod):
        inp = Inp((4,))
        h = m.Linear(4, 8)(inp)
        return Mod(inp, [m.ReLU()(h), m.Tanh()(h)])

    x = np.random.RandomState(7).randn(3, 4).astype(np.float32)
    jm, v, tm = _keras_pair(build, x, 7)
    a1, a2 = model_out(jm, v, x)
    b1, b2 = IRGraph.from_model(tm).to_model("xla")(torch.from_numpy(x))
    _close(b1, a1, RTOL)
    _close(b2, a2, RTOL)


def test_fused_then_xla_on_same_graph_is_not_corrupted():
    """to_model("fused") changes neither the graph nor the caller's
    model: an "xla" rebuild of the same graph afterwards still has the
    BatchNorm and the Dropout, and the caller's conv keeps its weights."""
    x = np.random.RandomState(3).randn(2, 6, 6, 2).astype(np.float32)
    jm, v, tm = _sequential_pair(_conv_bn_layers(jnn, dropout=True),
                                 _conv_bn_layers(nn, dropout=True), x, 3)
    w0 = tm[0].weight.detach().clone()
    ir = IRGraph.from_model(tm)
    m_fused = ir.to_model("fused")
    m_xla = ir.to_model("xla")
    assert len(_layers(m_xla, nn.BatchNorm)) == 1
    assert len(_layers(m_xla, nn.Dropout)) == 1
    assert torch.equal(tm[0].weight, w0)
    want = model_out(jm, v, x)
    _close(m_xla(torch.from_numpy(x)), want, RTOL)
    _close(m_fused(torch.from_numpy(x)), want, 1e-4)


def test_nested_sequentials_flatten_and_blocks_stay_whole():
    """A nested Sequential's children become nodes (its BN folds into the
    conv before it); a block that is not a Sequential stays one node, as
    the ResNet blocks do."""
    g = torch.Generator().manual_seed(0)
    model = resnet_cifar(depth=8, classes=10, generator=g)
    rs = np.random.RandomState(8)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm):
                for t, val in ((m.weight, 1 + 0.2 * rs.randn(m.num_features)),
                               (m.bias, 0.1 * rs.randn(m.num_features)),
                               (m.running_mean,
                                0.1 * rs.randn(m.num_features)),
                               (m.running_var,
                                rs.uniform(0.5, 1.5, m.num_features))):
                    t.copy_(torch.from_numpy(val.astype(np.float32)))
    model = nn.Sequential([nn.Sequential(model.layers[:3]),
                           *model.layers[3:]]).eval()
    n_bn = sum(isinstance(m, nn.BatchNorm) for m in model.modules())
    fused = IRGraph.from_model(model).to_model("fused")
    assert sum(isinstance(m, nn.BatchNorm)
               for m in fused.modules()) == n_bn - 1
    stem = fused.order[1].layer
    assert isinstance(stem, nn.Conv2D) and stem.bias is not None
    assert len(fused.order) == 1 + len(model.layers) - 1 + 2
    x = torch.from_numpy(rs.randn(2, 16, 16, 3).astype(np.float32))
    _close(fused(x), model(x), 1e-4)


def test_shared_layer_stays_shared_and_blocks_the_fold():
    """A Linear used at two nodes is one module in the copy too, and the
    BatchNorm after its first node is not folded: its second node would
    see the folded weights."""
    lin = nn.Linear(4, 4)
    inp = Input((4,))
    out = lin(nn.ReLU()(nn.BatchNorm(4)(lin(inp))))
    model = Model(inp, out).eval()
    assert len(list(model.parameters())) == 4     # lin once, BN's affine
    fused = IRGraph.from_model(model).to_model("fused")
    shared = _layers(fused, nn.Linear)
    assert len(shared) == 2 and shared[0] is shared[1]
    assert shared[0] is not lin
    assert len(_layers(fused, nn.BatchNorm)) == 1
    x = torch.randn(3, 4)
    _close(fused(x), model(x), RTOL)


def test_ir_refuses_what_it_cannot_lift():
    with pytest.raises(TypeError, match="cannot lift"):
        IRGraph.from_model(nn.Linear(2, 2))
    with pytest.raises(ValueError, match="unknown engine"):
        IRGraph.from_model(nn.Sequential([nn.ReLU()])).to_model("dnn")
