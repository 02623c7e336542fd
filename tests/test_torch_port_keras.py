"""The port's keras surface against the JAX package: symbolic calls on
every layer (``MultiHeadAttention`` too), ``keras.engine`` (``Model``,
keras ``Sequential``), ``keras.layers`` (``Merge`` in its seven modes,
the atrous convolutions), ``Activation``, the ``nn.layers_extra`` subset,
``utils.convert.load_jax_keras_variables``, a tiny keras BERT (2 post-LN
layers, d = 32, 4 heads, FFN 64, vocab 64, length 8) unfused and through
the ``"fused"`` IR rewrite, and ``InferenceModel.predict`` of a keras
model with its int8 refusals.

Both packages run the same numpy inputs on the same weights (the JAX
variables, perturbed from a numpy seed so no LayerNorm is the identity
and no position table is zero, loaded into the port graph).  Outputs
agree within ``RTOL`` of the largest |output|: float32 sums in another
order (JAX matmuls at "highest" precision, tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import keras as JK
from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.intermediate import IRGraph as JIRGraph
from bigdl_tpu_torch import keras as K
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.keras.engine import Node
from bigdl_tpu_torch.nn.quantized import calibrate, quantize
from bigdl_tpu_torch.serving import InferenceModel
from bigdl_tpu_torch.utils import load_jax_keras_variables
from bigdl_tpu_torch.utils.intermediate import FusedLayerNorm, IRGraph

RTOL = 1e-5
BERT = dict(vocab=64, length=8, d=32, heads=4, ffn=64, layers=2)


def _close(got, want, rtol=RTOL):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor)
                 else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=rtol * max(1.0, float(np.abs(want).max())))


def _x(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _perturbed(variables, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.2 * rs.randn(*np.shape(a))).astype(
            np.float32), variables)


def _pair(build, *xs, seed=0):
    """(JAX model, its perturbed variables, the port model loaded with
    them, in eval mode)."""
    jm = build(JK, jnn)
    v = _perturbed(jm.init(jax.random.PRNGKey(0), *xs), seed)
    tm = load_jax_keras_variables(build(K, nn), jm, v).eval()
    return jm, v, tm


def bert(K, nn, vocab, length, d, heads, ffn, layers):
    """BERT's encoder written with either package's keras API: learned
    positions as a CAdd, post-LN blocks, a tanh pooler on [CLS] and a
    2-label head."""
    tok = K.Input((length,), dtype=np.int32)
    x = K.Embedding(vocab, d)(tok)
    x = nn.CAdd((length, d))(x)
    x = K.Dropout(0.1)(K.LayerNorm(d, eps=1e-12)(x))
    for _ in range(layers):
        a = K.Dropout(0.1)(K.MultiHeadAttention(d, heads)(x))
        x = K.LayerNorm(d, eps=1e-12)(K.Merge("sum")([x, a]))
        f = K.Dense(ffn, d)(K.GELU()(K.Dense(d, ffn)(x)))
        x = K.LayerNorm(d, eps=1e-12)(K.Merge("sum")([x, K.Dropout(0.1)(f)]))
    p = K.Activation("tanh")(K.Dense(d, d)(nn.Select(1, 0)(x)))
    out = K.LogSoftMax()(K.Dense(d, 2)(K.Dropout(0.1)(p)))
    return K.Model(tok, out)


def _tokens(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, BERT["vocab"], (n, BERT["length"])).astype(np.int32)


@pytest.fixture(scope="module")
def tiny_bert():
    ids = _tokens(3)
    return (*_pair(lambda K, nn: bert(K, nn, **BERT), ids, seed=11), ids)


# ---------------------------------------------------------------------------
# symbolic calls and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("make", [
    lambda: nn.Linear(4, 4), lambda: nn.MultiHeadAttention(8, 2),
    lambda: nn.TransformerLayer(8, 2, 16),
    lambda: nn.Sequential([nn.ReLU()]), lambda: K.Merge("sum")])
def test_every_layer_called_on_a_node_makes_a_node(make):
    layer = make()
    a, b = K.Input((4,)), K.Input((4,))
    node = layer([a, b]) if isinstance(layer, K.Merge) else layer(a)
    assert isinstance(node, Node) and node.layer is layer
    assert node.parents == ([a, b] if isinstance(layer, K.Merge) else [a])
    assert node.name == f"{layer.name}_{node.id}"


def test_attention_blocks_keep_their_parameter_names():
    mha = nn.MultiHeadAttention(8, 2, name="attn")
    assert mha.name == "attn"
    assert [n for n, _ in mha.named_parameters()] == [
        "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"]
    layer = nn.TransformerLayer(8, 2, 16)
    assert layer.name == "TransformerLayer"
    assert [n for n, _ in layer.named_parameters()] == [
        f"attn.{w}" for w in ("wq", "bq", "wk", "bk", "wv", "bv", "wo",
                              "bo")] + [
        "ffn.l1.weight", "ffn.l1.bias", "ffn.l2.weight", "ffn.l2.bias",
        "ln1.weight", "ln1.bias", "ln2.weight", "ln2.bias"]


def test_model_registers_each_layer_once_and_checks_its_inputs():
    lin = nn.Linear(4, 4)
    inp = K.Input((4,))
    h = lin(inp)
    model = K.Model(inp, lin(nn.ReLU()(h)))
    names = [n for n, _ in model.named_parameters()]
    assert names == [f"{h.name}.weight", f"{h.name}.bias"]
    x = torch.randn(2, 4)
    _close(model(x), lin(torch.relu(lin(x))))
    model.to(torch.float64)
    assert lin.weight.dtype == torch.float64
    with pytest.raises(ValueError, match="takes 1 inputs"):
        model(x, x)


def test_model_forward_drops_each_value_after_its_last_reader():
    """A forward holds a node's output only until its last reader ran
    (outputs excepted), not to the end of the forward."""
    import weakref

    first, last = K.ReLU(), K.Sigmoid()
    d1, d2 = K.Dense(4, 4), K.Dense(4, 4)
    inp = K.Input((4,))
    skip = K.Tanh()(first(inp))
    out = K.Merge("sum")([d1(skip), skip])
    model = K.Model(inp, [last(d2(out)), skip])
    seen = {}
    first.register_forward_hook(
        lambda m, a, y: seen.update(h=weakref.ref(y)))
    last.register_forward_pre_hook(
        lambda m, a: seen.update(alive=seen["h"]() is not None))
    x = torch.randn(2, 4)
    y, s = model(x)
    assert seen["alive"] is False
    want_s = torch.tanh(torch.relu(x))
    _close(s, want_s)
    _close(y, torch.sigmoid(d2(d1(want_s) + want_s)))
    assert K.Sequential().order == []


def test_keras_sequential_matches_jax():
    def build(K, nn):
        s = K.Sequential([K.Dense(6, 8), K.ReLU()])
        return s.add(K.Dense(8, 3))

    x = _x((5, 6), 0)
    jm, v, tm = _pair(build, x)
    assert len(tm.order) == 4 and len(list(tm.parameters())) == 4
    _close(tm(torch.from_numpy(x)), jm.apply(v, x)[0])


def test_multi_input_model_matches_jax():
    def build(K, nn):
        a, b = K.Input((6,)), K.Input((6,))
        h = K.Merge("concat")([K.Dense(6, 4)(a), K.Dense(6, 4)(b)])
        return K.Model([a, b], [K.Tanh()(h), K.Merge("mul")([a, b])])

    xa, xb = _x((3, 6), 1), _x((3, 6), 2)
    jm, v, tm = _pair(build, xa, xb)
    want = jm.apply(v, xa, xb)[0]
    got = tm(torch.from_numpy(xa), torch.from_numpy(xb))
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# keras layers, Activation and the layers_extra subset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sum", "mul", "ave", "max", "concat", "dot",
                                  "cosine"])
def test_merge_matches_jax(mode):
    xs = [_x((3, 5), s) for s in range(3 if mode in ("sum", "mul", "ave",
                                                     "max", "concat") else 2)]
    want, _ = JK.Merge(mode).forward({}, {}, *[jnp.asarray(x) for x in xs])
    got = K.Merge(mode)(*[torch.from_numpy(x) for x in xs])
    _close(got, want)
    _close(K.Merge(mode)([torch.from_numpy(x) for x in xs]), want)


def test_merge_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode 'add'"):
        K.Merge("add")


@pytest.mark.parametrize("name,jax_layer,args,n_in", [
    ("CAdd", jnn.CAdd, ((4, 5),), 1), ("Select", jnn.Select, (1, 0), 1),
    ("Select", jnn.Select, (-1, -2), 1), ("CMaxTable", jnn.CMaxTable, (), 3),
    ("CAveTable", jnn.CAveTable, (), 3),
    ("DotProduct", jnn.DotProduct, (), 2),
    ("CosineDistance", jnn.CosineDistance, (), 2)])
def test_layers_extra_match_jax(name, jax_layer, args, n_in):
    xs = [_x((3, 4, 5), s) for s in range(n_in)]
    jl = jax_layer(*args)
    v = _perturbed(jl.init(jax.random.PRNGKey(0), *xs), 3)
    tl = getattr(nn, name)(*args)
    if v["params"]:
        tl.bias.data.copy_(torch.from_numpy(v["params"]["bias"]))
    _close(tl(*[torch.from_numpy(x) for x in xs]), jl.apply(v, *xs)[0])


def test_cosine_distance_floors_the_norms():
    z = torch.zeros(2, 3)
    assert torch.equal(nn.CosineDistance()(z, z), torch.zeros(2))


@pytest.mark.parametrize("dims", [1, 2])
def test_atrous_convolutions_match_jax(dims):
    def build(K, nn):
        conv = (K.AtrousConvolution1D(3, 4, 3, atrous_rate=2) if dims == 1
                else K.AtrousConvolution2D(3, 4, 3, atrous_rate=2,
                                           padding="SAME"))
        inp = K.Input((9, 3) if dims == 1 else (9, 9, 3))
        return K.Model(inp, conv(inp))

    x = _x((2, 9, 3) if dims == 1 else (2, 9, 9, 3), 4)
    jm, v, tm = _pair(build, x)
    _close(tm(torch.from_numpy(x)), jm.apply(v, x)[0])


@pytest.mark.parametrize("name", ["relu", "relu6", "tanh", "sigmoid",
                                  "hard_sigmoid", "softmax", "log_softmax",
                                  "softplus", "softsign", "gelu", "elu",
                                  "silu", "swish", "linear"])
def test_activation_matches_jax(name):
    x = _x((3, 7), 5) * 3
    want, _ = JK.Activation(name).apply({}, jnp.asarray(x))
    _close(K.Activation(name.upper())(torch.from_numpy(x)), want)


def test_activation_and_exports_name_only_ported_layers():
    with pytest.raises(ValueError, match="unknown activation 'mish'"):
        K.Activation("mish")
    for name in K.__all__:
        assert getattr(K, name) is not None
    assert set(K.__all__) <= set(JK.__all__) | {"AvgPool2D", "MaxPool2D"}


# ---------------------------------------------------------------------------
# the variables loader
# ---------------------------------------------------------------------------


def test_loader_refuses_graphs_that_differ():
    def build(K, nn, act="ReLU", rewire=False):
        inp = K.Input((4,))
        a = K.Dense(4, 4)(inp)
        h = getattr(K, act)()(inp if rewire else a)
        return K.Model(inp, K.Merge("sum")([a, h]))

    x = _x((2, 4), 6)
    jm = build(JK, jnn)
    v = jm.init(jax.random.PRNGKey(0), x)
    load_jax_keras_variables(build(K, nn), jm, v)
    with pytest.raises(ValueError, match="the JAX graph has ReLU, the "
                                         "port's Tanh"):
        load_jax_keras_variables(build(K, nn, act="Tanh"), jm, v)
    with pytest.raises(ValueError, match="reads other nodes"):
        load_jax_keras_variables(build(K, nn, rewire=True), jm, v)
    with pytest.raises(ValueError, match="nodes, the port's"):
        load_jax_keras_variables(K.Model(*(lambda i: (i, K.ReLU()(i)))(
            K.Input((4,)))), jm, v)


def test_loader_refuses_different_weights_for_a_shared_layer():
    def build(K, nn, shared):
        inp = K.Input((4,))
        lin = K.Dense(4, 4)
        second = lin if shared else K.Dense(4, 4)
        return K.Model(inp, second(K.ReLU()(lin(inp))))

    x = _x((2, 4), 7)
    jm = build(JK, jnn, shared=False)
    v = jm.init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="shared with an earlier node"):
        load_jax_keras_variables(build(K, nn, shared=True), jm, v)


# ---------------------------------------------------------------------------
# the tiny keras BERT, unfused and fused
# ---------------------------------------------------------------------------


def test_tiny_bert_matches_jax(tiny_bert):
    jm, v, tm, ids = tiny_bert
    got = tm(torch.from_numpy(ids))
    assert got.shape == (3, 2) and torch.isfinite(got).all()
    _close(got, jm.apply(v, ids)[0])


def test_tiny_bert_fused_matches_jax_fused(tiny_bert):
    jm, v, tm, ids = tiny_bert
    fused = IRGraph.from_model(tm).to_model("fused")
    kinds = [type(n.layer).__name__ for n in fused.order]
    assert kinds.count("FusedLayerNorm") == 1 + 2 * BERT["layers"]
    assert "LayerNorm" not in kinds and "Dropout" not in kinds
    assert all(ln.eps == 1e-12 for ln in fused.modules()
               if isinstance(ln, FusedLayerNorm))
    jf, jv = JIRGraph.from_model(jm, v).to_model("fused")
    # eager interpret-mode Pallas is 10x slower than under jit
    want = jax.jit(lambda vv, x: jf.apply(vv, x)[0])(jv, ids)
    _close(fused(torch.from_numpy(ids)), want)
    _close(fused(torch.from_numpy(ids)), jm.apply(v, ids)[0])


# ---------------------------------------------------------------------------
# serving a keras model
# ---------------------------------------------------------------------------


def test_predict_serves_a_keras_model(tiny_bert):
    jm, v, tm, _ = tiny_bert
    fused = IRGraph.from_model(tm).to_model("fused")
    im = InferenceModel(fused, device="cpu", batch_buckets=(1, 4, 16))
    calls = []
    im.model.register_forward_pre_hook(
        lambda m, a: calls.append(tuple(a[0].shape)))
    for n in (1, 3, 20):
        ids = _tokens(n, seed=n)
        got = im.predict(ids)
        assert got.shape == (n, 2) and got.dtype == np.float32
        with torch.no_grad():
            _close(got, tm(torch.from_numpy(ids)))
    L = BERT["length"]
    assert calls == [(1, L), (4, L), (16, L), (4, L)]


def test_keras_models_refuse_int8():
    model = K.Model(*(lambda i: (i, K.Dense(4, 2)(i)))(K.Input((4,))))
    for call in (lambda: InferenceModel(model, device="cpu",
                                        weight_quant="int8"),
                 lambda: quantize(model),
                 lambda: calibrate(model, [np.zeros((2, 4), np.float32)])):
        with pytest.raises(ValueError, match="keras Model .*item 7.1"):
            call()
