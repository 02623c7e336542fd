"""keras ``quantize`` / ``calibrate`` and int8 keras serving in the port
against the JAX package (``bigdl_tpu.nn.quantized._quantize_keras``, its
recording clone, ``InferenceModel(weight_quant="int8")``).

Three keras models: an MLP, a conv net whose middle conv is one layer
used at two nodes (the JAX variables of its second node set equal to the
first's, as the port has one set of weights for both, ROADMAP C.7) with
a grouped conv, and the tiny keras BERT of ``test_torch_port_keras``.
Both packages run the same numpy inputs on the same weights.

Contracts: the calibration scales of a node fed the model's input are
bit-equal to JAX's; deeper nodes see activations summed in another order
(float32 rounding), so their scales agree within ``RTOL`` relative (2.8e-6
measured, a BERT channel scale after a LayerNorm).  The
int8 models' outputs agree within ``RTOL`` of the largest |output|, the
tolerance of ``test_torch_port_int8`` for whole int8 models.  A layer
used at two nodes has one int8 twin, calibrated over both nodes'
inputs."""

import jax
import numpy as np
import pytest
import torch

from bigdl_tpu import keras as JK
from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import quantized as jnq
from bigdl_tpu.serving.inference_model import \
    InferenceModel as JaxInferenceModel
from bigdl_tpu.utils.intermediate import IRGraph as JIRGraph
from bigdl_tpu_torch import keras as K
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn import quantized as nq
from bigdl_tpu_torch.ops import LAUNCHES
from bigdl_tpu_torch.serving import InferenceModel
from bigdl_tpu_torch.utils import load_jax_keras_variables
from bigdl_tpu_torch.utils.intermediate import IRGraph
from test_torch_port_keras import BERT, _close, _perturbed, _tokens, bert

RTOL = 1e-5
KINDS = (jnn.Linear, jnn.Conv2D)


def mlp(K, nn):
    inp = K.Input((12,))
    h = K.ReLU()(K.Dense(12, 16)(inp))
    return K.Model(inp, K.Dense(16, 5)(K.Tanh()(K.Dense(16, 16)(h))))


def convnet(K, nn):
    """NHWC 6x6x3 -> 5 logits; ``mid`` runs at two nodes."""
    inp = K.Input((6, 6, 3))
    mid = K.Conv2D(4, 4, 3, padding=1)
    x = K.ReLU()(K.Conv2D(3, 4, 3, padding=1)(inp))
    x = K.ReLU()(mid(x))
    x = K.ReLU()(mid(x))
    x = K.Conv2D(4, 4, 1, groups=2)(x)
    return K.Model(inp, K.Dense(6 * 6 * 4, 5)(K.Flatten()(x)))


def _equal_shared(jm, v):
    """The variables of every node whose layer an earlier node uses, set
    to that node's (the port keeps one set a layer)."""
    params = dict(v["params"])
    first = {}
    for node in jm.order:
        if node.layer is None or node.name not in params:
            continue
        src = first.setdefault(id(node.layer), node.name)
        params[node.name] = params[src]
    return {"params": params, "state": v.get("state", {})}


def _build(name):
    """(JAX model, variables, port model, calibration batches)."""
    rs = np.random.RandomState(5)
    if name == "bert":
        build = lambda K, nn: bert(K, nn, **BERT)
        batches = [_tokens(4, seed=s) for s in (21, 22)]
    else:
        build = mlp if name == "mlp" else convnet
        shape = (12,) if name == "mlp" else (6, 6, 3)
        batches = [rs.randn(4, *shape).astype(np.float32) for _ in range(2)]
    jm = build(JK, jnn)
    v = _equal_shared(jm, _perturbed(
        jm.init(jax.random.PRNGKey(0), batches[0]), 13))
    return jm, v, load_jax_keras_variables(build(K, nn), jm, v).eval(), \
        batches


@pytest.fixture(scope="module", params=["mlp", "convnet", "bert"])
def pair(request):
    return (request.param, *_build(request.param))


def _leaf_pairs(jm, tm):
    """(JAX layer, port layer) of every quantizable node, first use."""
    out, seen = [], set()
    for jn, pn in zip(jm.order, tm.order):
        if isinstance(jn.layer, KINDS) and id(pn.layer) not in seen:
            seen.add(id(pn.layer))
            out.append((jn.layer, pn.layer))
    return out


def _jax_out(jm, v, x):
    return jax.jit(lambda vv, xx: jm.apply(vv, xx)[0])(v, x)


def _first_fed(jm):
    """ids of the JAX layers at nodes that read the model's input."""
    inputs = {n.id for n in jm.inputs}
    return {id(n.layer) for n in jm.order
            if n.layer is not None and {p.id for p in n.parents} <= inputs}


@pytest.mark.parametrize("granularity", ["tensor", "channel"])
@pytest.mark.parametrize("method", ["minmax", "percentile"])
def test_calibrate_matches_jax(pair, method, granularity):
    name, jm, v, tm, batches = pair
    jc = jnq.calibrate(jm, v, batches, method=method,
                       granularity=granularity)
    tc = nq.calibrate(tm, batches, method=method, granularity=granularity)
    leaves = _leaf_pairs(jm, tm)
    assert len(tc) == len(jc) == len(leaves)
    exact = _first_fed(jm)
    for jl, tl in leaves:
        got, want = np.asarray(tc[id(tl)]), np.asarray(jc[id(jl)])
        assert got.shape == want.shape
        if id(jl) in exact:
            assert got.tobytes() == np.asarray(want, got.dtype).tobytes()
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL)


@pytest.mark.parametrize("mode", ["dynamic", "tensor", "channel",
                                  "weight_only"])
def test_quantize_matches_jax(pair, mode):
    name, jm, v, tm, batches = pair
    before = {k: p.clone() for k, p in tm.state_dict().items()}
    calib = {}
    weight_only = mode == "weight_only"
    if mode in ("tensor", "channel"):
        jc = jnq.calibrate(jm, v, batches, method="minmax", granularity=mode)
        calib = nq.calibrate(tm, batches, method="minmax", granularity=mode)
        # the port's twins take JAX's scales, so both quantize the same
        for jl, tl in _leaf_pairs(jm, tm):
            calib[id(tl)] = jc[id(jl)]
    else:
        jc = None
    jqm, jqv = jnq.quantize(jm, v, jc or None, weight_only=weight_only)
    tq = nq.quantize(tm, calib or None, weight_only=weight_only)
    assert isinstance(tq, K.Model) and tq is not tm
    # node for node the JAX clone's layer kinds; float node layers copied
    jk = [type(n.layer).__name__ for n in jqm.order if n.layer is not None]
    tk = [type(n.layer).__name__ for n in tq.order if n.layer is not None]
    assert tk == jk
    assert not {id(m) for m in tq.modules()} & {id(m) for m in tm.modules()}
    x = batches[0]
    with torch.no_grad():
        got = tq(torch.from_numpy(x))
    _close(got, _jax_out(jqm, jqv, x), RTOL)
    # the caller's model is left as it was
    for k, p in tm.state_dict().items():
        assert torch.equal(p, before[k]), k


def test_shared_layer_has_one_twin_calibrated_over_both_nodes():
    jm, v, tm, batches = _build("convnet")
    calib = nq.calibrate(tm, batches, method="minmax")
    shared = [n for n in tm.order if n.layer is not None][2].layer
    seen = []
    hook = shared.register_forward_pre_hook(
        lambda m, a: seen.append(float(a[0].abs().max())))
    with torch.no_grad():
        for x in batches:
            tm(torch.from_numpy(x))
    hook.remove()
    assert len(seen) == 4                   # two nodes, two batches
    assert calib[id(shared)] == max(seen) / 127.0
    tq = nq.quantize(tm, calib)
    twins = [n.layer for n in tq.order
             if isinstance(n.layer, nq.QuantizedConv2D)]
    assert len(twins) == 4 and twins[1] is twins[2]
    assert len({id(t) for t in twins}) == 3
    assert len([m for m in tq.modules()
                if isinstance(m, nq.QuantizedConv2D)]) == 3


def test_bert_attention_projections_stay_float():
    """Only node layers are swapped (as the JAX clone): the attention's
    own projections are not nodes, so the int8 BERT has 2 Dense twins a
    layer plus the pooler and the head, and float attention."""
    _, _, tm, _ = _build("bert")
    tq = nq.quantize(tm)
    kinds = [type(m).__name__ for m in tq.modules()]
    assert kinds.count("QuantizedLinear") == 2 * BERT["layers"] + 2
    assert kinds.count("MultiHeadAttention") == BERT["layers"]


@pytest.mark.parametrize("fused", [False, True])
def test_predict_int8_keras_matches_jax(fused):
    jm, v, tm, batches = _build("bert")
    x = np.concatenate([batches[0], batches[1][:1]])       # 5 rows: bucket 16
    if fused:
        tm = IRGraph.from_model(tm).to_model("fused")
        jm, v = JIRGraph.from_model(jm, v).to_model("fused")
    want = JaxInferenceModel(jm, v, batch_buckets=(4, 16),
                             weight_quant="int8").predict(x)
    im = InferenceModel(tm, device="cpu", batch_buckets=(4, 16),
                        weight_quant="int8")
    assert im.model is not tm
    n_dense = 2 * BERT["layers"] + 2
    assert sum(isinstance(m, nq.QuantizedLinear)
               for m in im.model.modules()) == n_dense
    before = dict(LAUNCHES)
    got = im.predict(x)
    assert dict(LAUNCHES) == before        # the CPU takes the plain versions
    assert got.shape == (5, 2)
    _close(got, np.asarray(want), RTOL)


def test_inference_model_refuses_a_translation_decode():
    from bigdl_tpu_torch.nn import Transformer
    from bigdl_tpu_torch.serving import DecodeConfig

    model = Transformer(16, 16, 2, num_layers=1, dropout=0.0,
                        mode="translation")
    with pytest.raises(ValueError,
                       match=r"Seq2SeqService\(continuous=True\)"):
        InferenceModel(model, decode=DecodeConfig(), device="cpu")
