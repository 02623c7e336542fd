"""``bigdl_tpu_torch.nn.qat`` against ``bigdl_tpu.nn.qat``: fake
quantization's values and straight-through gradients, the EMA activation
ranges over training steps, ``convert_qat``'s int8 model, on a
``Sequential`` MLP (the JAX package's ``TestQAT`` case), a keras graph
and LeNet-5.  Both packages start from the same weights (the JAX init
copied into the port), train on the same numpy data with plain SGD, and
their losses, ranges and outputs agree within 1e-5 (the int8 outputs as
``tests/test_torch_port_int8.py`` holds them)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.keras.engine import Input as JInput, Model as JModel
from bigdl_tpu.nn import qat as jqat
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.keras.engine import Input, Model
from bigdl_tpu_torch.nn import qat
from bigdl_tpu_torch.nn import quantized as nq
from bigdl_tpu_torch.utils.convert import (export_variables,
                                           load_jax_keras_variables,
                                           load_jax_variables)
from test_torch_port_vision import _close, port_and_jax

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_fake_quant_values_and_ste_gradient():
    rs = np.random.RandomState(0)
    x = rs.randn(64, 16).astype(np.float32) * 3
    scale = (np.abs(x).max(axis=0) / 127.0).astype(np.float32)
    # ties: values that land on .5 of a step round half to even
    x[0, :4] = scale[:4] * np.array([0.5, 1.5, 2.5, -2.5], np.float32)
    g = rs.randn(*x.shape).astype(np.float32)
    want = np.asarray(jqat.fake_quant(jnp.asarray(x), jnp.asarray(scale)))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(
        jqat.fake_quant(v, jnp.asarray(scale)) * g))(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    got = qat.fake_quant(xt, _t(scale))
    (got * _t(g)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(xt.grad.numpy(), want_g)
    np.testing.assert_array_equal(got.detach().numpy()[0, :4],
                                  scale[:4] * np.array([0, 2, 2, -2]))


def _mlp(m):
    return m.Sequential([m.Linear(8, 32), m.ReLU(), m.Linear(32, 1)])


def _data():
    rs = np.random.RandomState(0)
    x = rs.randn(256, 8).astype(np.float32)
    return x, x @ rs.randn(8, 1).astype(np.float32)


def _jax_train(model, variables, x, y, steps, lr):
    """The JAX package's ``TestQAT._train``, logging each step's loss
    and state."""

    @jax.jit
    def step(p, s):
        def loss_fn(p):
            out, ns = model.forward(p, s, jnp.asarray(x), training=True)
            return jnp.mean((out - jnp.asarray(y)) ** 2), ns

        (l, ns), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return jax.tree_util.tree_map(lambda a, b: a - lr * b, p, g), ns, l

    p, s = variables["params"], variables["state"]
    losses, states = [], []
    for _ in range(steps):
        p, s, loss = step(p, s)
        losses.append(float(loss))
        states.append(jax.tree_util.tree_map(np.asarray, s))
    return {"params": p, "state": s}, losses, states


def _port_train(model, x, y, steps, lr):
    model.train()
    xt, yt = _t(x), _t(y)
    losses, amaxes = [], []
    for _ in range(steps):
        loss = torch.mean((model(xt) - yt) ** 2)
        model.zero_grad()
        loss.backward()
        with torch.no_grad():
            for p in model.parameters():
                p -= lr * p.grad
        losses.append(float(loss.detach()))
        amaxes.append([float(b) for n, b in model.named_buffers()
                       if n.endswith("act_amax")])
    return losses, amaxes


def _jax_amaxes(state):
    return [float(v["act_amax"]) for _, v in sorted(state.items())
            if isinstance(v, dict) and "act_amax" in v]


@pytest.fixture(scope="module")
def mlp_pair():
    x, y = _data()
    jm = _mlp(jnn)
    v = jm.init(jax.random.PRNGKey(0), x[:2])
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    tm = load_jax_variables(_mlp(nn), v)
    return jm, tm, v, x, y


def test_prepare_qat_keeps_keys_and_the_caller_model(mlp_pair):
    jm, tm, v, x, _ = mlp_pair
    jq, jqv = jqat.prepare_qat(jm, v)
    tq = qat.prepare_qat(tm)
    assert [type(m).__name__ for m in tq.layers] == \
        [type(m).__name__ for m in jq.layers]
    got = export_variables(tq)
    assert set(got["params"]) == set(jqv["params"]) == set(v["params"])
    assert jax.tree_util.tree_structure(got["state"]) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(np.asarray, jqv["state"]))
    assert not {id(p) for p in tq.parameters()} & \
        {id(p) for p in tm.parameters()}
    # untracked ranges pass the activations through; the weights are
    # fake-quantized all the same
    tq.eval()
    with torch.no_grad():
        _close(tq(_t(x)), jq.apply(jqv, x)[0], TOL)
    assert all(float(b) == 0 for n, b in tq.named_buffers()
               if n.endswith("act_amax"))


def test_qat_training_tracks_jax_ranges_and_converts(mlp_pair):
    jm, tm, v, x, y = mlp_pair
    jq, jqv = jqat.prepare_qat(jm, v)
    jqv, jlosses, jstates = _jax_train(jq, jqv, x, y, steps=20, lr=0.01)
    tq = qat.prepare_qat(tm)
    losses, amaxes = _port_train(tq, x, y, steps=20, lr=0.01)
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    for got, st in zip(amaxes, jstates):
        np.testing.assert_allclose(got, _jax_amaxes(st), rtol=TOL)
    assert all(a > 0 for a in amaxes[-1])

    jint8, jv8 = jqat.convert_qat(jq, jqv)
    int8 = qat.convert_qat(tq)
    kinds = [type(m).__name__ for m in int8.layers]
    assert kinds == [type(m).__name__ for m in jint8.layers]
    assert kinds.count("QuantizedLinear") == 2
    for i, layer in enumerate(int8.layers):
        if isinstance(layer, nq.QuantizedLinear):
            want = np.asarray(jv8["params"][jint8._key(i)]["act_scale"])
            np.testing.assert_allclose(float(layer.act_scale), want,
                                       rtol=TOL)
    with torch.no_grad():
        got = int8(_t(x))
    _close(got, jax.jit(lambda v, a: jint8.apply(v, a)[0])(jv8, x), TOL)


def test_jax_qat_state_loads_into_the_port(mlp_pair):
    """A JAX QAT model's params and ``act_amax`` state, loaded by
    ``utils.convert``, give the JAX eval forward and int8 model."""
    jm, tm, v, x, y = mlp_pair
    jq, jqv = jqat.prepare_qat(jm, v)
    jqv, _, _ = _jax_train(jq, jqv, x, y, steps=5, lr=0.01)
    jqv = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jqv)
    tq = load_jax_variables(qat.prepare_qat(_mlp(nn)), jqv)
    assert _jax_amaxes(export_variables(tq)["state"]) == \
        _jax_amaxes(jqv["state"])
    tq.eval()
    with torch.no_grad():
        _close(tq(_t(x)), jq.apply(jqv, x)[0], TOL)
    jint8, jv8 = jqat.convert_qat(jq, jqv)
    with torch.no_grad():
        _close(qat.convert_qat(tq)(_t(x)),
               jax.jit(lambda v, a: jint8.apply(v, a)[0])(jv8, x), TOL)


def _keras(m, I, M):
    inp = I((8,))
    h = m.Linear(8, 16)(inp)
    h = m.ReLU()(h)
    out = m.Linear(16, 3)(h)
    return M(inp, out)


def test_qat_on_a_keras_graph():
    jmodel = _keras(jnn, JInput, JModel)
    x = np.random.RandomState(0).randn(32, 8).astype(np.float32)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), v)
    tmodel = load_jax_keras_variables(_keras(nn, Input, Model), jmodel, v)

    jq, jqv = jqat.prepare_qat(jmodel, v)
    tq = qat.prepare_qat(tmodel)
    assert sum(isinstance(n.layer, qat.QATLinear) for n in tq.order) == 2
    _, st = jq.forward(jqv["params"], jqv["state"], jnp.asarray(x),
                       training=True)
    jqv = {"params": jqv["params"], "state": st}
    tq.train()
    with torch.no_grad():
        tq(_t(x))
    jam = [float(st[n.name]["act_amax"]) for n in jq.order
           if isinstance(n.layer, jqat.QATLinear)]
    tam = [float(n.layer.act_amax) for n in tq.order
           if isinstance(n.layer, qat.QATLinear)]
    np.testing.assert_allclose(tam, jam, rtol=TOL)
    assert len(tam) == 2 and all(a > 0 for a in tam)

    jint8, jv8 = jqat.convert_qat(jq, jqv)
    int8 = qat.convert_qat(tq)
    assert sum(isinstance(n.layer, nq.QuantizedLinear)
               for n in int8.order) == 2
    int8.eval()
    with torch.no_grad():
        got = int8(_t(x))
    _close(got, jax.jit(lambda v, a: jint8.apply(v, a)[0])(jv8, x), TOL)


def test_qat_lenet5_steps_and_int8_model():
    """LeNet-5 (both convs and both Linears wrapped): 3 SGD steps of
    cross-entropy on 16 images, ranges and losses against JAX's, then
    the converted int8 model's log-probs."""
    jm, tm, v, _ = port_and_jax("lenet5")
    rs = np.random.RandomState(1)
    x = rs.randn(16, 28, 28, 1).astype(np.float32)
    y = rs.randint(0, 10, size=16)
    onehot = np.eye(10, dtype=np.float32)[y]
    jq, jqv = jqat.prepare_qat(jm, v)

    @jax.jit
    def jstep(p, s):
        def loss_fn(p):
            out, ns = jq.forward(p, s, jnp.asarray(x), training=True)
            return -jnp.mean(jnp.sum(out * onehot, -1)), ns

        (l, ns), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return jax.tree_util.tree_map(lambda a, b: a - 0.05 * b, p, g), \
            ns, l

    p, s, jl = jqv["params"], jqv["state"], []
    for _ in range(3):
        p, s, loss = jstep(p, s)
        jl.append(float(loss))
    jqv = {"params": p, "state": s}

    tq = qat.prepare_qat(tm)
    assert sum(isinstance(m, (qat.QATLinear, qat.QATConv2D))
               for m in tq.modules()) == 4
    tq.train()
    xt, ot, tl = _t(x), _t(onehot), []
    for _ in range(3):
        loss = -torch.mean(torch.sum(tq(xt) * ot, -1))
        tq.zero_grad()
        loss.backward()
        with torch.no_grad():
            for prm in tq.parameters():
                prm -= 0.05 * prm.grad
        tl.append(float(loss.detach()))
    # the first step to 1e-5; after it a float32 reordering of the
    # convs can move an activation across a rounding edge of the int8
    # grid, a jump of one step (ROADMAP C.14's bounds for conv nets)
    np.testing.assert_allclose(tl[0], jl[0], rtol=TOL)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    np.testing.assert_allclose(_jax_amaxes(export_variables(tq)["state"]),
                               _jax_amaxes(jax.tree_util.tree_map(
                                   np.asarray, s)), rtol=1e-4)
    # the int8 model from the same QAT weights and ranges (the JAX ones,
    # carried across): int8 amplifies the trajectories' last bits
    jint8, jv8 = jqat.convert_qat(jq, jqv)
    carried = load_jax_variables(tq, jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jqv))
    int8 = qat.convert_qat(carried).eval()
    assert sum(isinstance(m, (nq.QuantizedLinear, nq.QuantizedConv2D))
               for m in int8.modules()) == 4
    with torch.no_grad():
        got = int8(xt)
    _close(got, jax.jit(lambda v, a: jint8.apply(v, a)[0])(jv8, x), TOL)
