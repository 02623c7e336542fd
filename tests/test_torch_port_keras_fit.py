"""The port's keras training surface against the JAX package:
``keras.training``'s string tables, ``compile`` / ``fit`` / ``evaluate``
/ ``predict`` / ``get_weights`` / ``set_weights`` / ``summary`` of keras
``Model`` and ``Sequential``, ``keras.autograd``'s op set and
``CustomLoss``, and the Inception and VGG models.

Both packages train the same graph from the same JAX-initialised weights
on the same numpy data (the JAX ``Optimizer`` on one data replica, its
weights set through ``set_initial_variables``; the port's keras model
loaded through ``load_jax_keras_variables``): losses, evaluation and
predictions within 1e-5 of the largest |value| compared, at least 1
(float32 sums in another order, which Adam's steps carry on).  A model whose
BatchNorm trains takes ROADMAP C.14's bounds: the first loss 1e-5, the
later ones 1e-4."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu.keras.training as jtraining
from bigdl_tpu import keras as JK
from bigdl_tpu import models as jmodels
from bigdl_tpu import nn as jnn
from bigdl_tpu.keras import autograd as JA
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu_torch import keras as K
from bigdl_tpu_torch import models
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.keras import autograd as A
from bigdl_tpu_torch.keras import training
from bigdl_tpu_torch.optim import validation as pval
from bigdl_tpu_torch.utils import (export_variables, load_jax_keras_variables,
                                   load_jax_variables)

CPU = "cpu"
TOL = 1e-5


def synthetic(n=256, d=16, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d) * 3
    y = rng.randint(0, classes, size=n)
    x = (centers[y] + rng.randn(n, d)).astype(np.float32)
    return x, y.astype(np.int32)


def sequential(K):
    return K.Sequential([K.Dense(16, 32), K.Activation("relu"),
                         K.Dense(32, 4)])


def two_branch(K, nn):
    inp = K.Input(shape=(16,))
    a = K.Activation("relu")(K.Dense(16, 32)(inp))
    b = K.Dense(16, 32)(inp)
    out = K.Dense(32, 4)(nn.CAddTable()([a, b]))
    return K.Model(inp, out)


def two_inputs(K, nn):
    a, b = K.Input(shape=(16,)), K.Input(shape=(16,))
    out = K.Dense(16, 4)(nn.CAddTable()([a, b]))
    return K.Model([a, b], out)


def _jax_vars(jm, *xs, seed=0):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  jm.init(jax.random.PRNGKey(seed), *xs))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _results(res):
    return [(r.name, r.result) for r in res]


def _jax_fit(monkeypatch, tmp_path, jm, init, fit_args, fit_kw, x_eval,
             y_eval, x_pred):
    """fit / evaluate / predict of the JAX keras model from ``init``:
    (losses, evaluation, predictions, trained variables)."""
    made = []

    class Opt(jtraining.Optimizer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.set_initial_variables(init)
            self.set_train_summary(str(tmp_path / f"jax{len(made)}"))
            made.append(self)

    monkeypatch.setattr(jtraining, "Optimizer", Opt)
    Engine.reset()
    init_engine(data=1)
    try:
        # the JAX summary records the loss at log points only
        trained = jm.fit(*fit_args, log_every=1, **fit_kw)
        losses = [v for _, v in made[0]._train_summary.read_scalar("loss")]
        evaluation = _results(jm.evaluate(x_eval, y_eval))
        pred = np.asarray(jm.predict(x_pred))
        return losses, evaluation, pred, trained.variables
    finally:
        Engine.reset()


def _port(tm, jm, init):
    return load_jax_keras_variables(tm, jm, init)


@pytest.mark.parametrize("build", ["sequential", "two_branch"])
def test_fit_evaluate_predict_match_jax(monkeypatch, tmp_path, build):
    """tests/test_keras_models.py's two models, compiled with adam,
    sparse categorical cross-entropy and accuracy, two epochs with
    validation."""
    x, y = synthetic()
    make = {"sequential": lambda K, nn: sequential(K),
            "two_branch": two_branch}[build]
    jm = make(JK, jnn)
    init = _jax_vars(jm, x[:1])
    kw = dict(batch_size=64, nb_epoch=2, validation_data=(x[192:], y[192:]))
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=["accuracy", "loss"])
    want_l, want_e, want_p, want_v = _jax_fit(
        monkeypatch, tmp_path, jm, init, (x[:192], y[:192]), kw,
        x[192:], y[192:], x[:8])
    tm = _port(make(K, nn), jm, init)
    tm.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
               metrics=["accuracy", "loss"])
    trained = tm.fit(x[:192], y[:192], device=CPU, **kw)
    assert len(trained.losses) == len(want_l) == 6
    _close(trained.losses, want_l)
    got_e = _results(tm.evaluate(x[192:], y[192:]))
    assert [n for n, _ in got_e] == [n for n, _ in want_e]
    _close([v for _, v in got_e], [v for _, v in want_e])
    _close(tm.predict(x[:8]), want_p)
    # the trained weights, node for node
    got_w = tm.get_weights()["params"]
    for jn, pn in zip(jm.order, tm.order):
        if jn.name in want_v["params"]:
            for k in want_v["params"][jn.name]:
                _close(got_w[pn.name][k], want_v["params"][jn.name][k])


def test_epochs_alias_and_the_refusals():
    x, y = synthetic(n=64)
    tm = sequential(K).compile("sgd", "sparse_categorical_crossentropy")
    with pytest.raises(RuntimeError, match="no weights yet"):
        tm.predict(x)
    trained = tm.fit(x, y, batch_size=32, epochs=3, device=CPU)
    assert len(trained.losses) == 6              # 2 steps an epoch, 3 epochs
    # parallelism= is ported (test_torch_port_layout_train) and keeps the
    # JAX package's refusals
    with pytest.raises(ValueError, match="checkpoint_path"):
        tm.fit(x, y, batch_size=32, parallelism="dp", device=CPU,
               checkpoint_path="unused")
    with pytest.raises(ValueError, match="exclusive"):
        tm.fit(x, y, batch_size=32, parallelism="dp", device=CPU,
               seq_parallel=True)
    # seq_parallel is ported (tests/test_torch_port_seq.py) and, as in
    # JAX, needs a mesh seq axis > 1
    with pytest.raises(ValueError, match="seq axis"):
        tm.fit(x, y, batch_size=32, seq_parallel=True, device=CPU)
    with pytest.raises(RuntimeError, match="compile"):
        sequential(K).fit(x, y, device=CPU)
    m2 = two_inputs(K, nn).compile("sgd", "mse")
    with pytest.raises(ValueError, match="requires labels y"):
        m2.fit([x, x], device=CPU)
    m2.set_weights({"params": {
        n.name: {"weight": np.ones((16, 4), np.float32),
                 "bias": np.zeros(4, np.float32)}
        for n in m2.order if isinstance(n.layer, nn.Linear)}}, device=CPU)
    with pytest.raises(ValueError, match="requires labels y for evaluate"):
        m2.evaluate([x, x])
    out = m2.predict([x, x])
    np.testing.assert_allclose(
        out, np.repeat((2 * x).sum(1, keepdims=True), 4, 1), rtol=1e-6)
    (res,) = m2.evaluate([x, x], np.zeros((64, 4), np.float32))
    assert res.name == "Loss" and res.result > 0     # MSE by default


def test_weights_round_trip_and_summary(monkeypatch):
    """get_weights / set_weights trade node-keyed trees: the JAX
    variables keyed by the JAX node names load into the port under the
    port's names, round trip to the bit, and a shared layer refuses
    different weights at its two nodes (C.7).  ``summary`` is the JAX
    text with each package's node names."""
    x, _ = synthetic(n=8)
    jm = two_branch(JK, jnn)
    init = _jax_vars(jm, x[:1], seed=3)
    tm = two_branch(K, nn)
    renamed = {kind: {pn.name: init[kind][jn.name]
                      for jn, pn in zip(jm.order, tm.order)
                      if jn.name in init[kind]}
               for kind in ("params", "state")}
    tm.set_weights(renamed, device=CPU)
    want = jm.apply(init, x)[0]
    _close(tm.predict(x), want)
    w = tm.get_weights()
    assert set(w["params"]) == set(renamed["params"])
    for node, tree in renamed["params"].items():
        for k, v in tree.items():
            np.testing.assert_array_equal(w["params"][node][k], v)
    before = tm.predict(x)
    tm.set_weights(w, device=CPU)
    np.testing.assert_array_equal(tm.predict(x), before)
    with pytest.raises(KeyError, match="no variables"):
        two_branch(K, nn).set_weights({"params": {}}, device=CPU)

    inp = K.Input((16,))
    lin = K.Dense(16, 16)
    shared = K.Model(inp, lin(K.Activation("relu")(lin(inp))))
    first, second = [n for n in shared.order if n.layer is lin]
    good = {"params": {n.name: {"weight": np.eye(16, dtype=np.float32),
                                "bias": np.zeros(16, np.float32)}
                       for n in (first, second)}}
    shared.set_weights(good, device=CPU)
    assert set(shared.get_weights()["params"]) == {first.name, second.name}
    good["params"][second.name]["bias"] = np.ones(16, np.float32)
    with pytest.raises(ValueError, match="shared with an earlier node"):
        shared.set_weights(good, device=CPU)

    def canon(text, order):
        for i, n in enumerate(order):
            text = re.sub(rf"\b{re.escape(n.name)}\b", f"<{i}>", text)
        return text

    assert canon(tm.summary(), tm.order) == canon(jm.summary(), jm.order)


def test_string_tables_resolve_to_the_jax_counterparts():
    """Every string of _OPTIMIZERS, _LOSSES and _METRICS names the port
    class of the JAX entry, with the same hyper-parameters."""
    assert set(training._OPTIMIZERS) == set(jtraining._OPTIMIZERS)
    for name in jtraining._OPTIMIZERS:
        got, want = (training._OPTIMIZERS[name](),
                     jtraining._OPTIMIZERS[name]())
        assert type(got).__name__ == type(want).__name__, name
        for attr in ("learning_rate", "lr"):
            if hasattr(want, attr):
                assert getattr(got, attr) == getattr(want, attr), name
    assert set(training._LOSSES) == set(jtraining._LOSSES)
    assert set(training._METRICS) == set(jtraining._METRICS)
    rs = np.random.RandomState(1)
    out = rs.rand(6, 5).astype(np.float32) + 0.05
    tgt = (rs.rand(6, 5) > 0.5).astype(np.float32)
    for name in jtraining._LOSSES:
        got, want = training._LOSSES[name](), jtraining._LOSSES[name]()
        assert type(got).__name__ == type(want).__name__, name
        o = out / out.sum(1, keepdims=True) if "crossentropy" in name \
            and name != "binary_crossentropy" else out
        if name in ("sparse_categorical_crossentropy", "nll"):
            t = rs.randint(0, 5, 6).astype(np.int32)
        else:
            t = tgt
        o_in = np.log(o) if name == "nll" else o
        np.testing.assert_allclose(
            float(got(torch.from_numpy(o_in), torch.from_numpy(t))),
            float(want(jnp.asarray(o_in), jnp.asarray(t))), rtol=1e-5,
            atol=1e-6, err_msg=name)
    for name in jtraining._METRICS:
        got, want = training._METRICS[name](), jtraining._METRICS[name]()
        assert type(got).__name__ == type(want).__name__, name
    comp = training.resolve_compile("adam", "mse", ["loss", "top5",
                                                    pval.MAE()])
    assert isinstance(comp["metrics"][0], pval.Loss)
    assert comp["metrics"][0].criterion is comp["loss"]
    assert isinstance(comp["metrics"][1], pval.Top5Accuracy)
    assert isinstance(comp["metrics"][2], pval.MAE)


# ---------------------------------------------------------------------------
# keras.autograd
# ---------------------------------------------------------------------------

UNARY = ["neg", "abs", "square", "sqrt", "exp", "log", "softsign",
         "softplus", "sum", "mean", "expand_dims", "squeeze"]
BINARY = ["add", "sub", "mul", "div", "maximum", "minimum", "pow", "dot"]


def _op_model(K, A, name):
    a = K.Input((3, 4))
    if name in BINARY:
        b = K.Input((3, 4) if name != "dot" else (4, 4))
        return K.Model([a, b], getattr(A, name)(a, b))
    kw = {"sum": dict(axis=-1), "mean": dict(axis=1),
          "expand_dims": dict(axis=1)}.get(name, {})
    if name == "squeeze":
        return K.Model(a, getattr(A, name)(A.expand_dims(a, axis=1),
                                           axis=1))
    return K.Model(a, getattr(A, name)(a, **kw))


@pytest.mark.parametrize("name", UNARY + BINARY + ["clip", "stack",
                                                   "concatenate"])
def test_autograd_op_values_and_gradients(name):
    rs = np.random.RandomState(4)
    a = (rs.rand(2, 3, 4) + 0.5).astype(np.float32)
    b = (rs.rand(2, 3, 4) + 0.5).astype(np.float32)
    if name == "dot":
        b = rs.randn(2, 4, 4).astype(np.float32)
    if name == "clip":
        jm = (lambda i: JK.Model(i, JA.clip(i, 0.6, 1.2)))(JK.Input((3, 4)))
        tm = (lambda i: K.Model(i, A.clip(i, 0.6, 1.2)))(K.Input((3, 4)))
        xs = (a,)
    elif name in ("stack", "concatenate"):
        def mk(KK, AA):
            i, j = KK.Input((3, 4)), KK.Input((3, 4))
            return KK.Model([i, j], getattr(AA, name)(i, j, axis=1))
        jm, tm, xs = mk(JK, JA), mk(K, A), (a, b)
    else:
        jm, tm = _op_model(JK, JA, name), _op_model(K, A, name)
        xs = (a, b) if name in BINARY else (a,)
    jf = lambda *v: jnp.sum(jnp.sin(jm.apply({"params": {}, "state": {}},
                                             *v)[0]))
    want_y = jm.apply({"params": {}, "state": {}}, *xs)[0]
    want_g = jax.grad(jf, argnums=tuple(range(len(xs))))(*xs)
    ts = [torch.tensor(v, requires_grad=True) for v in xs]
    y = tm(*ts)
    torch.sin(y).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)
    for t, g in zip(ts, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                   rtol=1e-6, atol=1e-6)
    # the eager form on tensors
    eager = getattr(A, name)
    assert callable(eager)


def test_custom_loss_value_and_gradient():
    rs = np.random.RandomState(5)
    p = rs.randn(4, 3).astype(np.float32)
    t = rs.randn(4, 3).astype(np.float32)
    for jfn, pfn in ((JA.mean_absolute_error, A.mean_absolute_error),
                     (JA.mean_squared_error, A.mean_squared_error),
                     (lambda yt, yp: jnp.mean(jnp.exp(yp) - yt * yp),
                      lambda yt, yp: torch.mean(torch.exp(yp) - yt * yp))):
        jl, pl = JA.CustomLoss(jfn), A.CustomLoss(pfn)
        want, g = jax.value_and_grad(lambda v: jl(v, jnp.asarray(t)))(
            jnp.asarray(p))
        tp = torch.tensor(p, requires_grad=True)
        got = pl(tp, torch.from_numpy(t))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(g),
                                   rtol=1e-6, atol=1e-7)


def test_custom_loss_trains_through_fit(monkeypatch, tmp_path):
    x, y = synthetic(n=128)
    onehot = np.eye(4, dtype=np.float32)[y]
    jm = sequential(JK)
    init = _jax_vars(jm, x[:1])
    jm.compile("sgd", JA.CustomLoss(JA.mean_squared_error))
    want_l, want_e, _, _ = _jax_fit(
        monkeypatch, tmp_path, jm, init, (x, onehot),
        dict(batch_size=32, nb_epoch=1), x[:64], onehot[:64], x[:2])
    tm = _port(sequential(K), jm, init)
    tm.compile("sgd", A.CustomLoss(A.mean_squared_error))
    trained = tm.fit(x, onehot, batch_size=32, nb_epoch=1, device=CPU)
    _close(trained.losses, want_l)
    _close(
        [r.result for r in tm.evaluate(x[:64], onehot[:64])],
        [v for _, v in want_e])


def test_batchnorm_model_trains_within_the_resnet_bounds(monkeypatch,
                                                         tmp_path):
    """A conv + BatchNorm keras model through fit (C.14: BatchNorm's
    float32 reordering grows with steps)."""
    rs = np.random.RandomState(6)
    x = rs.randn(96, 6, 6, 3).astype(np.float32)
    y = rs.randint(0, 5, 96).astype(np.int32)

    def make(K, nn):
        return K.Sequential([
            nn.Conv2D(3, 8, 3, padding="SAME"), nn.BatchNorm(8), nn.ReLU(),
            nn.GlobalAvgPool2D(), nn.Linear(8, 5), nn.LogSoftMax()])

    jm = make(JK, jnn)
    init = _jax_vars(jm, x[:1])
    jm.compile("sgd", "nll", ["top1"])
    want_l, want_e, want_p, _ = _jax_fit(
        monkeypatch, tmp_path, jm, init, (x, y),
        dict(batch_size=32, nb_epoch=1), x[:32], y[:32], x[:4])
    tm = _port(make(K, nn), jm, init)
    tm.compile("sgd", "nll", ["top1"])
    got = tm.fit(x, y, batch_size=32, nb_epoch=1, device=CPU).losses
    assert len(got) == len(want_l) == 3
    _close(got[:1], want_l[:1])
    _close(got, want_l, 1e-4)
    _close(tm.predict(x[:4]), want_p, 1e-4)
    _close([r.result for r in tm.evaluate(x[:32], y[:32])],
           [v for _, v in want_e], 1e-4)


# ---------------------------------------------------------------------------
# Inception and VGG
# ---------------------------------------------------------------------------


def _perturbed(variables, seed):
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rs.randn(*np.shape(a))).astype(
            np.float32), variables)


@pytest.mark.parametrize("name", ["inception_module", "inception_v2_module",
                                  "inception_v2_reduction", "vgg_cifar10"])
def test_inception_and_vgg_forward_match_jax(name):
    make = {
        "inception_module": lambda M: M.inception_module(
            8, 4, 4, 6, 2, 4, 3),
        "inception_v2_module": lambda M: M.inception_v2_module(
            8, 4, 4, 6, 2, 4, 3, pool="max"),
        "inception_v2_reduction": lambda M: M.inception_v2_module(
            8, 0, 4, 6, 2, 4, 0, stride=2),
        "vgg_cifar10": lambda M: M.vgg_cifar10(10),
    }[name]
    size = 32 if name == "vgg_cifar10" else 9
    cin = 3 if name == "vgg_cifar10" else 8
    x = np.random.RandomState(7).randn(2, size, size, cin).astype(np.float32)
    jm = make(jmodels)
    v = _perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), x), 8)
    if v["state"]:
        v["state"] = jax.tree_util.tree_map(np.abs, v["state"])
    tm = load_jax_variables(make(models).eval(), v)
    want = np.asarray(jax.jit(lambda v_: jm.apply(v_, x)[0])(v))
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    _close(got, want)


def _shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name,size", [("inception_v1", 224),
                                       ("inception_v2", 224),
                                       ("vgg16", 224)])
def test_full_model_trees_equal_jax(name, size):
    """The params and state trees by name and shape, the JAX side from
    ``jax.eval_shape`` of its init (no full-width forward)."""
    jm = getattr(jmodels, name)()
    x = jax.ShapeDtypeStruct((1, size, size, 3), jnp.float32)
    want = jax.eval_shape(lambda a: jm.init(jax.random.PRNGKey(0), a), x)
    got = export_variables(getattr(models, name)())
    for kind in ("params", "state"):
        assert _shapes(got[kind]) == _shapes(want[kind]), kind


def test_array_dataset_reads_a_pair_as_jax_does():
    """``(data, labels)`` given without labels is the two, a tuple with
    labels a multi-input pack, as in the JAX package's ArrayDataSet."""
    from bigdl_tpu.data import ArrayDataSet as JArrayDataSet
    from bigdl_tpu_torch.data import ArrayDataSet

    x, y = synthetic(n=8)
    for data, labels in (((x, y), None), ((x, x + 1), y), (x, y)):
        got = next(iter(ArrayDataSet(data, labels).batches(
            4, shuffle=False)))
        want = next(iter(JArrayDataSet(data, labels).batches(
            4, shuffle=False)))
        assert isinstance(got["input"], tuple) == isinstance(
            want["input"], tuple)
        for g, w in zip(got["input"] if isinstance(got["input"], tuple)
                        else (got["input"],),
                        want["input"] if isinstance(want["input"], tuple)
                        else (want["input"],)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got["target"], want["target"])


def test_two_input_fit_and_checkpoints_match_jax(monkeypatch, tmp_path):
    """A two-input model fit from a list of two arrays (a multi-input
    pack through ArrayDataSet and the train step), with
    ``checkpoint_path``: losses and predictions as JAX's, a checkpoint a
    epoch, and a second fit on the same path resuming from it."""
    x, y = synthetic(n=128)
    x2 = np.random.RandomState(9).randn(128, 16).astype(np.float32)
    jm = two_inputs(JK, jnn)
    init = _jax_vars(jm, x[:1], x2[:1])
    jm.compile("adam", "sparse_categorical_crossentropy")
    want_l, _, want_p, _ = _jax_fit(
        monkeypatch, tmp_path, jm, init, ([x, x2], y),
        dict(batch_size=32, nb_epoch=2), [x, x2], y, [x[:4], x2[:4]])
    tm = _port(two_inputs(K, nn), jm, init)
    tm.compile("adam", "sparse_categorical_crossentropy")
    ckpt = str(tmp_path / "port_ckpt")
    got = tm.fit([x, x2], y, batch_size=32, nb_epoch=2, device=CPU,
                 checkpoint_path=ckpt).losses
    _close(got, want_l)
    _close(tm.predict([x[:4], x2[:4]]), want_p)
    from bigdl_tpu_torch.optim import checkpoint

    assert checkpoint.latest_checkpoint(ckpt).endswith("ckpt-8")
    more = tm.fit([x, x2], y, batch_size=32, nb_epoch=3, device=CPU,
                  checkpoint_path=ckpt).losses
    assert len(more) == 4                  # epoch 3 only, from ckpt-8
