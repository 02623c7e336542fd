"""The port's Estimator (``bigdl_tpu_torch.estimator``) against the JAX
package's (``bigdl_tpu.estimator``).

Both packages train the same model from the same weights on the same
numpy data (the JAX ``Optimizer`` patched to log every loss and, where
the JAX Estimator would draw its own init, to start from the port's
weights): ``from_torch`` (a CNN with BatchNorm, TinyBert, and an encoder
with dropout 0.1 drawing the JAX masks), ``from_module`` and
``from_keras``.  Losses, evaluation and predictions agree within 1e-5 of
the largest |value| (at least 1); the BatchNorm model takes ROADMAP
C.14's bounds (the first loss 1e-5, the later ones 1e-4).  A model
saved by either package loads in the other, and ``state_dict`` round
trips through a fresh stock module."""

import numpy as np
import pytest
import torch

import bigdl_tpu.estimator.estimator as jest_mod
import bigdl_tpu.keras.engine as jengine
import bigdl_tpu_torch.keras.engine as pengine
from bigdl_tpu import keras as JK
from bigdl_tpu import nn as jnn
from bigdl_tpu.estimator import Estimator as JEstimator
from bigdl_tpu.optim import optim_method as jom
from bigdl_tpu.optim.validation import Loss as JLoss
from bigdl_tpu.optim.validation import Top1Accuracy as JTop1
from bigdl_tpu.runtime.engine import Engine as JEngine
from bigdl_tpu.runtime.engine import init_engine as jinit_engine
from bigdl_tpu_torch import estimator as E
from bigdl_tpu_torch import keras as K
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.data.shards import XShards
from bigdl_tpu_torch.optim import optim_method as om
from bigdl_tpu_torch.optim.validation import Loss, Top1Accuracy
from bigdl_tpu_torch.runtime.engine import Engine
from bigdl_tpu_torch.utils import (export_variables, load_jax_keras_variables,
                                   load_jax_variables)
from bigdl_tpu_torch.utils.torch_convert import from_torch_module
from test_from_torch import SmallCNN, TinyBert

CPU = "cpu"
TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture
def jax_engine():
    JEngine.reset()
    jinit_engine(data=1)
    yield
    JEngine.reset()


def _patch_jax_optimizer(monkeypatch, tmp_path, init=None):
    """The JAX Estimator's Optimizer logging every loss (and starting
    from ``init``); returns the list of Optimizers it made."""
    made = []

    class Opt(jest_mod.Optimizer):
        def optimize(self):
            if init is not None:
                self.set_initial_variables(init)
            self.set_train_summary(str(tmp_path / f"jax{len(made)}"))
            made.append(self)
            return super().optimize()

    monkeypatch.setattr(jest_mod, "Optimizer", Opt)
    return made


def _jax_losses(made):
    return [v for _, v in made[-1]._train_summary.read_scalar("loss")]


class EncoderClf(torch.nn.Module):
    """Embedding, a post-norm encoder layer with dropout 0.1, the first
    token's state and a two-label head."""

    def __init__(self, vocab=32, d=16):
        super().__init__()
        self.emb = torch.nn.Embedding(vocab, d)
        self.enc = torch.nn.TransformerEncoder(
            torch.nn.TransformerEncoderLayer(d, 2, 32, dropout=0.1,
                                             activation="gelu",
                                             batch_first=True), 1)
        self.head = torch.nn.Linear(d, 2)

    def forward(self, ids):
        return self.head(torch.tanh(self.enc(self.emb(ids))[:, 0]))


def _cnn():
    """``SmallCNN`` without the bias of the conv before its BatchNorm: that
    bias has an exact gradient of 0, on which Adam steps on rounding
    noise in both packages, and the running mean carries the drift into
    eval mode (ROADMAP C.4)."""
    m = SmallCNN(4)
    m.conv1.bias = None
    return m


def _cnn_data(n=96):
    rs = np.random.RandomState(0)
    x = rs.rand(n, 3, 8, 8).astype(np.float32)
    y = (x.mean(axis=(1, 2, 3)) * 8).astype(np.int32) % 4
    return x, x.transpose(0, 2, 3, 1).copy(), y


def _ids_data(n=96, vocab=32):
    rs = np.random.RandomState(1)
    ids = rs.randint(0, vocab, (n, 7)).astype(np.int64)
    return ids, ids.astype(np.int32), (ids.sum(1) % 2).astype(np.int32)


TORCH_CASES = {
    "cnn": (_cnn, _cnn_data,
            lambda m, c: torch.optim.Adam(m.parameters(), lr=5e-3)),
    "tiny_bert": (lambda: TinyBert(32), _ids_data,
                  lambda m, c: torch.optim.AdamW(m.parameters(), lr=1e-3)),
    "encoder_dropout": (lambda: EncoderClf(), _ids_data,
                        lambda m, c: torch.optim.SGD(m.parameters(), lr=0.1,
                                                     momentum=0.9)),
}


@pytest.mark.parametrize("case", sorted(TORCH_CASES))
def test_from_torch_fit_matches_jax(monkeypatch, tmp_path, jax_engine, case):
    """Two epochs at batch 32 from the converted torch weights: losses,
    Top-1, predictions, the exported state dict."""
    make, data, opt_creator = TORCH_CASES[case]
    torch_x, x, y = data()
    torch.manual_seed(0)
    tm = make()
    made = _patch_jax_optimizer(monkeypatch, tmp_path)
    je = JEstimator.from_torch(
        lambda c: tm, opt_creator, lambda c: torch.nn.CrossEntropyLoss(),
        example_input=torch_x[:1])
    je.fit((x, y), epochs=2, batch_size=32)
    want = _jax_losses(made)
    want_e = je.evaluate((x, y), [JTop1(), JLoss(jnn.CrossEntropyCriterion())])
    want_p = np.asarray(je.predict(x[:8]))
    want_sd = je.state_dict()
    pe = E.Estimator.from_torch(
        lambda c: tm, opt_creator, lambda c: torch.nn.CrossEntropyLoss(),
        example_input=torch_x[:1], device=CPU)
    assert pe._torch_model is tm and pe.device.type == CPU
    stats = pe.fit((x, y), epochs=2, batch_size=32)
    got = pe._trained.losses
    assert stats["num_samples"] == len(x) and stats["epochs"] == 2
    assert len(got) == len(want) == 6
    bn = case == "cnn"        # BatchNorm trains: ROADMAP C.14's bounds
    _close(got[0], want[0])
    _close(got[1:], want[1:], 1e-4 if bn else TOL)
    got_e = pe.evaluate((x, y), [Top1Accuracy(),
                                 Loss(nn.CrossEntropyCriterion())])
    assert list(got_e) == list(want_e)
    _close(got_e["Loss"], want_e["Loss"], 1e-4 if bn else TOL)
    if not bn:   # under C.14's drift an argmax near a tie may flip
        assert got_e["Top1Accuracy"] == want_e["Top1Accuracy"]
    _close(pe.predict(x[:8]), want_p, 1e-4 if bn else TOL)
    sd = pe.state_dict()
    assert list(sd) == list(want_sd)
    for k in sd:
        assert not sd[k].is_cuda
        _close(sd[k].numpy(), want_sd[k].numpy(), 1e-4 if bn else TOL)
    make().load_state_dict(sd, strict=True)


def test_state_dict_round_trip_predicts_to_the_bit():
    """The exported weights load into a fresh stock module; converted
    again, that module predicts what the Estimator predicts, to the
    bit."""
    torch_x, x, y = _ids_data(64)
    pe = E.Estimator.from_torch(
        lambda c: TinyBert(32),
        lambda m, c: torch.optim.Adam(m.parameters(), lr=1e-3),
        lambda c: torch.nn.CrossEntropyLoss(), example_input=torch_x[:1],
        device=CPU)
    before = pe.predict(x[:8])           # the loaded-weights path
    pe.fit((x, y), epochs=1, batch_size=32)
    fresh = TinyBert(32)
    fresh.load_state_dict(pe.state_dict(), strict=True)
    again = E.Estimator.from_torch(
        lambda c: fresh, lambda c: om.SGD(learning_rate=0.1),
        lambda c: nn.CrossEntropyCriterion(), example_input=torch_x[:1],
        device=CPU)
    after = pe.predict(x[:8])
    assert np.array_equal(again.predict(x[:8]), after)
    assert not np.array_equal(before, after)


def _mlp(N):
    return N.Sequential([N.Linear(6, 16), N.ReLU(), N.Linear(16, 3)])


def _mlp_data(n=96, seed=2):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    return x, (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0.5)


def test_from_module_fit_matches_jax(monkeypatch, tmp_path, jax_engine):
    """``from_module`` with validation: losses, the validation results,
    evaluate and predict."""
    x, y = _mlp_data()
    pm = _mlp(nn)
    init = export_variables(pm)
    made = _patch_jax_optimizer(monkeypatch, tmp_path, init)
    je = JEstimator.from_module(lambda c: _mlp(jnn),
                                lambda c: jom.Adam(learning_rate=1e-2),
                                lambda c: jnn.CrossEntropyCriterion())
    je.fit((x, y), epochs=2, batch_size=32, validation_data=(x[:32], y[:32]),
           validation_methods=[JTop1()])
    want = _jax_losses(made)
    pe = E.Estimator.from_module(lambda c: pm,
                                 lambda c: om.Adam(learning_rate=1e-2),
                                 lambda c: nn.CrossEntropyCriterion(),
                                 device=CPU)
    pe.fit((x, y), epochs=2, batch_size=32, validation_data=(x[:32], y[:32]),
           validation_methods=[Top1Accuracy()])
    _close(pe._trained.losses, want)
    assert len(want) == 6
    assert pe.evaluate((x, y), [Top1Accuracy()]) == \
        je.evaluate((x, y), [JTop1()])
    _close(pe.predict(x[:8]), je.predict(x[:8]))


def _keras(K, nn):
    inp = K.Input(shape=(6,))
    h = K.Dense(6, 16)(inp)
    out = K.Dense(16, 3)(nn.ReLU()(h))
    return K.Model(inp, out)


def test_from_keras_fit_matches_jax(monkeypatch, tmp_path, jax_engine):
    import jax

    x, y = _mlp_data(seed=3)
    jm = _keras(JK, jnn)
    init = jax.tree_util.tree_map(np.asarray,
                                  jm.init(jax.random.PRNGKey(0), x[:1]))
    jm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    made = _patch_jax_optimizer(monkeypatch, tmp_path, init)
    je = JEstimator.from_keras(lambda c: jm)
    je.fit((x, y), epochs=2, batch_size=32)
    pm = load_jax_keras_variables(_keras(K, nn), jm, init)
    pm.compile(optimizer="adam", loss="sparse_categorical_crossentropy")
    pe = E.Estimator.from_keras(lambda c: pm, device=CPU)
    pe.fit((x, y), epochs=2, batch_size=32)
    _close(pe._trained.losses, _jax_losses(made))
    _close(pe.predict(x[:8]), je.predict(x[:8]))
    with pytest.raises(ValueError, match="compiled"):
        E.Estimator.from_keras(lambda c: _keras(K, nn), device=CPU)


def test_xshards_input_and_the_loaded_weights_path(tmp_path):
    """XShards of (x, y) pairs feed fit like the arrays; after ``load``,
    evaluate and predict (a two-input model, the tuple pack) run on the
    loaded weights without a fit, equal to the trained model's."""
    x, y = _mlp_data()
    a = E.Estimator.from_module(lambda c: _mlp(nn),
                                lambda c: om.SGD(learning_rate=0.1),
                                lambda c: nn.CrossEntropyCriterion(),
                                device=CPU)
    b = E.Estimator.from_module(lambda c: _mlp(nn),
                                lambda c: om.SGD(learning_rate=0.1),
                                lambda c: nn.CrossEntropyCriterion(),
                                device=CPU)
    load_jax_variables(b.model, export_variables(a.model))
    a.fit((x, y), epochs=1, batch_size=32)
    b.fit(XShards.partition((x, y), num_shards=3), epochs=1, batch_size=32)
    np.testing.assert_array_equal(a.predict(x), b.predict(x))
    got = b.predict(XShards.partition(x, num_shards=2)).collect()
    np.testing.assert_array_equal(np.concatenate(got), a.predict(x))

    u, v = K.Input(shape=(4,)), K.Input(shape=(6,))
    out = K.Dense(16, 2)(K.Merge("concat")([K.Dense(4, 8)(u),
                                             K.Dense(6, 8)(v)]))
    two = K.Model([u, v], out)
    two.compile(optimizer="sgd", loss="sparse_categorical_crossentropy")
    rs = np.random.RandomState(4)
    xu, xv = rs.randn(64, 4).astype(np.float32), rs.randn(64, 6).astype(
        np.float32)
    yy = (xu[:, 0] > 0).astype(np.int32)
    est = E.Estimator.from_keras(lambda c: two, device=CPU)
    est.fit(((xu, xv), yy), epochs=1, batch_size=32)
    want_p, want_e = est.predict((xu, xv)), est.evaluate(
        ((xu, xv), yy), [Top1Accuracy()])
    est.save(str(tmp_path / "two"))
    fresh = E.Estimator.from_keras(lambda c: two, device=CPU)
    with pytest.raises(RuntimeError, match="fit"):
        fresh.predict((xu, xv))
    fresh.load(str(tmp_path / "two"))
    np.testing.assert_array_equal(fresh.predict((xu, xv)), want_p)
    np.testing.assert_array_equal(fresh.predict([xu, xv]), want_p)
    assert fresh.evaluate(((xu, xv), yy), [Top1Accuracy()]) == want_e
    assert fresh.get_model() is fresh._loaded_variables


def test_save_load_across_packages(tmp_path, jax_engine):
    """A from_module model and a from_torch model (the node counters
    equal, so the node names agree) saved by either package load in the
    other: predictions within 1e-5 one way and equal after the round
    trip."""
    x, y = _mlp_data()
    pe = E.Estimator.from_module(lambda c: _mlp(nn),
                                 lambda c: om.SGD(learning_rate=0.1),
                                 lambda c: nn.CrossEntropyCriterion(),
                                 device=CPU)
    pe.fit((x, y), epochs=1, batch_size=32)
    pe.save(str(tmp_path / "port"))
    je = JEstimator.from_module(lambda c: _mlp(jnn),
                                lambda c: jom.SGD(learning_rate=0.1),
                                lambda c: jnn.CrossEntropyCriterion())
    je.load(str(tmp_path / "port"))
    _close(np.asarray(je.predict(x[:8])), pe.predict(x[:8]))
    je.save(str(tmp_path / "jax"))
    back = E.Estimator.from_module(lambda c: _mlp(nn),
                                   lambda c: om.SGD(learning_rate=0.1),
                                   lambda c: nn.CrossEntropyCriterion(),
                                   device=CPU)
    back.load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(back.predict(x[:8]), pe.predict(x[:8]))

    torch_x, ids, labels = _ids_data(64)
    tm = TinyBert(32)
    start = max(jengine._node_counter[0], pengine._node_counter[0]) + 1000
    pengine._node_counter[0] = start
    pt = E.Estimator.from_torch(
        lambda c: tm, lambda m, c: torch.optim.Adam(m.parameters()),
        lambda c: torch.nn.CrossEntropyLoss(), example_input=torch_x[:1],
        device=CPU)
    pt.fit((ids, labels), epochs=1, batch_size=32)
    pt.save(str(tmp_path / "port_torch"))
    jengine._node_counter[0] = start
    jt = JEstimator.from_torch(
        lambda c: tm, lambda m, c: torch.optim.Adam(m.parameters()),
        lambda c: torch.nn.CrossEntropyLoss(), example_input=torch_x[:1])
    jt.load(str(tmp_path / "port_torch"))
    _close(np.asarray(jt.predict(ids[:8])), pt.predict(ids[:8]))


def test_serializer_matches_jax_format(tmp_path):
    """The same manifest, key paths, order and arrays as the JAX
    serializer; a template keeps its structure and dtypes."""
    import jax.numpy as jnp

    from bigdl_tpu.utils import serializer as JS
    from bigdl_tpu_torch.utils import serializer as PS

    tree = {"params": {"b": {"w": np.arange(6, dtype=np.float32)
                             .reshape(2, 3)},
                       "a": np.ones(3, np.float32),
                       "c": [np.zeros(2, np.float32),
                             np.full(1, 7, np.float32)]},
            "state": {"bn": {"running_mean": np.ones(3, np.float32)}}}
    PS.save_model(str(tmp_path / "p"), None, tree)
    JS.save_model(str(tmp_path / "j"), None, tree)
    assert (tmp_path / "p" / "manifest.json").read_bytes() == (
        tmp_path / "j" / "manifest.json").read_bytes()
    zp, zj = (np.load(tmp_path / n / "weights.npz") for n in ("p", "j"))
    assert zp.files == zj.files
    for k in zp.files:
        assert zp[k].tobytes() == zj[k].tobytes()
    t = {"params": {"b": {"w": torch.zeros(2, 3, dtype=torch.float64)},
                    "a": np.zeros(3, np.float32),
                    "c": [np.zeros(2, np.float32), np.zeros(1, np.float32)]},
         "state": {"bn": {"running_mean": np.zeros(3, np.float32)}}}
    got = PS.load_model(str(tmp_path / "j"), template=t)
    assert got["params"]["b"]["w"].dtype == np.float64
    np.testing.assert_array_equal(got["params"]["c"][1], [7.0])
    want = JS.load_model(str(tmp_path / "p"))
    loose = PS.load_model(str(tmp_path / "p"))
    assert sorted(loose) == sorted(want)
    np.testing.assert_array_equal(loose["state"]["bn"]["running_mean"],
                                  np.asarray(jnp.ones(3)))
    with pytest.raises(FileExistsError):
        PS.save_model(str(tmp_path / "p"), None, tree, overwrite=False)
    t["params"]["a"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        PS.load_model(str(tmp_path / "p"), template=t)


class FakeTfKeras:
    pass


FakeTfKeras.__module__ = "keras.src.models.sequential"


def test_refusals(monkeypatch):
    x, y = _mlp_data(32)

    def est(config=None):
        return E.Estimator.from_module(lambda c: _mlp(nn),
                                       lambda c: om.SGD(learning_rate=0.1),
                                       lambda c: nn.CrossEntropyCriterion(),
                                       config=config, device=CPU)

    # the declarative layouts are ported (test_torch_port_layout_train):
    # the layout path keeps the JAX package's refusals, from the config
    # key and from BIGDL_TPU_PARALLELISM through the engine
    with pytest.raises(ValueError, match="fault_tolerance"):
        est({"parallelism": "dp"}).fit((x, y), fault_tolerance=True)
    monkeypatch.setenv("BIGDL_TPU_PARALLELISM", "fsdp:2")
    Engine.reset()
    with pytest.raises(ValueError, match="profile_dir"):
        est().fit((x, y), profile_dir="unused")
    monkeypatch.delenv("BIGDL_TPU_PARALLELISM")
    Engine.reset()
    with pytest.raises(ValueError, match="A.6.9"):
        est().fit((x, y), fault_tolerance=True)
    # slo_specs runs an evaluator over the fit (a bad spec costs only
    # the evaluation, as in the JAX Estimator)
    for specs in ('[{"tenant": "t", "objectives": {"availability": 0.9}}]',
                  ["p99<1s"]):
        assert est({"slo_specs": specs}).fit((x, y))["epochs"] == 1
    with pytest.raises(ValueError, match="A.6.11"):
        E.Estimator.from_keras(lambda c: FakeTfKeras(), device=CPU)
    with pytest.raises(ValueError, match="A.6.11"):
        est().export_to_keras()
    with pytest.raises(ValueError, match="backend"):
        E.Estimator.from_module(lambda c: None, lambda c: None,
                                lambda c: None, backend="spark", device=CPU)
    with pytest.raises(RuntimeError, match="fit"):
        est().predict(x)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            E.Estimator.from_module(lambda c: _mlp(nn), lambda c: None,
                                    lambda c: None)


def test_init_context_and_config_knobs():
    """``init_context("local")`` sets the port's engine (the aliases are
    the same functions); the config's knobs reach the Optimizer:
    ``steps_per_call`` 2 trains the same bits as 1, with the input
    inline (``host_prefetch`` 0, ``streaming`` off)."""
    assert E.init_orca_context is E.init_context is E.init_nncontext
    assert E.stop_orca_context is E.stop_context
    eng = E.init_context("local", device=CPU)
    assert Engine.get() is eng and eng.node_number == 1
    with pytest.raises(ValueError, match="coordinator_address"):
        E.init_context("multihost")
    with pytest.raises(ValueError, match="cluster_mode"):
        E.init_context("yarn")
    x, y = _mlp_data()
    runs = []
    for cfg in ({}, {"steps_per_call": 2, "host_prefetch": 0,
                     "streaming": False, "grad_comm": "fp32"}):
        m = _mlp(nn)
        if runs:
            load_jax_variables(m, runs[0][1])
        init = export_variables(m)
        est = E.Estimator.from_module(
            lambda c: m, lambda c: om.Adam(learning_rate=1e-2),
            lambda c: nn.CrossEntropyCriterion(), config=cfg, device=CPU)
        stats = est.fit((x, y), epochs=1, batch_size=32)
        assert set(stats) >= {"train_time_s", "epochs", "num_samples"}
        runs.append((est._trained.losses, init))
    assert runs[0][0] == runs[1][0] and len(runs[0][0]) == 3
    E.stop_context()
    assert Engine._instance is None
