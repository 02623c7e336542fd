"""The port's forecasting (``bigdl_tpu_torch.forecast``) against the JAX
package's ``bigdl_tpu.forecast``.

The host pipelines (``TSDataset``, ``XShardsTSDataset``, the detectors,
ARIMA and Prophet) give equal arrays.  Every forecast model, loaded with
the JAX init, gives the JAX forward and gradients within 1e-5 of the
largest |value| compared (at least 1: float32 sums in another order);
the five forecasters train 3 steps from the same weights on the same
batches (the JAX ``Optimizer`` patched to start from them and to log
every loss), TCN and LSTM with the JAX dropout masks, to losses within
1e-5 and trained weights and their predictions within 1e-4 (Adam's
normalized step enlarges a rounding of a gradient near 0); a forecaster
saved by either package loads in the other.  The Autoformer's inputs have no near ties between delays, so
the two FFTs pick the same ones."""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import bigdl_tpu.forecast.forecaster as jforecaster
from bigdl_tpu import forecast as JF
from bigdl_tpu.data.shards import XShards as JXShards
from bigdl_tpu.forecast import autoformer as jauto
from bigdl_tpu.forecast import models as jmodels
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu_torch import forecast as PF
from bigdl_tpu_torch.data.shards import XShards as PXShards
from bigdl_tpu_torch.forecast import autoformer as pauto
from bigdl_tpu_torch.forecast import models as pmodels
from bigdl_tpu_torch.utils import export_variables, load_jax_variables

CPU = "cpu"
TOL = 1e-5


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(
        got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _same_tree(got, want, tol=TOL, skip=lambda path: False):
    lg, lw = list(_leaves(got)), list(_leaves(want))
    assert [k for k, _ in lg] == [k for k, _ in lw]
    for (k, a), (_, b) in zip(lg, lw):
        if not skip(k):
            try:
                _close(a, b, tol)
            except AssertionError as e:
                raise AssertionError(f"{k}: {e}") from None


def _series(n=200, freq=24, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n)
    y = np.sin(2 * np.pi * t / freq) + 0.05 * rs.randn(n)
    return pd.DataFrame({
        "dt": pd.date_range("2025-01-01", periods=n, freq="h"),
        "value": y.astype(np.float32),
        "extra": (np.cos(2 * np.pi * t / 7) + 0.1 * rs.randn(n)).astype(
            np.float32)})


def _windows(n=96, lookback=24, horizon=4, dim=1, seed=0):
    """Seeded hourly series: daily and weekly periods plus noise."""
    rs = np.random.RandomState(seed)
    t = np.arange(n + lookback + horizon)[:, None]
    phase = rs.rand(1, dim) * 6.28
    s = (np.sin(2 * np.pi * t / 24 + phase)
         + 0.5 * np.sin(2 * np.pi * t / 168 + phase)
         + 0.1 * rs.randn(len(t), dim)).astype(np.float32)
    idx = np.arange(n)[:, None]
    x = s[idx + np.arange(lookback)]
    y = s[idx + lookback + np.arange(horizon)]
    return x, y


# ---- host pipelines --------------------------------------------------------


def _pipeline(F, df):
    return (F.TSDataset.from_pandas(df, dt_col="dt", target_col="value",
                                    extra_feature_col="extra")
            .deduplicate().impute("linear").gen_dt_feature().scale()
            .roll(12, 3))


def test_tsdataset_pipeline_equals_jax():
    df = _series()
    df.loc[10, "value"] = np.nan
    df = pd.concat([df, df.iloc[[20]]])          # a duplicate row
    j, p = _pipeline(JF, df), _pipeline(PF, df)
    for a, b in zip(p.to_numpy(), j.to_numpy()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(p.train_val_test_split(0.1, 0.2),
                    j.train_val_test_split(0.1, 0.2)):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    y = p.to_numpy()[1]
    np.testing.assert_array_equal(p.unscale_numpy(y), j.unscale_numpy(y))
    # resampling per id, the other impute modes, MinMaxScaler, shuffle
    df = _series(96)
    df["id"] = np.where(np.arange(96) < 48, "a", "b")
    out = []
    for F in (PF, JF):
        ts = (F.TSDataset.from_pandas(df, dt_col="dt", target_col="value",
                                      id_col="id").resample("2h")
              .impute("const").impute("last")
              .scale(F.tsdataset.MinMaxScaler()).roll(6, 2, shuffle=True,
                                                      seed=3))
        out.append((ts.to_numpy(), len(ts.df)))
    assert out[0][1] == out[1][1] == 48
    for a, b in zip(out[0][0], out[1][0]):
        np.testing.assert_array_equal(a, b)


def test_xshards_tsdataset_equals_jax():
    frames = []
    for i, n in enumerate((120, 90, 10)):      # the last shard is too short
        df = _series(n, seed=i)
        df["id"] = f"s{i}"
        frames.append(df)
    got = []
    for F, XS in ((PF, PXShards), (JF, JXShards)):
        ds = (F.XShardsTSDataset.from_xshards(
            XS(frames), dt_col="dt", target_col="value", id_col="id",
            extra_feature_col="extra").impute().scale().roll(24, 4))
        got.append((ds.to_numpy(), ds.num_partitions(),
                    [np.asarray(s[0]) for s in ds.to_xshards().collect()],
                    ds.scaler.mean_))
    (pa, pn, ps, pm), (ja, jn, js, jm) = got
    assert pn == jn == 3 and len(ps) == len(js) == 2
    np.testing.assert_array_equal(pm, jm)
    for a, b in zip(pa + tuple(ps), ja + tuple(js)):
        np.testing.assert_array_equal(a, b)


def test_detectors_and_classic_equal_jax():
    rs = np.random.RandomState(1)
    y = np.sin(np.arange(300) / 8.0) + 0.05 * rs.randn(300)
    y[[40, 170, 260]] += 3.0
    y_hat = y + 0.05 * rs.randn(300)
    for a, b in (
            (PF.ThresholdDetector(ratio=0.02).fit(y, y_hat)
             .anomaly_indexes(y, y_hat),
             JF.ThresholdDetector(ratio=0.02).fit(y, y_hat)
             .anomaly_indexes(y, y_hat)),
            (PF.ThresholdDetector(threshold=(-1.5, 1.5)).anomaly_indexes(y),
             JF.ThresholdDetector(threshold=(-1.5, 1.5)).anomaly_indexes(y)),
            (PF.DBScanDetector(eps=0.3, min_samples=4).anomaly_indexes(y),
             JF.DBScanDetector(eps=0.3, min_samples=4).anomaly_indexes(y))):
        np.testing.assert_array_equal(a, b)
        assert len(a) > 0
    for cls, kw, fit_y in ((PF.ARIMAForecaster, dict(p=2, d=1, q=1), y),
                           (PF.ProphetForecaster, {}, y)):
        jcls = getattr(JF, cls.__name__)
        pf, jf = cls(**kw).fit(fit_y), jcls(**kw).fit(fit_y)
        np.testing.assert_array_equal(pf.predict(12), jf.predict(12))
        assert pf.evaluate(y[:12], ("mse", "mae", "smape")) == \
            jf.evaluate(y[:12], ("mse", "mae", "smape"))


def test_ae_detector_equals_jax(monkeypatch):
    """The autoencoder trains from the port's seeded weights on both
    sides (the JAX Optimizer patched to start from them)."""
    rs = np.random.RandomState(2)
    y = np.sin(np.arange(200) / 6.0) + 0.05 * rs.randn(200)
    y[[50, 120]] += 2.5
    kw = dict(roll_len=12, ratio=0.02, hidden=8, epochs=3, batch_size=32)
    port = PF.AEDetector(**kw, device=CPU).fit(y)
    g = torch.Generator().manual_seed(0)
    from bigdl_tpu_torch import nn as pnn

    init = export_variables(pnn.Sequential([
        pnn.Linear(12, 8, generator=g), pnn.Tanh(),
        pnn.Linear(8, 12, generator=g)]))
    import bigdl_tpu.optim.optimizer as jopt

    class Opt(jopt.Optimizer):
        def optimize(self):
            self.set_initial_variables(init)
            return super().optimize()

    monkeypatch.setattr(jopt, "Optimizer", Opt)
    Engine.reset()
    init_engine(data=1)
    try:
        jdet = JF.AEDetector(**kw).fit(y)
        want_s, want_i = jdet.score(y), jdet.anomaly_indexes(y)
    finally:
        Engine.reset()
    _close(port.score(y), want_s, 1e-4)
    np.testing.assert_array_equal(port.anomaly_indexes(y), want_i)


# ---- models: forward and gradients ----------------------------------------

MODELS = {
    "tcn": (lambda M: M.TCN(2, 2, 4, channels=(8, 6), kernel_size=3,
                            dropout=0.1), 2),
    "lstm": (lambda M: M.LSTMForecastNet(2, 2, 4, hidden=8, layers=2), 2),
    "seq2seq": (lambda M: M.Seq2SeqNet(2, 2, 4, hidden=8), 2),
    "nbeats": (lambda M: M.NBeats(2, 2, 24, 4, stacks=1,
                                  blocks_per_stack=2, units=16), 2),
    "autoformer": (lambda M: M.Autoformer(
        3, 3, 24, 8, hidden=16, heads=2, enc_layers=1, dec_layers=1,
        ff=32, kernel=5), 3),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_forward_and_gradients_match_jax(name):
    """The JAX side under ``jax.jit`` (eager it takes twice as long)."""
    make, dim = MODELS[name]
    horizon = 8 if name == "autoformer" else 4
    x, _ = _windows(4, 24, horizon, dim, seed=3)
    jm = make(jauto if name == "autoformer" else jmodels)
    pm = make(pauto if name == "autoformer" else pmodels)
    init = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(0), x))
    load_jax_variables(pm, init)
    w = np.random.RandomState(4).randn(4, horizon, dim).astype(np.float32)

    def jloss(params):
        y, _ = jm.forward(params, init["state"], x)
        return (y * w).sum(), y

    (_, jy), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        init["params"])
    pm.train(False)
    py = pm(torch.from_numpy(x))
    (py * torch.from_numpy(w)).sum().backward()
    _close(py.detach().numpy(), jy)
    # a parameter the output does not read (N-Beats' last backcast) has
    # no gradient here and a zero one in JAX
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             .numpy() for n, p in pm.named_parameters()}
    from bigdl_tpu_torch.utils.convert import nest

    _same_tree(nest(grads.items()), _np_tree(jg))


def test_auto_correlation_ties_go_to_the_lower_delay():
    corr = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0]])
    vals, idx = pauto.top_delays(corr, 2)
    jv, ji = jax.lax.top_k(np.asarray(corr), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


# ---- forecasters: trajectories, save / load -------------------------------

FORECASTERS = {
    "TCNForecaster": dict(num_channels=(8, 8), dropout=0.1),
    "LSTMForecaster": dict(hidden_dim=8, layer_num=2, dropout=0.1),
    "Seq2SeqForecaster": dict(lstm_hidden_dim=8),
    "NBeatsForecaster": dict(stacks=1, blocks_per_stack=2, hidden_units=16),
    "AutoformerForecaster": dict(d_model=16, n_heads=2, e_layers=1,
                                 d_layers=1, d_ff=32, moving_avg=5),
}
LOOKBACK, HORIZON, BATCH = 24, 4, 16


def _zero_grad_bias(path) -> bool:
    """The Autoformer's biases whose gradient is exactly 0."""
    if path[-1] != "bias" or len(path) < 3:
        return False
    return (path[-2] in ("wq", "wk") or path[1] == "in_proj"
            or (path[1].startswith("enc_") and path[-2] != "ff1"))

# three variables: with one, every q and k of the Autoformer's first layer
# is an affine map of one series, and R(tau) and R(L - tau) tie to the
# last bit, so the two FFTs may order the delays differently
DIM = 3


def _jax_forecaster_fit(monkeypatch, tmp_path, jf, init, x, y, steps):
    """``jf.fit`` from ``init``, ``steps`` steps: its losses."""
    made = []

    class Opt(jforecaster.Optimizer):
        def optimize(self):
            self.set_initial_variables(init)
            self.set_end_when(jforecaster.Trigger.max_iteration(steps))
            self.set_train_summary(str(tmp_path / f"jax{len(made)}"))
            made.append(self)
            return super().optimize()

    monkeypatch.setattr(jforecaster, "Optimizer", Opt)
    jf.fit((x, y), epochs=1, batch_size=BATCH)
    return [v for _, v in made[0]._train_summary.read_scalar("loss")]


@pytest.mark.parametrize("cls", sorted(FORECASTERS))
def test_forecaster_trajectory_matches_jax(monkeypatch, tmp_path, cls):
    """3 steps of Adam from the JAX init: losses, the trained weights,
    predict and evaluate within 1e-5."""
    kw = FORECASTERS[cls]
    x, y = _windows(3 * BATCH, LOOKBACK, HORIZON, DIM, seed=5)
    args = (LOOKBACK, HORIZON, DIM, DIM)
    jf = getattr(JF, cls)(*args, lr=1e-2, **kw)
    init = _np_tree(jax.jit(jf.model.init)(jax.random.PRNGKey(0), x[:1]))
    Engine.reset()
    init_engine(data=1)
    try:
        want = _jax_forecaster_fit(monkeypatch, tmp_path, jf, init, x, y, 3)
        want_p = jf.predict(x[:8])
        want_e = jf.evaluate((x, y), ("mse", "mae"))
        want_v = _np_tree(jf._trained.variables)
    finally:
        Engine.reset()
    pf = getattr(PF, cls)(*args, lr=1e-2, device=CPU, **kw)
    assert pf._init_args["lr"] == 1e-2 and pf._init_args["device"] == CPU
    load_jax_variables(pf.model, init)
    pf.fit((x, y), epochs=1, batch_size=BATCH)
    assert len(pf._trained.losses) == len(want) == 3
    _close(pf._trained.losses, want)
    # the weights: Adam's step lr * m / sqrt(v) turns a gradient near 0
    # and a rounding apart into a larger step, so 1e-4.  The Autoformer's
    # biases with an exact gradient of 0 are left out (ROADMAP C.4: both
    # packages step on rounding noise there; the outputs above are
    # compared): a constant added to q or k moves every delay's cyclic
    # correlation alike, which the softmax over delays ignores, and the
    # encoder's series decompositions remove any constant over time, so
    # no bias of the encoder but its FFN's first reaches the loss
    _same_tree(pf._trained.variables, want_v, 1e-4, skip=_zero_grad_bias)
    # after the run, outputs of those weights: the weights' bound
    _close(pf.predict(x[:8]), want_p, 1e-4)
    got_e = pf.evaluate((x, y), ("mse", "mae"))
    assert list(got_e) == list(want_e)
    _close(list(got_e.values()), list(want_e.values()), 1e-4)


@pytest.mark.parametrize("cls", ["TCNForecaster", "NBeatsForecaster"])
def test_forecaster_save_load_across_packages(monkeypatch, tmp_path, cls):
    kw = FORECASTERS[cls]
    x, y = _windows(2 * BATCH, LOOKBACK, HORIZON, DIM, seed=6)
    args = (LOOKBACK, HORIZON, DIM, DIM)
    pf = getattr(PF, cls)(*args, device=CPU, **kw)
    pf.fit((x, y), epochs=1, batch_size=BATCH)
    pf.save(str(tmp_path / "port"))
    Engine.reset()
    init_engine(data=1)
    try:
        jf = getattr(JF, cls)(*args, **kw)
        jf.load(str(tmp_path / "port"))
        _close(jf.predict(x[:4]), pf.predict(x[:4]))
        jf.save(str(tmp_path / "jax"))
    finally:
        Engine.reset()
    back = getattr(PF, cls)(*args, device=CPU, **kw)
    back.load(str(tmp_path / "jax"))
    np.testing.assert_array_equal(back.predict(x[:4]), pf.predict(x[:4]))


def test_refusals():
    x, y = _windows(BATCH, LOOKBACK, HORIZON, 1)
    f = PF.TCNForecaster(LOOKBACK, HORIZON, 1, 1, device=CPU)
    # parallelism= is ported (test_torch_port_layout_train); as in the
    # JAX package it refuses validation_data
    with pytest.raises(ValueError, match="validation_data"):
        f.fit((x, y), parallelism="dp", validation_data=(x, y))
    with pytest.raises(RuntimeError, match="fit"):
        f.predict(x)
    f.fit((x, y), epochs=1, batch_size=BATCH)
    for call in (lambda: f.optimize_predict("bf16"),
                 lambda: f.predict_with_optimized(x),
                 lambda: PF.AutoTSEstimator(model="tcn"),
                 lambda: PF.TSPipeline(f, LOOKBACK, HORIZON)):
        with pytest.raises(ValueError, match="A.6.10"):
            call()
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            PF.TCNForecaster(LOOKBACK, HORIZON, 1, 1)
        else:
            raise RuntimeError("CUDA is present")
