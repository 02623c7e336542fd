"""The port's learning-rate schedules, optim methods, criteria,
validation methods and the layers' training-mode gradients against the
JAX package, on the same numpy inputs.

Tolerances: schedules to 1e-7 relative (the JAX schedule runs its jnp
arithmetic in float64 here, under ``jax.enable_x64``; in the jitted step
it runs in float32 and the two then differ by float32 rounding), one
update of each optim method to 1e-6 (float32 in both, the port takes
the learning rate as a double), criteria values and gradients to 1e-6
relative, validation results to 1e-6, layer gradients to 1e-5 of the
largest |gradient| (float32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn import criterion as jcrit
from bigdl_tpu.optim import optim_method as joptim
from bigdl_tpu.optim import schedules as jsched
from bigdl_tpu.optim import validation as jval
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.nn import criterion as tcrit
from bigdl_tpu_torch.optim import optim_method as toptim
from bigdl_tpu_torch.optim import schedules as tsched
from bigdl_tpu_torch.optim import validation as tval
from bigdl_tpu_torch.optim.train_step import evaluate
from bigdl_tpu_torch.utils import load_jax_params


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def _sequential(m):
    return (m.SequentialSchedule().add(m.Warmup(0.1 / 4), 4)
            .add(m.MultiStep([8, 20], 0.1), 10 ** 9))


SCHEDULES = {
    "Default": lambda m: m.Default(0.05),
    "Step": lambda m: m.Step(7, 0.5),
    "MultiStep": lambda m: m.MultiStep([3, 10, 25], 0.3),
    "Exponential": lambda m: m.Exponential(6, 0.7),
    "Exponential_stair": lambda m: m.Exponential(6, 0.7, stair_case=True),
    "NaturalExp": lambda m: m.NaturalExp(5, 0.4),
    "Poly": lambda m: m.Poly(0.9, 30),
    "EpochStep": lambda m: m.EpochStep(2, 0.5, steps_per_epoch=4),
    "EpochDecay": lambda m: m.EpochDecay(lambda e: e / 3.0, 5),
    "EpochSchedule": lambda m: m.EpochSchedule(
        [(1, 2, 0.3), (3, 5, 0.1), (8, 9, 0.01)], steps_per_epoch=3),
    "Cosine": lambda m: m.Cosine(25, alpha=0.1),
    "Warmup": lambda m: m.Warmup(0.02),
    "Sequential": _sequential,
    "Sequential_cosine": lambda m: (m.SequentialSchedule()
                                    .add(m.Warmup(0.01), 5)
                                    .add(m.Cosine(20), 20)),
    "Plateau": lambda m: m.Plateau(factor=0.5, patience=1),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_lrs_match_jax(name):
    """The lr of every step 0..40 at base lr 0.1."""
    port = SCHEDULES[name](tsched)
    with jax.enable_x64(True):
        ref = SCHEDULES[name](jsched)
        want = [float(ref(0.1, jnp.asarray(s))) for s in range(41)]
    got = [port(0.1, s) for s in range(41)]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_plateau_follows_scores_as_jax():
    """on_score over a score sequence: the same factor changes, the same
    lrs, and the state dict round-trips."""
    kw = dict(factor=0.5, patience=2, mode="max", epsilon=1e-3,
              cooldown=1, min_lr=0.02)
    jp, tp = jsched.Plateau(**kw), tsched.Plateau(**kw)
    scores = [0.5, 0.6, 0.6, 0.59, 0.61, 0.6, 0.6, 0.6, 0.6, 0.7, 0.7,
              0.7, 0.7, 0.7, 0.7]
    for s in scores:
        assert tp.on_score(s) == jp.on_score(s)
        assert tp(0.1, 0) == pytest.approx(jp(0.1, 0), rel=1e-12)
        assert tp.state_dict() == jp.state_dict()
    fresh = tsched.Plateau(**kw)
    fresh.load_state_dict(tp.state_dict())
    assert fresh.state_dict() == tp.state_dict()


# ---------------------------------------------------------------------------
# optim methods
# ---------------------------------------------------------------------------

METHODS = [
    ("AdamWeightDecay", dict(learning_rate=1e-2, warmup_portion=0.3,
                             total=10)),
    ("AdamWeightDecay", dict(learning_rate=1e-2)),
    ("Adagrad", dict(learning_rate=0.1, learning_rate_decay=0.1,
                     weight_decay=1e-2)),
    ("RMSprop", dict(learning_rate=1e-2, learning_rate_decay=0.05)),
    ("Adadelta", dict(learning_rate=0.5)),
    ("Adamax", dict(learning_rate=2e-2)),
    ("Ftrl", dict(learning_rate=0.1, l1_regularization_strength=0.05,
                  l2_regularization_strength=0.01)),
    ("LarsSGD", dict(learning_rate=0.1, trust_coefficient=0.02)),
    ("LBFGS", dict(learning_rate=0.5, history_size=3)),
]


@pytest.mark.parametrize("name,kw", METHODS,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(METHODS)])
def test_optim_method_updates_match_jax(name, kw):
    """Steps 0..2 of the in-place update against the JAX method's pure
    update on the same gradients (LBFGS: three calls, so the history
    fills); the slots carry the JAX names."""
    rs = np.random.RandomState(5)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    params = [rs.randn(*s).astype(np.float32) for s in shapes]
    jm, tm = getattr(joptim, name)(**kw), getattr(toptim, name)(**kw)
    assert tm.elementwise == jm.elementwise
    jp = [jnp.asarray(p) for p in params]
    js = jm.init_state(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    ts = tm.init_state(tp)
    assert sorted(ts) == sorted(js)
    for step in range(3):
        grads = [rs.randn(*s).astype(np.float32) for s in shapes]
        jp, js = jm.update(step, [jnp.asarray(g) for g in grads], jp, js)
        tm.update(step, [torch.from_numpy(g) for g in grads], tp, ts)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    for slot, val in ts.items():
        want = js[slot]
        got = val if isinstance(val, list) else [val]
        for a, b in zip(got, want if isinstance(want, list) else [want]):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# criteria
# ---------------------------------------------------------------------------

def _crit_inputs(name, rs):
    x = rs.randn(6, 5).astype(np.float32)
    if name in ("BCECriterion",):
        return (1 / (1 + np.exp(-x))).astype(np.float32), \
            (rs.rand(6, 5) > 0.5).astype(np.float32)
    if name == "BCEWithLogitsCriterion":
        return x, (rs.rand(6, 5) > 0.5).astype(np.float32)
    if name == "KLDivCriterion":
        t = rs.dirichlet(np.ones(5), 6).astype(np.float32)
        t[0, 1] = 0.0
        return np.log(rs.dirichlet(np.ones(5), 6)).astype(np.float32), t
    if name in ("CosineEmbeddingCriterion",):
        return ((x, rs.randn(6, 5).astype(np.float32)),
                np.array([1, -1, 1, -1, -1, 1], np.float32))
    if name == "MarginRankingCriterion":
        return ((rs.randn(6).astype(np.float32),
                 rs.randn(6).astype(np.float32)),
                np.array([1, -1, 1, 1, -1, -1], np.float32))
    if name == "TimeDistributedCriterion":
        return (rs.randn(3, 4, 5).astype(np.float32),
                rs.randn(3, 4, 5).astype(np.float32))
    if name == "ParallelCriterion":
        return ((x, rs.randn(6, 2).astype(np.float32)),
                (rs.randn(6, 5).astype(np.float32),
                 rs.randn(6, 2).astype(np.float32)))
    return x, (rs.randn(6, 5) * 1.5).astype(np.float32)


CRITERIA = {
    "MSECriterion": lambda m, sa: m.MSECriterion(sa),
    "AbsCriterion": lambda m, sa: m.AbsCriterion(sa),
    "SmoothL1Criterion": lambda m, sa: m.SmoothL1Criterion(sa),
    "BCECriterion": lambda m, sa: m.BCECriterion(sa),
    "BCEWithLogitsCriterion": lambda m, sa: m.BCEWithLogitsCriterion(sa),
    "KLDivCriterion": lambda m, sa: m.KLDivCriterion(sa),
    "CosineEmbeddingCriterion": lambda m, sa: m.CosineEmbeddingCriterion(
        0.1, sa),
    "MarginRankingCriterion": lambda m, sa: m.MarginRankingCriterion(
        0.5, sa),
    "ParallelCriterion": lambda m, sa: m.ParallelCriterion(
        (m.MSECriterion(sa), 0.5), (m.AbsCriterion(sa), 2.0)),
    "TimeDistributedCriterion": lambda m, sa: m.TimeDistributedCriterion(
        m.MSECriterion(), sa),
}


def _as_tree(a, fn):
    return tuple(fn(v) for v in a) if isinstance(a, tuple) else fn(a)


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("name", sorted(CRITERIA))
def test_criterion_value_and_gradient_match_jax(name, size_average):
    x, t = _crit_inputs(name, np.random.RandomState(7))
    jc = CRITERIA[name](jcrit, size_average)
    tc = CRITERIA[name](tcrit, size_average)
    jt = _as_tree(t, jnp.asarray)
    want, jg = jax.value_and_grad(lambda v: jc(v, jt))(
        _as_tree(x, jnp.asarray))
    tx = _as_tree(x, lambda v: torch.from_numpy(v.copy()).requires_grad_())
    got = tc(tx, _as_tree(t, torch.from_numpy))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                               atol=1e-7)
    for a, b in zip(_as_tree(tx, lambda v: v) if isinstance(tx, tuple)
                    else (tx,),
                    jg if isinstance(jg, tuple) else (jg,)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# validation methods
# ---------------------------------------------------------------------------

N_VAL, VAL_BATCH = 37, 16          # the last of 3 batches holds 5 rows


def _val_case(name, rs):
    out = rs.randn(N_VAL, 8).astype(np.float32)
    if name in ("MAE", "MSE"):
        return out, rs.randn(N_VAL, 8).astype(np.float32)
    if name == "AUC":
        return (rs.randn(N_VAL, 2).astype(np.float32),
                (rs.rand(N_VAL) > 0.4).astype(np.int32))
    labels = rs.randint(0, 8, N_VAL).astype(np.int32)
    out[:10, 1] += 3.0              # some class-1 predictions
    labels[5:12] = 1
    if name != "Top5Accuracy":     # top-k order among ties is unspecified
        out[20, labels[20]] = out[20, (labels[20] + 1) % 8]   # a tie
    return out, labels


VALIDATION = {
    "Top1Accuracy": lambda m: m.Top1Accuracy(),
    "Top5Accuracy": lambda m: m.Top5Accuracy(),
    "Loss": lambda m: m.Loss(),
    "MAE": lambda m: m.MAE(),
    "MSE": lambda m: m.MSE(),
    "Precision": lambda m: m.Precision(),
    "Recall": lambda m: m.Recall(),
    "HitRatio": lambda m: m.HitRatio(3),
    "NDCG": lambda m: m.NDCG(3),
    "AUC": lambda m: m.AUC(),
}


@pytest.mark.parametrize("name", sorted(VALIDATION))
def test_validation_method_on_a_ragged_last_batch(name):
    """37 rows in batches of 16 (``drop_last=False``): the JAX method
    folds its weighted (sum, count) over the padded plan; the port's
    ``evaluate`` drops the padded rows.  Each row counts once in both,
    and the port's weighted ``batch_stats`` equal the JAX ones."""
    out, tgt = _val_case(name, np.random.RandomState(11))
    jm, tm = VALIDATION[name](jval), VALIDATION[name](tval)
    plan = list(DataSet.array(out, tgt).batches(
        VAL_BATCH, shuffle=False, drop_last=False))
    assert len(plan) == 3 and "weight" in plan[-1]
    js = jc = 0.0
    for mb in plan:
        w = mb.get("weight", np.ones(VAL_BATCH, np.float32))
        s, c = jm.batch_stats(jnp.asarray(mb["input"]),
                              jnp.asarray(mb["target"]), jnp.asarray(w))
        ts, tc = tm.batch_stats(torch.from_numpy(mb["input"]),
                                torch.from_numpy(mb["target"]),
                                torch.from_numpy(w))
        np.testing.assert_allclose([ts.item(), tc.item()],
                                   [float(s), float(c)], rtol=1e-6,
                                   atol=1e-6)
        js, jc = js + float(s), jc + float(c)
    want = jm.fold(js, jc)
    (got,) = evaluate(nn.Identity(), [tm], DataSet.array(out, tgt).batches(
        VAL_BATCH, shuffle=False, drop_last=False), torch.device("cpu"))
    assert got.name == want.name
    np.testing.assert_allclose([got.result, got.count],
                               [want.result, want.count], rtol=1e-6)


# ---------------------------------------------------------------------------
# layers: training-mode gradients and running statistics
# ---------------------------------------------------------------------------

def _grad_pair(jl, tl, x, training=True):
    """(port, JAX) gradients of sum(out * r) w.r.t. the input and every
    parameter, and the new state, for a layer whose JAX params are copied
    into the port layer."""
    v = _np(jl.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    if v["params"]:
        load_jax_params(tl, v["params"])
    load_jax_params(tl, v["state"])
    tl.train(training)
    out, new_state = jl.apply(v, jnp.asarray(x), training=training)
    r = np.random.RandomState(3).randn(*out.shape).astype(np.float32)

    def f(params, xx):
        y, _ = jl.apply({"params": params, "state": v["state"]}, xx,
                        training=training)
        return jnp.sum(y * r)

    jgp, jgx = jax.grad(f, argnums=(0, 1))(v["params"], jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    (tl(tx) * torch.from_numpy(r)).sum().backward()
    return tx, jgx, dict(tl.named_parameters()), jgp, new_state


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


LAYERS = {
    "conv_same_s2": (lambda: jnn.Conv2D(3, 8, 3, stride=2, padding="SAME"),
                     lambda: nn.Conv2D(3, 8, 3, stride=2, padding="SAME"),
                     (2, 9, 9, 3)),
    "conv_valid_groups": (lambda: jnn.Conv2D(4, 6, (3, 2), groups=2),
                          lambda: nn.Conv2D(4, 6, (3, 2), groups=2),
                          (2, 7, 6, 4)),
    "maxpool_3s2p1": (lambda: jnn.MaxPool2D(3, 2, padding=1),
                      lambda: nn.MaxPool2D(3, 2, padding=1), (2, 9, 9, 3)),
    "avgpool_2": (lambda: jnn.AvgPool2D(2, 2), lambda: nn.AvgPool2D(2, 2),
                  (2, 8, 8, 3)),
    "global_avgpool": (lambda: jnn.GlobalAvgPool2D(),
                       lambda: nn.GlobalAvgPool2D(), (2, 5, 5, 4)),
    "batchnorm_nhwc": (lambda: jnn.BatchNorm(4), lambda: nn.BatchNorm(4),
                       (3, 5, 5, 4)),
    "batchnorm_2d": (lambda: jnn.BatchNorm(6), lambda: nn.BatchNorm(6),
                     (16, 6)),
    "batchnorm_lazy": (lambda: jnn.BatchNorm(), lambda: nn.BatchNorm(),
                       (16, 6)),
    "linear_lazy": (lambda: jnn.Linear(5), lambda: nn.Linear(5), (4, 7)),
    "prelu": (lambda: jnn.PReLU(0.2), lambda: nn.PReLU(0.2), (4, 3, 3, 5)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_gradients_and_running_stats_match_jax(name):
    """Input and parameter gradients of each layer in training mode
    against ``jax.grad``; BatchNorm's running statistics after the step
    against the JAX new state (shifted inputs, so the shift matters)."""
    make_j, make_t, shape = LAYERS[name]
    rs = np.random.RandomState(2)
    x = (rs.randn(*shape) * 2 + 0.7).astype(np.float32)
    tl = make_t()
    if any(isinstance(p, torch.nn.parameter.UninitializedParameter)
           for p in tl.parameters()):
        with torch.no_grad():
            tl.train(False)
            tl(torch.from_numpy(x[:1]))
    tx, jgx, tparams, jgp, new_state = _grad_pair(make_j(), tl, x)
    _close(tx.grad.numpy(), jgx)
    assert sorted(tparams) == sorted(jgp)
    for n, p in tparams.items():
        _close(p.grad.numpy(), jgp[n])
    for n, b in tl.named_buffers():
        _close(b.numpy(), new_state[n], rtol=1e-6)
