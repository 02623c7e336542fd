"""The port's training driver: the single-device specs of
``tests/test_distri_optimizer.py`` written on the port (CPU, the same
data, models and thresholds), ``TrainedModel.variables`` as the
``{"params", "state"}`` tree, checkpoints read across the two packages,
the trainable mask and Plateau against the JAX Optimizer, and remat.

The JAX Optimizer runs on one data replica (``init_engine(data=1)``), so
its step is the port's up to the order of float32 sums: losses within
1e-5 absolute."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.optim import checkpoint as jckpt
from bigdl_tpu.runtime.engine import Engine, init_engine
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.optim import checkpoint as ckpt_mod
from bigdl_tpu_torch.optim.train_step import TrainStep

CPU = "cpu"


def synthetic_classification(n=1024, d=16, classes=4, seed=0):
    """Linearly-separable-ish synthetic data, learnable to >95%."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d) * 3
    y = rng.randint(0, classes, size=n)
    x = centers[y] + rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int32)


def mlp(m=nn, classes=4, **kw):
    return m.Sequential([m.Linear(16, 64, **kw), m.ReLU(),
                         m.Linear(64, classes, **kw), m.LogSoftMax()])


# ---------------------------------------------------------------------------
# the single-device specs of tests/test_distri_optimizer.py
# ---------------------------------------------------------------------------

def test_convergence_and_validation():
    x, y = synthetic_classification()
    train = DataSet.array(x[:896], y[:896])
    val = DataSet.array(x[896:], y[896:])
    opt = optim.Optimizer(mlp(), train, nn.ClassNLLCriterion(),
                          batch_size=128, device=CPU)
    opt.set_optim_method(optim.Adam(learning_rate=1e-2))
    opt.set_end_when(optim.Trigger.max_epoch(8))
    opt.set_validation(optim.Trigger.every_epoch(), val,
                       [optim.Top1Accuracy()])
    trained = opt.optimize()
    assert [it for it, _ in opt.validations] == [7 * k for k in range(1, 9)]
    assert opt.final_state["n_validations"] == 8
    results = trained.evaluate(val, [optim.Top1Accuracy()], batch_size=128)
    assert results[0].result > 0.9, results
    assert results[0].count == 128

    # predict agrees with evaluate
    preds = trained.predict(x[896:])
    acc = float(np.mean(np.argmax(preds, -1) == y[896:]))
    assert acc == pytest.approx(results[0].result, abs=1e-6)


def test_checkpoint_resume(tmp_path):
    x, y = synthetic_classification(n=256)
    ds = DataSet.array(x, y)
    ckpt_dir = str(tmp_path / "ckpt")

    def run(max_iter):
        opt = optim.Optimizer(mlp(), ds, nn.ClassNLLCriterion(),
                              batch_size=64, seed=3, device=CPU)
        opt.set_optim_method(optim.Adam(learning_rate=1e-2))
        opt.set_end_when(optim.Trigger.max_iteration(max_iter))
        opt.set_checkpoint(ckpt_dir, optim.Trigger.several_iteration(4))
        return opt.optimize()

    run(8)  # writes ckpt-4, ckpt-8
    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    assert latest and latest.endswith("ckpt-8")

    # resume continues from iteration 8 (fresh Optimizer resumes and runs to 12)
    trained = run(12)
    latest = ckpt_mod.latest_checkpoint(ckpt_dir)
    assert latest.endswith("ckpt-12")
    res = trained.evaluate(ds, [optim.Top1Accuracy()])
    assert res[0].result > 0.8


def test_gradient_clipping_runs():
    x, y = synthetic_classification(n=256)
    ds = DataSet.array(x, y)
    opt = optim.Optimizer(mlp(), ds, nn.ClassNLLCriterion(), batch_size=64,
                          device=CPU)
    opt.set_optim_method(optim.SGD(learning_rate=0.05))
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_end_when(optim.Trigger.max_iteration(10))
    trained = opt.optimize()
    assert trained is not None


def test_bn_dropout_model_trains():
    """Stateful (BN, lazy width) + keyed (Dropout) paths through the
    step."""
    x, y = synthetic_classification(n=512)
    ds = DataSet.array(x, y)
    model = nn.Sequential([
        nn.Linear(16, 32), nn.BatchNorm(), nn.ReLU(), nn.Dropout(0.2),
        nn.Linear(32, 4), nn.LogSoftMax(),
    ])
    opt = optim.Optimizer(model, ds, nn.ClassNLLCriterion(), batch_size=64,
                          device=CPU)
    opt.set_optim_method(optim.Adam(learning_rate=1e-2))
    opt.set_end_when(optim.Trigger.max_epoch(6))
    trained = opt.optimize()
    res = trained.evaluate(ds, [optim.Top1Accuracy()])
    assert res[0].result > 0.85
    # BN state was actually updated
    st = jax.tree_util.tree_leaves(trained.variables["state"])
    assert any(float(np.max(np.abs(s))) > 1e-3 for s in st)


def test_grad_accumulation_matches_full_batch():
    """accum_steps=k computes the SAME mean gradient as the full batch in
    one pass: identical loss trajectories (stateless model, f32)."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(64, 8).astype(np.float32))
    y = torch.from_numpy((x[:, 0] > 0).numpy().astype(np.int32))

    def make(method, **kw):
        g = torch.Generator().manual_seed(0)
        model = nn.Sequential([nn.Linear(8, 16, generator=g), nn.Tanh(),
                               nn.Linear(16, 2, generator=g)])
        return TrainStep(model, nn.CrossEntropyCriterion(), method, **kw)

    full = make(optim.SGD(learning_rate=0.2))
    acc = make(optim.SGD(learning_rate=0.2), accum_steps=4)
    for i in range(15):
        lf = float(full(i, x, y))
        la = float(acc(i, x, y))
        np.testing.assert_allclose(la, lf, rtol=2e-5, err_msg=f"step {i}")

    # LARS (layerwise, non-elementwise) also accepts accumulation
    lars = make(optim.LarsSGD(learning_rate=0.05, trust_coefficient=0.02),
                accum_steps=2)
    l0 = float(lars(0, x, y))
    assert np.isfinite(l0)


def test_optimizer_exposes_step_knobs():
    """remat/accum_steps set on the Optimizer reach the step and training
    still converges."""
    x, y = synthetic_classification(n=256)
    ds = DataSet.array(x, y)
    opt = optim.Optimizer(mlp(), ds, nn.ClassNLLCriterion(), batch_size=64,
                          device=CPU)
    opt.accum_steps = 2
    opt.remat = True
    opt.set_optim_method(optim.Adam(learning_rate=1e-2))
    opt.set_end_when(optim.Trigger.max_epoch(6))
    trained = opt.optimize()
    res = trained.evaluate(ds, [optim.Top1Accuracy()])
    assert res[0].result > 0.9, res


def test_ema_weights_in_step():
    """ema_decay keeps a weight EMA in the step: after training, EMA
    params differ from the live params, track them closely, and evaluate
    as a valid model."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(64, 6).astype(np.float32))
    y = torch.from_numpy((x[:, 0] > 0).numpy().astype(np.int32))
    g = torch.Generator().manual_seed(0)
    model = nn.Sequential([nn.Linear(6, 8, generator=g), nn.ReLU(),
                           nn.Linear(8, 2, generator=g)])
    step = TrainStep(model, nn.CrossEntropyCriterion(),
                     optim.SGD(learning_rate=0.3), ema_decay=0.9)
    for i in range(40):
        loss = step(i, x, y)
    assert np.isfinite(float(loss))

    live = step.get_variables()["params"]
    ema = step.get_variables(ema=True)["params"]
    lf, _ = ravel_pytree(live)
    ef, _ = ravel_pytree(ema)
    diff = float(jnp.linalg.norm(lf - ef))
    assert diff > 1e-4                       # EMA genuinely lags
    assert diff < 0.5 * float(jnp.linalg.norm(lf))   # ...but tracks

    # EMA params evaluate as a working model
    from bigdl_tpu_torch.utils import load_jax_params

    load_jax_params(model, ema)
    with torch.no_grad():
        out = model.train(False)(x)
    acc = float((out.argmax(-1) == y).float().mean())
    assert acc > 0.8, acc


def test_ema_checkpoints_and_survives_resume(tmp_path):
    """EMA state is checkpointed, restored by resume, and publicly
    reachable via TrainedModel.ema_variables."""
    x, y = synthetic_classification(n=256)
    ds = DataSet.array(x, y)
    d = str(tmp_path / "ck")

    def run(max_iter):
        opt = optim.Optimizer(mlp(), ds, nn.ClassNLLCriterion(),
                              batch_size=64, seed=3, device=CPU)
        opt.ema_decay = 0.95
        opt.set_optim_method(optim.Adam(learning_rate=1e-2))
        opt.set_end_when(optim.Trigger.max_iteration(max_iter))
        opt.set_checkpoint(d, optim.Trigger.several_iteration(4))
        return opt.optimize()

    run(8)
    latest = ckpt_mod.latest_checkpoint(d)
    assert "ema.npz" in os.listdir(latest)        # EMA blob saved
    trained = run(16)                             # resumes, EMA restored
    ema_vars = trained.ema_variables
    assert ema_vars is not None
    res = trained.evaluate(ds, [optim.Top1Accuracy()])
    trained.set_variables(ema_vars)
    res_ema = trained.evaluate(ds, [optim.Top1Accuracy()])
    assert res_ema[0].result > 0.7, (res[0].result, res_ema[0].result)


# ---------------------------------------------------------------------------
# TrainedModel.variables, async checkpoints, refusals
# ---------------------------------------------------------------------------

def test_trained_model_variables_hold_params_and_state():
    """``variables`` is the JAX ``{"params", "state"}`` tree: the BN
    running statistics under ``state``, ``["params"]`` as before."""
    x, y = synthetic_classification(n=128)
    model = nn.Sequential([nn.Linear(16, 8), nn.BatchNorm(8), nn.ReLU(),
                           nn.Linear(8, 4), nn.LogSoftMax()])
    opt = (optim.Optimizer(model, DataSet.array(x, y),
                           nn.ClassNLLCriterion(), batch_size=32, device=CPU)
           .set_end_when(optim.Trigger.max_iteration(3)))
    v = opt.optimize().variables
    assert sorted(v) == ["params", "state"]
    assert sorted(v["state"]["1_BatchNorm"]) == ["running_mean",
                                                "running_var"]
    np.testing.assert_array_equal(
        v["state"]["1_BatchNorm"]["running_mean"],
        model[1].running_mean.numpy())
    assert sorted(v["params"]["0_Linear"]) == ["bias", "weight"]


def test_async_checkpoint_matches_sync_and_wait_raises(tmp_path):
    """An async write holds the tensors of its trigger (the same bytes as
    a synchronous write of the same run), and ``wait`` raises the
    writer's error."""
    x, y = synthetic_classification(n=256)

    def run(d, async_write):
        opt = optim.Optimizer(
            mlp(generator=torch.Generator().manual_seed(0)),
            DataSet.array(x, y), nn.ClassNLLCriterion(), batch_size=64,
            seed=3, device=CPU)
        opt.set_optim_method(optim.Adam(learning_rate=1e-2))
        opt.set_end_when(optim.Trigger.max_iteration(6))
        opt.set_checkpoint(d, optim.Trigger.several_iteration(2),
                           async_write=async_write)
        opt.optimize()

    run(str(tmp_path / "a"), True)
    run(str(tmp_path / "s"), False)
    for step in (4, 6):
        got = ckpt_mod.load_checkpoint(str(tmp_path / "a" / f"ckpt-{step}"))
        want = ckpt_mod.load_checkpoint(str(tmp_path / "s" / f"ckpt-{step}"))
        np.testing.assert_array_equal(got[0], want[0])
        for k in want[1]:
            np.testing.assert_array_equal(got[1][k], want[1][k])
        assert got[3]["iteration"] == step
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    writer = ckpt_mod.AsyncCheckpointer()
    writer.submit(str(blocker), 1, flat_params=np.zeros(3, np.float32),
                  opt_state={}, model_state={})
    with pytest.raises(OSError):
        writer.wait()


def test_sharded_and_mirrored_checkpoints_are_refused(tmp_path):
    opt = optim.Optimizer(mlp(), DataSet.array(*synthetic_classification(
        n=64)), nn.ClassNLLCriterion(), device=CPU)
    every = optim.Trigger.several_iteration(1)
    for kw in (dict(sharded=True), dict(mirror=str(tmp_path / "m"))):
        with pytest.raises(ValueError, match="A.2"):
            opt.set_checkpoint(str(tmp_path), every, **kw)


# ---------------------------------------------------------------------------
# against the JAX Optimizer
# ---------------------------------------------------------------------------

def _jax_run(model, x, y, method, n_iter, init, *, ckpt_dir=None,
             ckpt_every=None, summary=None, **attrs):
    """Losses of a JAX ``Optimizer`` run on one data replica."""
    Engine.reset()
    init_engine(data=1)
    try:
        opt = joptim.Optimizer(model, JArrayDataSet(x, y),
                               jnn.ClassNLLCriterion(), batch_size=64,
                               seed=3)
        opt.set_optim_method(method)
        opt.set_end_when(joptim.Trigger.max_iteration(n_iter))
        opt.set_initial_variables(init)
        for k, v in attrs.items():
            setattr(opt, k, v)
        if ckpt_dir:
            opt.set_checkpoint(ckpt_dir,
                               joptim.Trigger.several_iteration(ckpt_every))
        opt.set_train_summary(summary)
        trained = opt.optimize()
        losses = [v for _, v in opt._train_summary.read_scalar("loss")]
        return losses, trained
    finally:
        Engine.reset()


def _port_opt(x, y, method, n_iter, **attrs):
    opt = optim.Optimizer(mlp(), DataSet.array(x, y), nn.ClassNLLCriterion(),
                          batch_size=64, seed=3, device=CPU)
    opt.set_optim_method(method).set_end_when(
        optim.Trigger.max_iteration(n_iter))
    for k, v in attrs.items():
        setattr(opt, k, v)
    return opt


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX-written checkpoint (Adam, EMA, after 4 steps, mid-epoch)
    resumed by the port for 4 more steps gives the JAX run's steps 5-8
    within 1e-5; the port's checkpoint at 8 carries the JAX slot names
    and its params.npz unravels into the JAX params tree."""
    x, y = synthetic_classification(n=384)       # 6 batches an epoch
    jm = mlp(jnn)
    init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(0), x[:1]))
    d = str(tmp_path / "ck")
    _jax_run(jm, x, y, joptim.Adam(learning_rate=1e-2), 4, init,
             ckpt_dir=d, ckpt_every=4, summary=str(tmp_path / "s1"),
             ema_decay=0.9)
    want, jtrained = _jax_run(jm, x, y, joptim.Adam(learning_rate=1e-2), 8,
                              init, summary=str(tmp_path / "s2"),
                              ema_decay=0.9)
    opt = _port_opt(x, y, optim.Adam(learning_rate=1e-2), 8, ema_decay=0.9)
    opt.set_checkpoint(d, optim.Trigger.several_iteration(4))
    trained = opt.optimize()
    assert opt.final_state["iteration"] == 8
    assert opt.final_state["epoch"] == 2
    np.testing.assert_allclose(opt.losses, want[4:], rtol=0, atol=1e-5)
    jv = jtrained.variables["params"]
    for a, b in zip(jax.tree_util.tree_leaves(trained.variables["params"]),
                    jax.tree_util.tree_leaves(jv)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)

    # the port's own checkpoint at 8, read as the JAX package reads it
    mine = os.path.join(d, "ckpt-8")
    with np.load(os.path.join(mine, "params.npz")) as z:
        flat = z["flat"]
    _, unravel = ravel_pytree(init["params"])
    tree = unravel(jnp.asarray(flat))
    port_params = trained.variables["params"]
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(port_params))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(port_params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(os.path.join(d, "ckpt-4", "opt_state.npz")) as zj, \
            np.load(os.path.join(mine, "opt_state.npz")) as zp:
        assert sorted(zj.files) == sorted(zp.files) == ["m", "v"]
    slots = {k: np.zeros(flat.shape, np.float32) for k in ("m", "v")}
    _, opt_j, _, drv, ema_j = jckpt.load_checkpoint(
        mine, opt_state_template=slots, model_state_template={})
    assert drv["iteration"] == 8 and ema_j.shape == flat.shape
    assert sorted(opt_j) == ["m", "v"]


def test_padded_jax_checkpoint_reads_its_real_length(tmp_path):
    """A checkpoint of the JAX Optimizer on its 8-device mesh pads the flat
    vectors to a multiple of 8 (1348 -> 1352); the port restores the
    first 1348 entries, parameters and Adam slots alike."""
    x, y = synthetic_classification(n=128)
    d = str(tmp_path / "ck8")
    Engine.reset()
    init_engine()
    try:
        jo = joptim.Optimizer(mlp(jnn), JArrayDataSet(x, y),
                              jnn.ClassNLLCriterion(), batch_size=64, seed=3)
        jo.set_optim_method(joptim.Adam(learning_rate=1e-2))
        jo.set_end_when(joptim.Trigger.max_iteration(2))
        jo.set_checkpoint(d, joptim.Trigger.several_iteration(2))
        jtrained = jo.optimize()
    finally:
        Engine.reset()
    with np.load(os.path.join(d, "ckpt-2", "params.npz")) as z:
        assert z["flat"].shape == (1352,)
    opt = _port_opt(x, y, optim.Adam(learning_rate=1e-2), 2)
    opt.set_checkpoint(d, optim.Trigger.several_iteration(100))
    trained = opt.optimize()               # resumes at 2, trains nothing
    assert opt.losses == []
    for a, b in zip(jax.tree_util.tree_leaves(trained.variables["params"]),
                    jax.tree_util.tree_leaves(jtrained.variables["params"])):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_trainable_mask_and_weight_decay_match_jax(tmp_path):
    """A frozen first layer (``trainable = False``): SGD with weight
    decay and momentum moves nothing of it, in both packages, and the
    losses agree within 1e-5."""
    x, y = synthetic_classification(n=256)
    jm = mlp(jnn)
    jm.layers[0].trainable = False
    init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(0), x[:1]))

    def method(m):
        return m.SGD(learning_rate=0.1, momentum=0.9, weight_decay=1e-2)

    want, _ = _jax_run(jm, x, y, method(joptim), 6, init,
                       summary=str(tmp_path))
    model = mlp()
    model[0].trainable = False
    opt = optim.Optimizer(model, DataSet.array(x, y), nn.ClassNLLCriterion(),
                          batch_size=64, seed=3, device=CPU)
    opt.set_optim_method(method(optim)).set_end_when(
        optim.Trigger.max_iteration(6)).set_initial_variables(init)
    trained = opt.optimize()
    np.testing.assert_allclose(opt.losses, want, rtol=0, atol=1e-5)
    got = trained.variables["params"]
    for k in ("weight", "bias"):
        np.testing.assert_array_equal(got["0_Linear"][k],
                                      init["params"]["0_Linear"][k])
    assert not np.array_equal(got["2_Linear"]["weight"],
                              init["params"]["2_Linear"]["weight"])


def test_plateau_in_the_driver_matches_jax(tmp_path):
    """Plateau fed by every-epoch validation: the factor drops at the
    same validations in both Optimizers (after epochs 2 and 3), the losses
    agree up to the drop, and the port's next step reads the new factor.
    (The JAX Optimizer rebuilds only its one-step program on a drop, while
    it trains through its step-bundle program, so its steps after a drop
    keep the old rate: ROADMAP C.11.)"""
    x, y = synthetic_classification(n=256)
    jm = mlp(jnn)
    init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(0), x[:1]))
    kw = dict(factor=0.5, patience=1, mode="min", epsilon=10.0)
    Engine.reset()
    init_engine(data=1)
    try:
        jsched = joptim.Plateau(**kw)
        jo = joptim.Optimizer(jm, JArrayDataSet(x, y),
                              jnn.ClassNLLCriterion(), batch_size=64, seed=3)
        jo.set_optim_method(joptim.SGD(learning_rate=0.1,
                                       learning_rate_schedule=jsched))
        jo.set_end_when(joptim.Trigger.max_epoch(3))
        jo.set_initial_variables(init)
        jo.set_validation(joptim.Trigger.every_epoch(), JArrayDataSet(x, y),
                          [joptim.Loss(jnn.ClassNLLCriterion())])
        jo.set_train_summary(str(tmp_path))
        jo.optimize()
        want = [v for _, v in jo._train_summary.read_scalar("loss")]
    finally:
        Engine.reset()
    class Recording(optim.Plateau):
        def __call__(self, lr, step):
            out = super().__call__(lr, step)
            self.seen.append((step, out))
            return out

    tsched = Recording(**kw)
    tsched.seen = []
    opt = optim.Optimizer(mlp(), DataSet.array(x, y), nn.ClassNLLCriterion(),
                          batch_size=64, seed=3, device=CPU)
    opt.set_optim_method(optim.SGD(learning_rate=0.1,
                                   learning_rate_schedule=tsched))
    opt.set_end_when(optim.Trigger.max_epoch(3)).set_initial_variables(init)
    opt.set_validation(optim.Trigger.every_epoch(), DataSet.array(x, y),
                       [optim.Loss(nn.ClassNLLCriterion())])
    opt.optimize()
    assert tsched.current_factor == jsched.current_factor == 0.25
    assert len(opt.losses) == len(want) == 12
    # losses 1-9: step 9's loss comes before the first update at 0.05
    np.testing.assert_allclose(opt.losses[:9], want[:9], rtol=0, atol=1e-5)
    assert tsched.seen == [(i, 0.1 if i < 8 else 0.05) for i in range(12)]


def _bn_mlp(g):
    return nn.Sequential([
        nn.Linear(16, 32, generator=g), nn.BatchNorm(32), nn.ReLU(),
        nn.Dropout(0.2), nn.Sequential([nn.Linear(32, 32, generator=g),
                                        nn.BatchNorm(32)]),
        nn.ReLU(), nn.Linear(32, 4, generator=g), nn.LogSoftMax()])


@pytest.mark.parametrize("model", ["bn_mlp", "resnet_cifar8"])
def test_remat_keeps_bn_running_stats(model):
    """remat (both policies) against remat=False: the same losses, the
    same BatchNorm running statistics after 4 steps (the recompute
    replays each BN's shift and leaves its buffers), on an MLP with
    dropout and a nested container, and on a CIFAR ResNet whose blocks
    hold BNs below the top level."""
    from bigdl_tpu_torch.models import resnet_cifar

    if model == "bn_mlp":
        (x, y), build = synthetic_classification(n=128), _bn_mlp
    else:
        rs = np.random.RandomState(0)
        x = rs.randn(32, 16, 16, 3).astype(np.float32)
        y = rs.randint(0, 10, 32).astype(np.int32)
        build = lambda g: resnet_cifar(8, generator=g)

    def run(remat, policy=None):
        opt = optim.Optimizer(build(torch.Generator().manual_seed(0)),
                              DataSet.array(x, y), nn.ClassNLLCriterion(),
                              batch_size=8, device=CPU)
        opt.remat, opt.remat_policy = remat, policy
        opt.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
        opt.set_end_when(optim.Trigger.max_iteration(4))
        trained = opt.optimize()
        return opt.losses, jax.tree_util.tree_leaves(
            trained.variables["state"])

    base_losses, base_state = run(False)
    for policy in (None, "dots"):
        losses, state = run(True, policy)
        np.testing.assert_allclose(losses, base_losses, rtol=0, atol=1e-6)
        for a, b in zip(state, base_state):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("SGD", dict(learning_rate=0.1, momentum=0.9)),
    ("LarsSGD", dict(learning_rate=0.1, trust_coefficient=0.02)),
    ("LBFGS", dict(learning_rate=0.05, history_size=3)),
])
def test_checkpoints_cross_for_every_slot_layout(tmp_path, name, kw):
    """An elementwise slot (one flat vector), per-tensor slots keyed
    ``<slot>/<path>`` and tensor slots (LBFGS ``rho``, ``count``): the JAX
    Optimizer writes ckpt-2 and resumes from it to ckpt-4; the port
    resumes from the same ckpt-2 to its own ckpt-4.  Both ckpt-4 hold the
    same keys, shapes and values within 1e-5 (relative for LBFGS's
    ``rho`` = 1 / y·s, which reaches ~100)."""
    import shutil

    x, y = synthetic_classification(n=256)
    jm = mlp(jnn)
    init = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        jm.init(jax.random.PRNGKey(0), x[:1]))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for n_iter in (2, 4):
        _jax_run(jm, x, y, getattr(joptim, name)(**kw), n_iter, init,
                 ckpt_dir=jdir, ckpt_every=2,
                 summary=str(tmp_path / f"s{n_iter}"))
    os.makedirs(pdir)
    shutil.copytree(os.path.join(jdir, "ckpt-2"),
                    os.path.join(pdir, "ckpt-2"))
    opt = _port_opt(x, y, getattr(optim, name)(**kw), 4)
    opt.set_checkpoint(pdir, optim.Trigger.several_iteration(2))
    opt.optimize()
    want = ckpt_mod.load_checkpoint(os.path.join(jdir, "ckpt-4"))
    got = ckpt_mod.load_checkpoint(os.path.join(pdir, "ckpt-4"))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        assert got[1][k].shape == want[1][k].shape, k
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    assert got[3]["iteration"] == want[3]["iteration"] == 4
