"""Step bundles on the port (``steps_per_call``), against its own eager
steps and against the JAX driver: the specs of
``tests/test_step_bundle.py`` at their size (``synthetic(n=320, d=12,
classes=3)``, a 2-layer MLP with dropout, SGD 0.1 with momentum 0.9,
batch 32), on the CPU, where a bundle runs the same step K times (the
plain version of the card's captured graphs).

The invariant: the bundle size changes only how steps are dispatched.
The port's K = 4 loss curve is byte-identical to its K = 1 curve, the
epoch-tail remainder bundle, trigger-clamped bundles and mid-epoch
resumes on and off the bundle grid included; and it is the JAX driver's
curve within 1e-5 (one data replica, ``init_engine(data=1)``, so the JAX
step's replica-0 dropout keys cover the batch as the port's do; the same
initial variables).  Then the recovery specs (a NaN batch rewound by the
watchdog, ``step_fail@5`` inside a bundle, the watchdog seeing every
step), the ``EngineConfig`` wiring, and the step-dependent values of
every optim method and schedule read from device tensors: the same bits
as the Python-float update, and a ``Plateau`` drop reaching the next
step (ROADMAP C.11)."""

import os

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data import ArrayDataSet as JArrayDataSet
from bigdl_tpu.resilience import faults as jfaults
from bigdl_tpu.resilience.detector import StepWatchdog as JStepWatchdog
from bigdl_tpu.runtime.engine import Engine as JEngine
from bigdl_tpu.runtime.engine import init_engine as jinit_engine
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.optim import checkpoint as ckpt_mod
from bigdl_tpu_torch.optim import schedules
from bigdl_tpu_torch.optim.train_step import TrainStep
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.resilience.detector import StepWatchdog
from bigdl_tpu_torch.runtime.engine import Engine, EngineConfig

CPU = "cpu"
ATOL = 1e-5


def synthetic(n=320, d=12, classes=3, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d) * 3
    y = rng.randint(0, classes, size=n)
    x = centers[y] + rng.randn(n, d)
    return x.astype(np.float32), y.astype(np.int32)


def mlp(m, d=12, classes=3):
    return m.Sequential([m.Linear(d, 32), m.ReLU(), m.Dropout(0.1),
                         m.Linear(32, classes), m.LogSoftMax()])


X, Y = synthetic()


@pytest.fixture(scope="module")
def init():
    """The JAX MLP's initial variables, which both drivers start from."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        mlp(jnn).init(jax.random.PRNGKey(0), X[:1]))


@pytest.fixture(autouse=True)
def _fresh_engines():
    Engine.reset()
    faults.clear()
    yield
    Engine.reset()
    faults.clear()


class _PoisonOnce:
    """NaN-poisons batch 5 of epoch 1 the first time it is served (the
    spec's ``_PoisonOnce``), for either package's batches()."""

    fired = False

    def __init__(self, inner):
        self.inner = inner

    def size(self):
        return self.inner.size()

    def batches(self, *a, **kw):
        for i, mb in enumerate(self.inner.batches(*a, **kw)):
            if kw.get("epoch") == 1 and i == 5 and not _PoisonOnce.fired:
                _PoisonOnce.fired = True
                mb = dict(mb, input=np.full_like(mb["input"], np.nan))
            yield mb


def run_port(tmp_path, tag, k, end_when, init, dataset=None, ckpt_dir=None,
             ckpt_trigger=None, watchdog=None):
    ds = dataset if dataset is not None else DataSet.array(X, Y)
    opt = optim.Optimizer(mlp(nn), ds, nn.ClassNLLCriterion(),
                          batch_size=32, seed=11, device=CPU)
    opt.steps_per_call = k
    opt.set_optim_method(optim.SGD(learning_rate=0.1, momentum=0.9))
    opt.set_end_when(end_when).set_initial_variables(init)
    opt.set_train_summary(str(tmp_path / tag))
    if ckpt_dir is not None:
        opt.set_checkpoint(ckpt_dir, ckpt_trigger)
    if watchdog is not None:
        opt.watchdog = watchdog
    opt.optimize()
    return opt


def run_jax(tmp_path, tag, k, end_when, init, dataset=None, ckpt_dir=None,
            ckpt_trigger=None, watchdog=None):
    JEngine.reset()
    jinit_engine(data=1)
    JEngine.get().config.failure_retry_interval_s = 0.05
    try:
        ds = dataset if dataset is not None else JArrayDataSet(X, Y)
        opt = joptim.Optimizer(mlp(jnn), ds, jnn.ClassNLLCriterion(),
                               batch_size=32, seed=11)
        opt.steps_per_call = k
        opt.set_optim_method(joptim.SGD(learning_rate=0.1, momentum=0.9))
        opt.set_end_when(end_when).set_initial_variables(init)
        opt.set_train_summary(str(tmp_path / tag))
        if ckpt_dir is not None:
            opt.set_checkpoint(ckpt_dir, ckpt_trigger)
        if watchdog is not None:
            opt.watchdog = watchdog
        opt.optimize()
        return opt
    finally:
        JEngine.reset()


def curve(opt):
    """The loss of each step as the summary last wrote it (a rewound
    step is written again)."""
    return dict(opt._train_summary.read_scalar("loss"))


@pytest.fixture(scope="module")
def jax_curve(tmp_path_factory, init):
    """The JAX driver's 20 steps (two epochs) at K = 1, which the JAX
    spec holds byte-identical to its K = 4."""
    opt = run_jax(tmp_path_factory.mktemp("jax"), "ref", 1,
                  joptim.Trigger.max_epoch(2), init)
    return curve(opt)


def assert_jax_close(got, want, steps):
    np.testing.assert_allclose([got[s] for s in steps],
                               [want[s] for s in steps], rtol=0, atol=ATOL)


def test_k4_byte_identical_to_k1_including_remainder(tmp_path, init,
                                                     jax_curve):
    """10 steps an epoch at K = 4 run as 4 + 4 + 2, over 2 epochs: the
    curves are the same floats, and within 1e-5 of the JAX driver's."""
    end = optim.Trigger.max_epoch(2)
    k1 = run_port(tmp_path, "k1", 1, end, init)
    k4 = run_port(tmp_path, "k4", 4, end, init)
    c1, c4 = curve(k1), curve(k4)
    assert len(c1) == 20 and c1 == c4
    assert k4.losses == k1.losses and len(k4.losses) == 20
    assert k4.final_state["iteration"] == 20
    assert k4.metrics.summary()["train.bundle_size"] == 2  # the tail
    assert_jax_close(c4, jax_curve, range(1, 21))


@pytest.mark.parametrize("k,every", [(4, 6), (8, 4)])
def test_trigger_edges_clamp_bundles_exactly(tmp_path, init, jax_curve, k,
                                             every):
    """Iteration triggers land on their exact step: ``several_iteration
    (6)`` under K = 4 (6 is off the grid of 4) and ``several_iteration(4)``
    under K = 8 checkpoint at their own iterations, ``max_iteration(14)``
    stops at 14, and the curve is K = 1's."""
    d = str(tmp_path / "ck")
    opt = run_port(tmp_path, "clamped", k, optim.Trigger.max_iteration(14),
                   init, ckpt_dir=d,
                   ckpt_trigger=optim.Trigger.several_iteration(every))
    assert opt.final_state["iteration"] == 14
    names = sorted(p for p in os.listdir(d) if p.startswith("ckpt-"))
    assert names == sorted(f"ckpt-{i}" for i in range(every, 15, every))
    ref = run_port(tmp_path, "clamped-ref", 1,
                   optim.Trigger.max_iteration(14), init)
    assert curve(opt) == curve(ref)
    assert_jax_close(curve(opt), jax_curve, range(1, 15))


@pytest.mark.parametrize("ckpt_every", [4, 6])
def test_mid_epoch_resume_on_and_off_grid(tmp_path, init, jax_curve,
                                          ckpt_every):
    """A resume from a mid-epoch checkpoint on the grid of 4 and off it:
    the first bundle after it shortens to re-align, and the resumed steps
    are K = 1's to the bit and the JAX driver's within 1e-5."""
    ref = run_port(tmp_path, "ref", 1, optim.Trigger.max_iteration(16), init)
    d = str(tmp_path / "ck")
    trig = optim.Trigger.several_iteration(ckpt_every)
    run_port(tmp_path, "a", 4, optim.Trigger.max_iteration(ckpt_every + 1),
             init, ckpt_dir=d, ckpt_trigger=trig)
    assert ckpt_mod.latest_checkpoint(d).endswith(f"ckpt-{ckpt_every}")
    resumed = run_port(tmp_path, "b", 4, optim.Trigger.max_iteration(16),
                       init, ckpt_dir=d, ckpt_trigger=trig)
    assert resumed.final_state["iteration"] == 16
    got, want = curve(resumed), curve(ref)
    steps = range(ckpt_every + 1, 17)
    assert [got[s] for s in steps] == [want[s] for s in steps]
    assert_jax_close(got, jax_curve, steps)


def test_bundle_sizes_follow_the_epoch_grid(tmp_path, init, monkeypatch):
    """Over 3 epochs at K = 4 the bundles are 4, 4 and the 2-step epoch
    tail, every epoch (the JAX cache holds one program per size, {4, 2};
    the port replays one graph per batch signature, which the card test
    holds)."""
    sizes = []
    real = TrainStep.train_bundle

    def spy(self, step0, xs, ys):
        sizes.append(len(xs))
        return real(self, step0, xs, ys)

    monkeypatch.setattr(TrainStep, "train_bundle", spy)
    run_port(tmp_path, "sizes", 4, optim.Trigger.max_epoch(3), init)
    assert sizes == [4, 4, 2] * 3


@pytest.mark.parametrize("bad", ["fast", 0, 2.5])
def test_invalid_steps_per_call_rejected(tmp_path, init, bad):
    with pytest.raises(ValueError, match="steps_per_call"):
        run_port(tmp_path, "bad", bad, optim.Trigger.max_epoch(1), init)


def test_auto_mode_picks_after_first_window(tmp_path, init):
    """``"auto"`` starts at 1, picks K in [1, 32] after its first timed
    window, and the curve stays K = 1's to the bit."""
    opt = run_port(tmp_path, "auto", "auto", optim.Trigger.max_epoch(3),
                   init)
    assert opt._bundle_picked and 1 <= opt._bundle_k <= 32
    assert opt.final_state["iteration"] == 30
    ref = run_port(tmp_path, "auto-ref", 1, optim.Trigger.max_epoch(3),
                   init)
    assert curve(opt) == curve(ref)


def test_env_and_config_wiring(monkeypatch, tmp_path, init):
    """``BIGDL_TPU_STEPS_PER_CALL`` (an int, ``auto``, anything else a
    ValueError) and the other variables of ``from_env``; the Optimizer
    inherits ``steps_per_call`` from the engine; the fields of later
    ROADMAP items refuse any value but their default."""
    monkeypatch.setenv("BIGDL_TPU_STEPS_PER_CALL", "8")
    assert EngineConfig.from_env().steps_per_call == 8
    monkeypatch.setenv("BIGDL_TPU_STEPS_PER_CALL", "auto")
    assert EngineConfig.from_env().steps_per_call == "auto"
    monkeypatch.setenv("BIGDL_TPU_STEPS_PER_CALL", "fast")
    with pytest.raises(ValueError):
        EngineConfig.from_env()
    monkeypatch.setenv("BIGDL_TPU_STEPS_PER_CALL", "4")
    monkeypatch.setenv("BIGDL_TPU_RETRY_TIMES", "7")
    monkeypatch.setenv("BIGDL_TPU_DATA_WORKERS", "3")
    monkeypatch.setenv("BIGDL_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    cfg = EngineConfig.from_env()
    assert (cfg.failure_retry_times, cfg.data_workers, cfg.profile_dir) \
        == (7, 3, str(tmp_path / "prof"))
    Engine.reset()
    opt = run_port(tmp_path, "env", None, optim.Trigger.max_iteration(6),
                   init)
    assert opt._bundle_k == 4
    assert opt.metrics.summary()["train.bundle_size"] == 2  # 4 + 2
    # EngineConfig.profile_dir armed the profiler (window from 10: the
    # run ended before it opened)
    assert opt._profiler is not None and opt._profiler.path is None
    # compute_dtype is accepted and read nowhere, as in the JAX package
    # (ROADMAP C.15): the device and tensor.policy decide
    from bigdl_tpu.runtime.engine import EngineConfig as JEngineConfig
    from bigdl_tpu_torch.tensor.policy import get_compute_dtype
    assert EngineConfig().compute_dtype == JEngineConfig().compute_dtype \
        == "bfloat16"
    for value in ("bfloat16", "float32"):
        Engine(EngineConfig(compute_dtype=value))
        assert get_compute_dtype(torch.device("cpu")) == torch.float32
        assert get_compute_dtype(torch.device("cuda")) == torch.bfloat16
    with pytest.raises(ValueError, match="param_dtype"):
        Engine(EngineConfig(param_dtype="bfloat16"))
    # the multi-process fields are ported (tests/test_torch_port_zero1.py),
    # and so are the metrics endpoint and the peak-FLOPs pin (the live
    # train.mfu's denominator, tests/test_torch_port_cost.py); a bad wire
    # and mesh axes beyond data and seq still raise, naming what they need
    assert Engine(EngineConfig(grad_comm="INT8")).config.grad_comm == "int8"
    assert Engine(EngineConfig(peak_flops=1e15)).config.peak_flops == 1e15
    served = Engine(EngineConfig(metrics_port=0))
    assert served.metrics_server.url.endswith("/metrics")
    served.metrics_server.stop()
    for field, value, item in (("grad_comm", "int4", "grad_comm"),
                               ("mesh", {"model": 2}, "A.6.6")):
        with pytest.raises(ValueError, match=item):
            Engine(EngineConfig(**{field: value}))


def test_poisoned_bundle_rewinds_to_bundle_start_snapshot(tmp_path, init):
    """A NaN inside bundle [4, 8) trips the watchdog before the
    checkpoint at 8 is written; the retry loop restores ckpt-4 and
    replays.  The port and the JAX driver count the same recovery and
    cause and end at the same iteration, and the steps after the rewind
    are the clean K = 1 run's (the port's to the bit, the JAX driver's
    within 1e-5)."""
    Engine.get().config.failure_retry_interval_s = 0.05
    runs = {}
    for pkg, run, data, trig, wd in (
            ("port", run_port, DataSet.array(X, Y), optim.Trigger,
             StepWatchdog),
            ("jax", run_jax, JArrayDataSet(X, Y), joptim.Trigger,
             JStepWatchdog)):
        _PoisonOnce.fired = False
        runs[pkg] = run(tmp_path, f"poisoned-{pkg}", 4,
                        trig.max_iteration(12), init,
                        dataset=_PoisonOnce(data),
                        ckpt_dir=str(tmp_path / f"ck-{pkg}"),
                        ckpt_trigger=trig.several_iteration(4),
                        watchdog=wd(nan_patience=1))
        assert _PoisonOnce.fired
    for opt in runs.values():
        assert opt.metrics.counter("recoveries_total") == 1
        assert opt.metrics.counter("retries_by_cause.poisoned_batch") == 1
        assert opt.final_state["iteration"] == 12
    ref = run_port(tmp_path, "poisoned-ref", 1,
                   optim.Trigger.max_iteration(12), init)
    got, want = curve(runs["port"]), curve(ref)
    assert [got[s] for s in range(9, 13)] == [want[s] for s in range(9, 13)]
    assert_jax_close(got, curve(runs["jax"]), range(9, 13))


def test_fault_injection_fires_inside_bundle_range(tmp_path, init):
    """``step_fail@5`` fires at step 5 though the host sees only the
    edges 0, 4, 8; both drivers recover once from ckpt-4 and reach 12,
    the port's curve within 1e-5 of the JAX driver's."""
    Engine.get().config.failure_retry_interval_s = 0.05
    inj = faults.install(faults.parse_plan("step_fail@5"))
    port = run_port(tmp_path, "inject", 4, optim.Trigger.max_iteration(12),
                    init, ckpt_dir=str(tmp_path / "ck"),
                    ckpt_trigger=optim.Trigger.several_iteration(4))
    faults.clear()
    jinj = jfaults.install(jfaults.parse_plan("step_fail@5"))
    try:
        jx = run_jax(tmp_path, "inject-jax", 4,
                     joptim.Trigger.max_iteration(12), init,
                     ckpt_dir=str(tmp_path / "ck-jax"),
                     ckpt_trigger=joptim.Trigger.several_iteration(4))
    finally:
        jfaults.clear()
    assert ("step_fail", 5, 5) in inj.events
    assert inj.events == jinj.events
    for opt in (port, jx):
        assert opt.metrics.counter("recoveries_total") == 1
        assert opt.metrics.counter("retries_by_cause.step_failure") == 1
        assert opt.final_state["iteration"] == 12
    assert_jax_close(curve(port), curve(jx), range(1, 13))


def test_watchdog_sees_every_step_of_a_bundle(tmp_path, init):
    """One loss per step, in order, not one per bundle."""
    seen = []

    class Spy(StepWatchdog):
        def observe_loss(self, step, loss):
            seen.append(step)
            super().observe_loss(step, loss)

    run_port(tmp_path, "spy", 4, optim.Trigger.max_iteration(10), init,
             watchdog=Spy(nan_patience=3))
    assert seen == list(range(10))


def test_restore_after_retry_rebinds_nothing(tmp_path, init, monkeypatch):
    """The retry loop's restore copies into the tensors a captured graph
    holds: every parameter, optimizer slot and buffer keeps its storage
    (``data_ptr``) across the restore."""
    ptrs = []
    real = TrainStep.restore

    def tensors(step):
        out = list(step.params) + [b for _, b in step._buffers()]
        for val in step.opt_state.values():
            out += [val] if isinstance(val, torch.Tensor) else list(val)
        return out + (step.ema or [])

    def spy(self, *a, **kw):
        before = [t.data_ptr() for t in tensors(self)]
        real(self, *a, **kw)
        ptrs.append((before, [t.data_ptr() for t in tensors(self)]))

    monkeypatch.setattr(TrainStep, "restore", spy)
    Engine.get().config.failure_retry_interval_s = 0.0
    faults.install(faults.parse_plan("step_fail@6"))
    model = nn.Sequential([nn.Linear(12, 32), nn.BatchNorm(32), nn.ReLU(),
                           nn.Linear(32, 3), nn.LogSoftMax()])
    opt = optim.Optimizer(model, DataSet.array(X, Y),
                          nn.ClassNLLCriterion(), batch_size=32, seed=11,
                          device=CPU)
    opt.steps_per_call = 4
    opt.ema_decay = 0.9
    opt.set_optim_method(optim.Adam(learning_rate=1e-2))
    opt.set_end_when(optim.Trigger.max_iteration(10))
    opt.set_checkpoint(str(tmp_path / "ck"),
                       optim.Trigger.several_iteration(4))
    opt.optimize()
    assert opt.metrics.counter("recoveries_total") == 1
    (before, after), = ptrs
    assert len(before) > 10 and before == after


# ---------------------------------------------------------------------------
# the step's values as device tensors: every method and schedule

def _schedules():
    seq = (schedules.SequentialSchedule().add(schedules.Warmup(0.01), 3)
           .add(schedules.Step(2, 0.5), 10 ** 6))
    return {
        "Default": schedules.Default(0.1),
        "Step": schedules.Step(2, 0.5),
        "MultiStep": schedules.MultiStep([2, 4], 0.3),
        "Exponential": schedules.Exponential(3, 0.7, stair_case=True),
        "NaturalExp": schedules.NaturalExp(2, 0.4),
        "Poly": schedules.Poly(0.5, 7),
        "EpochStep": schedules.EpochStep(1, 0.5, steps_per_epoch=2),
        "EpochDecay": schedules.EpochDecay(lambda e: e / 3, 2),
        "EpochSchedule": schedules.EpochSchedule(
            [(1, 1, 0.05), (2, 4, 0.02)], steps_per_epoch=2),
        "Cosine": schedules.Cosine(5, alpha=0.1),
        "Warmup": schedules.Warmup(0.003),
        "SequentialSchedule": seq,
        "Plateau": schedules.Plateau(factor=0.5, patience=1),
    }


def _methods():
    out = {f"SGD+{n}": optim.SGD(learning_rate=0.05, momentum=0.9,
                                 learning_rate_schedule=s)
           for n, s in _schedules().items()}
    out.update({
        "SGD-nesterov-wd": optim.SGD(learning_rate=0.05, momentum=0.9,
                                     nesterov=True, weight_decay=1e-3),
        "Adam": optim.Adam(learning_rate=1e-2,
                           learning_rate_schedule=schedules.Step(2, 0.5)),
        "AdamWeightDecay": optim.AdamWeightDecay(
            learning_rate=1e-2, warmup_portion=0.3, total=6),
        "Adagrad": optim.Adagrad(learning_rate=1e-2,
                                 learning_rate_decay=0.1),
        "RMSprop": optim.RMSprop(learning_rate=1e-2,
                                 learning_rate_decay=0.1),
        "Adadelta": optim.Adadelta(),
        "Adamax": optim.Adamax(),
        "Ftrl": optim.Ftrl(l1_regularization_strength=0.01),
        "LarsSGD": optim.LarsSGD(
            learning_rate_schedule=schedules.Poly(1.0, 8)),
        "LBFGS": optim.LBFGS(learning_rate=0.5, history_size=3),
    })
    return out


@pytest.mark.parametrize("name", sorted(_methods()))
def test_device_scalars_update_equals_python_floats(name):
    """Six steps of each method through ``update`` (the step's values
    written into device tensors) and through ``apply`` fed the same
    values as Python floats, as the updates read them before: the same
    parameters and slots, to the bit."""
    rs = np.random.RandomState(5)
    shapes = [(7, 5), (5,), (3, 2, 2)]
    init = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    runs = []
    for by_tensor in (True, False):
        m = _methods()[name]
        params = [torch.tensor(a) for a in init]
        state = m.init_state(params)
        for step, g in enumerate(grads):
            gt = [torch.tensor(a) for a in g]
            if by_tensor:
                m.update(step, gt, params, state)
            else:
                m.apply(m.scalars(step), gt, params, state)
        slots = [t for v in state.values()
                 for t in ([v] if isinstance(v, torch.Tensor) else v)]
        runs.append([t.clone() for t in params + slots])
    for a, b in zip(*runs):
        assert torch.equal(a, b), name


def test_plateau_drop_reaches_the_next_bundled_step(init):
    """Plateau fed by every-epoch validation (4 steps an epoch): at K = 4
    the factor drops after epochs 2 and 3 and every step's rate is the
    one K = 1 reads (the drop reaches the first step after it, unlike the
    JAX bundle's baked rate, C.11); the losses are K = 1's to the bit."""
    x, y = synthetic(n=128, d=12, classes=3, seed=2)

    class Recording(optim.Plateau):
        def __call__(self, lr, step):
            out = super().__call__(lr, step)
            self.seen.append((step, out))
            return out

    runs = []
    for k in (1, 4):
        sched = Recording(factor=0.5, patience=1, mode="min", epsilon=10.0)
        sched.seen = []
        opt = optim.Optimizer(mlp(nn), DataSet.array(x, y),
                              nn.ClassNLLCriterion(), batch_size=32, seed=3,
                              device=CPU)
        opt.steps_per_call = k
        opt.set_optim_method(optim.SGD(learning_rate=0.1,
                                       learning_rate_schedule=sched))
        opt.set_end_when(optim.Trigger.max_epoch(3))
        opt.set_initial_variables(init)
        opt.set_validation(optim.Trigger.every_epoch(), DataSet.array(x, y),
                           [optim.Loss(nn.ClassNLLCriterion())])
        opt.optimize()
        runs.append((sched, opt.losses))
    (s1, l1), (s4, l4) = runs
    assert s1.current_factor == s4.current_factor == 0.25
    assert s4.seen == s1.seen == [(i, 0.1 if i < 8 else 0.05)
                                  for i in range(12)]
    assert l4 == l1 and len(l4) == 12


def test_captured_launches_pauses_the_collector():
    """Inside ``captured_launches`` (around every capture: the step
    bundles' and the decode engine's) Python's cyclic collector is off,
    so no collection can free a dropped graph's pool during a capture;
    it is back on after, also when the capture raises, and stays off
    when it was off before.  The launches counted inside come back in
    the Counter, and ``LAUNCHES`` is as it was."""
    import gc

    from bigdl_tpu_torch.ops.common import LAUNCHES, captured_launches

    assert gc.isenabled()
    LAUNCHES["k"] += 1
    with captured_launches() as got:
        assert not gc.isenabled()
        LAUNCHES["k"] += 2
    assert gc.isenabled() and got == {"k": 2} and LAUNCHES["k"] == 1
    with pytest.raises(RuntimeError):
        with captured_launches():
            raise RuntimeError("capture failed")
    assert gc.isenabled()
    gc.disable()
    try:
        with captured_launches():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()
    del LAUNCHES["k"]
