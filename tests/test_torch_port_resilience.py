"""The port's single-process fault tolerance (``bigdl_tpu_torch.
resilience``, the driver's retry loop and preemption) against the specs
of ``tests/test_resilience.py`` and ``tests/test_resume_exact.py``, on
the CPU.

The units (fault plans, backoff, classification, policies, the watchdog)
are held to the JAX package's own objects where both exist: the same
plan fires at the same invocations, the same backoff sequence, the same
cause.  The runs are held to the JAX driver on the same seeded data from
the same initial variables (one data replica, ``init_engine(data=1)``):
a faulted run reaches the fault-free run's iteration with its weights
and the JAX driver's within 1e-5 and the same recovery counters; a
resumed run trains each batch once; a SIGTERM delivered at a step (from
the end trigger, never from a timer: ROADMAP C.10) checkpoints at the
next bundle edge and the restarted run resumes to the uninterrupted
weights."""

import os
import signal

import numpy as np
import pytest
import torch

import jax

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.data.dataset import ArrayDataSet as JArrayDataSet
from bigdl_tpu.resilience import faults as jfaults
from bigdl_tpu.resilience import retry as jretry
from bigdl_tpu.runtime.engine import Engine as JEngine
from bigdl_tpu.runtime.engine import EngineConfig as JEngineConfig
from bigdl_tpu.runtime.engine import init_engine as jinit_engine
from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.data import DataSet
from bigdl_tpu_torch.resilience import faults, retry
from bigdl_tpu_torch.resilience.detector import StepWatchdog
from bigdl_tpu_torch.resilience.faults import (FaultInjector, FaultSpec,
                                               InjectedStepFailure,
                                               InjectedStorageError,
                                               parse_plan)
from bigdl_tpu_torch.resilience.retry import (FailureCause, FailurePolicy,
                                              PoisonedStepError, RetryPolicy,
                                              TopologyChangedError, classify)
from bigdl_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                            init_engine)

CPU = "cpu"
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _clean():
    faults.clear()
    Engine.reset()
    yield
    faults.clear()
    jfaults.clear()
    Engine.reset()
    JEngine.reset()


# ---------------------------------------------------------------------------
# faults: deterministic injection

def _pattern(mod):
    inj = mod.FaultInjector([
        mod.FaultSpec("step_fail", probability=0.3, seed=7, max_fires=100),
        mod.FaultSpec("storage_io_fail", every=5)])
    for i in range(100):
        for point, kw in (("step_fail", {"step": i}),
                          ("storage_io_fail", {})):
            try:
                inj.fire(point, **kw)
            except mod.InjectedFault:
                pass
    return inj.events


def test_fault_plan_is_deterministic():
    """Two injectors over the same plan fire at the same invocations, and
    at the JAX injector's."""
    a, b = _pattern(faults), _pattern(faults)
    assert a == b == _pattern(jfaults)
    assert any(p == "step_fail" for p, _, _ in a)
    assert [c for p, _, c in a if p == "storage_io_fail"] == \
        list(range(4, 100, 5))


def test_fault_at_step_fires_once_by_default():
    inj = FaultInjector([FaultSpec("step_fail", at_step=3)])
    with pytest.raises(InjectedStepFailure):
        inj.fire("step_fail", step=3)
    inj.fire("step_fail", step=3)  # the replayed step: no fire
    assert len(inj.events) == 1


def test_fault_env_plan_parsing(monkeypatch):
    plan = ("step_fail@5; checkpoint_write_fail:p=0.5:seed=2 ;"
            "slow_host@3:delay=0.01;storage_io_fail:every=4:max=2;"
            "fleet_worker_kill:every=6:max=1")
    assert parse_plan(plan) == [FaultSpec(**vars(s))
                                for s in jfaults.parse_plan(plan)]
    by_point = {s.point: s for s in parse_plan(plan)}
    assert by_point["step_fail"].at_step == 5
    assert by_point["step_fail"].max_fires == 1
    assert by_point["checkpoint_write_fail"].probability == 0.5
    assert by_point["checkpoint_write_fail"].seed == 2
    assert by_point["slow_host"].delay_s == 0.01
    assert by_point["slow_host"].action == "sleep"
    assert by_point["storage_io_fail"].every == 4
    assert by_point["storage_io_fail"].max_fires == 2
    assert by_point["fleet_worker_kill"].action == "exit"
    with pytest.raises(ValueError, match="unknown fault point"):
        parse_plan("bogus_point@1")
    with pytest.raises(ValueError, match="unknown fault option"):
        parse_plan("step_fail:frequency=2")
    # the environment's plan is read at the first instrumented call
    faults._injector, faults._env_checked = None, False
    monkeypatch.setenv("BIGDL_TPU_FAULTS", "step_fail@2")
    faults.fire_bundle(0, 2)
    with pytest.raises(InjectedStepFailure):
        faults.fire_bundle(2, 2)
    assert faults.get().events == [("step_fail", 2, 2)]


def test_storage_io_fault_reaches_storage_seam(tmp_path):
    from bigdl_tpu_torch.utils import storage

    faults.install([FaultSpec("storage_io_fail", every=1, max_fires=1)])
    with pytest.raises(InjectedStorageError):
        storage.open_file(str(tmp_path / "x"), "wb")
    with storage.open_file(str(tmp_path / "x"), "wb") as f:
        f.write(b"ok")


# ---------------------------------------------------------------------------
# retry: backoff and classification

def test_backoff_exponential_capped_and_deterministic():
    kw = dict(max_retries=10, base_s=1.0, multiplier=2.0, max_s=8.0,
              jitter=0.25, seed=5)
    p = RetryPolicy(**kw)
    seq = [p.backoff(a) for a in range(1, 8)]
    assert seq == [p.backoff(a) for a in range(1, 8)]
    assert seq == [jretry.RetryPolicy(**kw).backoff(a) for a in range(1, 8)]
    for a, v in enumerate(seq, start=1):
        raw = min(8.0, 2.0 ** (a - 1))
        assert raw * 0.75 <= v <= raw * 1.25
    assert max(seq[4:]) <= 8.0 * 1.25
    assert RetryPolicy(jitter=0.0, base_s=3.0).backoff(1) == 3.0


def test_retry_call_retries_then_raises():
    p = RetryPolicy(max_retries=2, base_s=0.0, jitter=0.0)
    calls = []

    def flaky(fail_times):
        calls.append(1)
        if len(calls) <= fail_times:
            raise OSError("blip")
        return "ok"

    assert p.call(flaky, 2, sleep=lambda s: None) == "ok"
    calls.clear()
    with pytest.raises(OSError):
        p.call(flaky, 99, sleep=lambda s: None)
    assert len(calls) == 3


def test_classify_causes():
    for exc in (OSError("x"), RuntimeError("loss is NaN"),
                RuntimeError("nanosecond info"), ValueError("shape")):
        assert classify(exc).value == jretry.classify(exc).value
    assert classify(OSError("x")) is FailureCause.TRANSIENT_STORAGE
    assert classify(InjectedStorageError("storage_io_fail")) \
        is FailureCause.TRANSIENT_STORAGE
    assert classify(InjectedStepFailure("step_fail")) \
        is FailureCause.STEP_FAILURE
    assert classify(PoisonedStepError("nan")) is FailureCause.POISONED_BATCH
    assert classify(RuntimeError("loss is NaN")) \
        is FailureCause.POISONED_BATCH
    assert classify(TopologyChangedError("2->3")) \
        is FailureCause.TOPOLOGY_CHANGE
    assert classify(faults.ProcessKilledError("process_kill")) \
        is FailureCause.PROCESS_FAILURE
    assert classify(ValueError("shape")) is FailureCause.UNKNOWN
    try:
        raise RuntimeError("async checkpoint writes failed") \
            from OSError("503")
    except RuntimeError as wrapped:
        assert classify(wrapped) is FailureCause.TRANSIENT_STORAGE
    # PyTorch's CUDA errors: out of memory replays into the same wall
    # (XLA's RESOURCE_EXHAUSTED: unknown), a device fault is the step's
    # (XLA's INTERNAL: step failure)
    assert classify(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")) \
        is FailureCause.UNKNOWN
    assert classify(RuntimeError(
        "CUDA error: an illegal memory access was encountered")) \
        is FailureCause.STEP_FAILURE
    assert classify(RuntimeError("cuDNN error: CUDNN_STATUS_EXECUTION_"
                                 "FAILED")) is FailureCause.STEP_FAILURE


def test_failure_policy_per_cause():
    fp = FailurePolicy()
    assert fp.policy_for(FailureCause.TRANSIENT_STORAGE).max_retries > \
        fp.policy_for(FailureCause.POISONED_BATCH).max_retries
    assert fp.policy_for(FailureCause.TOPOLOGY_CHANGE).max_retries == 0
    custom = FailurePolicy(by_cause={
        FailureCause.POISONED_BATCH: RetryPolicy(max_retries=9)})
    assert custom.policy_for(FailureCause.POISONED_BATCH).max_retries == 9
    # the legacy knobs resolve as the JAX engine resolves them
    for kw in ({}, dict(failure_retry_times=2, failure_retry_interval_s=1.5)):
        got = EngineConfig(**kw).resolved_failure_policy()
        want = JEngineConfig(**kw).resolved_failure_policy()
        assert got.max_restarts == want.max_restarts
        for cause in FailureCause:
            a = got.policy_for(cause)
            b = want.policy_for(jretry.FailureCause(cause.value))
            assert (a.max_retries, a.backoff(1), a.backoff(3)) == \
                (b.max_retries, b.backoff(1), b.backoff(3))


# ---------------------------------------------------------------------------
# the watchdog: injected clocks, no sleeps

def test_watchdog_nan_streak_raises_poisoned():
    wd = StepWatchdog(nan_patience=3)
    wd.observe_loss(0, 1.0)
    wd.observe_loss(1, float("nan"))
    wd.observe_loss(2, float("inf"))
    with pytest.raises(PoisonedStepError):
        wd.observe_loss(3, float("nan"))
    wd.observe_loss(4, float("nan"))  # streak reset after raising
    wd.observe_loss(5, 0.5)
    wd.observe_loss(6, float("nan"))


def test_watchdog_hang_detection():
    now = [0.0]
    wd = StepWatchdog(step_timeout_s=10.0, clock=lambda: now[0])
    hangs = []
    wd.on_hang = lambda step, dur: hangs.append((step, dur))
    wd.step_started(4)
    now[0] = 5.0
    assert not wd.check()
    now[0] = 11.0
    assert wd.check() and hangs == [(4, 11.0)]
    assert wd.check()
    assert len(hangs) == 1
    wd.observe_loss(4, 1.0)
    assert not wd.hung()


# ---------------------------------------------------------------------------
# training under injection, and preemption: both drivers

def _linreg():
    rs = np.random.RandomState(0)
    x = rs.rand(64, 4).astype(np.float32)
    y = x @ np.asarray([[1.0], [2.0], [-1.0], [0.5]], np.float32)
    return x, y


LINREG_INIT = {"params": {"weight": np.full((4, 1), 0.1, np.float32),
                          "bias": np.zeros((1,), np.float32)}}


def _fast_policy(pkg, retry_times=3):
    quick = dict(max_retries=retry_times, base_s=0.01, max_s=0.05)
    return pkg.FailurePolicy(
        max_restarts=retry_times, default_retry=pkg.RetryPolicy(**quick),
        by_cause={c: pkg.RetryPolicy(**quick) for c in pkg.FailureCause})


def _linreg_port(ckpt_dir, n_iters, k):
    x, y = _linreg()
    opt = (optim.Optimizer(nn.Linear(4, 1), DataSet.array(x, y),
                           nn.MSECriterion(), batch_size=16, seed=3,
                           device=CPU)
           .set_optim_method(optim.SGD(learning_rate=0.2))
           .set_end_when(optim.Trigger.max_iteration(n_iters))
           .set_initial_variables(LINREG_INIT))
    opt.steps_per_call = k
    opt.set_checkpoint(ckpt_dir, optim.Trigger.several_iteration(2))
    return opt


def _linreg_jax(ckpt_dir, n_iters):
    x, y = _linreg()
    opt = (joptim.Optimizer(jnn.Linear(4, 1), JArrayDataSet(x, y),
                            jnn.MSECriterion(), batch_size=16, seed=3)
           .set_optim_method(joptim.SGD(learning_rate=0.2))
           .set_end_when(joptim.Trigger.max_iteration(n_iters))
           .set_initial_variables(LINREG_INIT))
    opt.set_checkpoint(ckpt_dir, joptim.Trigger.several_iteration(2))
    opt.log_every = 100
    return opt


def _plan(mod):
    return [mod.FaultSpec("step_fail", at_step=5),
            mod.FaultSpec("checkpoint_write_fail", probability=0.5, seed=1,
                          max_fires=2)]


@pytest.mark.parametrize("k", [1, 2])
def test_faulted_run_matches_fault_free(tmp_path, k):
    """``step_fail`` at step 5 and intermittent ``checkpoint_write_fail``:
    the run reaches the fault-free run's iteration with its weights to
    the bit, recovering only from complete checkpoints, and the same
    recovery counters and final weights (within 1e-5) as the JAX
    driver under the same plan."""
    init_engine(EngineConfig(failure_retry_times=3,
                             failure_policy=_fast_policy(retry)))
    clean = _linreg_port(str(tmp_path / "a"), 8, k)
    w_clean = clean.optimize().variables["params"]["weight"]
    inj = faults.install(_plan(faults))
    opt = _linreg_port(str(tmp_path / "b"), 8, k)
    w = opt.optimize().variables["params"]["weight"]
    faults.clear()

    jinit_engine(JEngineConfig(failure_retry_times=3,
                               failure_policy=_fast_policy(jretry)),
                 data=1)
    jinj = jfaults.install(_plan(jfaults))
    jopt = _linreg_jax(str(tmp_path / "c"), 8)
    jw = np.asarray(jopt.optimize().variables["params"]["weight"])

    assert [p for p, _, _ in inj.events].count("step_fail") == 1
    assert any(p == "checkpoint_write_fail" for p, _, _ in inj.events)
    assert clean.final_state["iteration"] == opt.final_state["iteration"] \
        == jopt.final_state["iteration"] == 8
    np.testing.assert_array_equal(w, w_clean)
    np.testing.assert_allclose(w, jw, rtol=0, atol=ATOL)
    by_cause = {key: v for key, v in opt.metrics.counters.items()
                if key.startswith("retries_by_cause.")}
    assert sum(by_cause.values()) == opt.metrics.counter("recoveries_total")
    if k == 1:  # the JAX driver bundles nothing here: the same events
        assert inj.events == jinj.events
        assert by_cause == {key: v for key, v in jopt.metrics.counters.items()
                            if key.startswith("retries_by_cause.")}


def test_run_without_checkpoint_reraises(tmp_path):
    faults.install([FaultSpec("step_fail", at_step=1)])
    x, y = _linreg()
    opt = (optim.Optimizer(nn.Linear(4, 1), DataSet.array(x, y),
                           nn.MSECriterion(), batch_size=16, device=CPU)
           .set_end_when(optim.Trigger.max_iteration(4)))
    with pytest.raises(InjectedStepFailure):
        opt.optimize()


N, D = 80, 4  # 5 batches of 16 an epoch


def _resume_data(n=N):
    rs = np.random.RandomState(0)
    x = rs.randn(n, D).astype(np.float32)
    y = (x @ rs.randn(D, 1)).astype(np.float32)
    return x, y


RESUME_INIT = {"params": {
    "0_Linear": {"weight": np.linspace(-0.5, 0.5, D * 6, dtype=np.float32
                                       ).reshape(D, 6),
                 "bias": np.zeros(6, np.float32)},
    "2_Linear": {"weight": np.linspace(0.3, -0.3, 6, dtype=np.float32
                                       ).reshape(6, 1),
                 "bias": np.zeros(1, np.float32)}}}


class _SigtermOnce:
    """An end trigger that sends the process a real SIGTERM the first
    time the run reaches ``at_iter``: at a step, through the driver's
    own handler (never from a timer)."""

    def __init__(self, inner, at_iter):
        self._inner, self._at, self._fired = inner, at_iter, False
        self.boundary = getattr(inner, "boundary", None)

    def __call__(self, state):
        if not self._fired and state["iteration"] >= self._at:
            self._fired = True
            os.kill(os.getpid(), signal.SIGTERM)
        return self._inner(state)


def _fit(pkg, x, y, n_iters, ckpt_dir=None, sigterm_at=None, k=1,
         preempt=False):
    m = {"port": nn, "jax": jnn}[pkg]
    o = {"port": optim, "jax": joptim}[pkg]
    kw = {"device": CPU} if pkg == "port" else {}
    ds = DataSet.array(x, y) if pkg == "port" else JArrayDataSet(x, y)
    model = m.Sequential([m.Linear(D, 6), m.Tanh(), m.Linear(6, 1)])
    opt = o.Optimizer(model, ds, m.MSECriterion(), batch_size=16, seed=3,
                      **kw)
    opt.set_optim_method(o.SGD(learning_rate=0.1, momentum=0.9))
    end = o.Trigger.max_iteration(n_iters)
    opt.set_end_when(end if sigterm_at is None
                     else _SigtermOnce(end, sigterm_at))
    opt.set_initial_variables(RESUME_INIT)
    opt.steps_per_call = k
    if ckpt_dir is not None:
        every = 100 if preempt else 1
        opt.set_checkpoint(str(ckpt_dir), o.Trigger.several_iteration(every))
    if preempt:
        opt.set_preemption_checkpoint()
    if pkg == "jax":
        opt.log_every = 1000
        JEngine.reset()
        jinit_engine(data=1)
    return opt, opt.optimize()


def _weights(trained):
    return [np.asarray(a) for a in
            jax.tree_util.tree_leaves(trained.variables["params"])]


@pytest.mark.parametrize("first,total", [(3, 8), (5, 7)],
                         ids=["mid_epoch", "epoch_boundary"])
def test_resume_trains_each_batch_exactly_once(tmp_path, first, total):
    """Interrupted at ``first`` (mid-epoch, or exactly one epoch), resumed
    to ``total``: the uninterrupted weights to the bit, and the JAX
    driver's within 1e-5."""
    x, y = _resume_data()
    _, ref = _fit("port", x, y, total)
    _fit("port", x, y, first, ckpt_dir=tmp_path / "ck")
    _, resumed = _fit("port", x, y, total, ckpt_dir=tmp_path / "ck")
    for a, b in zip(_weights(resumed), _weights(ref)):
        np.testing.assert_array_equal(a, b)
    _, jref = _fit("jax", x, y, total)
    for a, b in zip(_weights(resumed), _weights(jref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_sigterm_mid_epoch_checkpoints_next_step_and_resumes_exact(
        tmp_path):
    """SIGTERM at iteration 4 of a K = 2 run (6 batches an epoch): the
    flag is honoured at the next bundle edge with that bundle shortened
    to one step, so the checkpoint lands at 5, not at the next grid edge
    6, as in the JAX driver; the restarted run resumes to the
    uninterrupted weights to the bit (and the JAX driver's within
    1e-5).  The handler is put back after the run."""
    x, y = _resume_data(96)
    before = signal.getsignal(signal.SIGTERM)
    _, ref = _fit("port", x, y, 8, ckpt_dir=tmp_path / "ref", k=2,
                  preempt=True)
    opt1, _ = _fit("port", x, y, 8, ckpt_dir=tmp_path / "ck", sigterm_at=3,
                   k=2, preempt=True)
    assert signal.getsignal(signal.SIGTERM) is before
    assert opt1.final_state["iteration"] == 5
    assert os.path.isdir(tmp_path / "ck" / "ckpt-5")
    jopt1, _ = _fit("jax", x, y, 8, ckpt_dir=tmp_path / "jck", sigterm_at=3,
                    k=2, preempt=True)
    assert jopt1.final_state["iteration"] == 5
    _, resumed = _fit("port", x, y, 8, ckpt_dir=tmp_path / "ck", k=2,
                      preempt=True)
    for a, b in zip(_weights(resumed), _weights(ref)):
        np.testing.assert_array_equal(a, b)
    _, jref = _fit("jax", x, y, 8)
    for a, b in zip(_weights(resumed), _weights(jref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_preemption_needs_a_checkpoint():
    x, y = _resume_data()
    opt = (optim.Optimizer(nn.Linear(D, 1), DataSet.array(x, y),
                           nn.MSECriterion(), batch_size=16, device=CPU)
           .set_preemption_checkpoint())
    with pytest.raises(ValueError, match="set_checkpoint"):
        opt.optimize()


def test_profile_window_writes_a_trace(tmp_path):
    """``set_profile`` over iterations [2, 4) of a bundled run writes one
    Chrome trace holding the steps' ranges."""
    x, y = _resume_data()
    opt = (optim.Optimizer(nn.Linear(D, 1), DataSet.array(x, y),
                           nn.MSECriterion(), batch_size=16, device=CPU)
           .set_end_when(optim.Trigger.max_iteration(8))
           .set_profile(str(tmp_path / "prof"), start_iter=2, num_iters=2))
    opt.steps_per_call = 2
    opt.optimize()
    (name,) = os.listdir(tmp_path / "prof")
    path = tmp_path / "prof" / name
    assert opt._profiler.path == str(path) and opt._profiler.done
    assert "train/bundle" in path.read_text()
