"""Step-time attribution and the recompile sentinel of the port
(``bigdl_tpu_torch.obs.attr``) against ``bigdl_tpu.obs.attr``.

The attribution's report and table equal JAX's on the same windows; the
components sum to the wall.  The sentinel counts the port's compile
events (the listener registry standing in for ``jax.monitoring``) under
JAX's metric names, exactly as JAX's counts its backend-compile events
fed the same synthetic durations, and flags one only when the run is
steady and outside ``expected_compile``.  In a training run the first
step of a batch signature is expected (a new program) and the driver
goes steady after two windows, so a compile at a later step of a known
signature is flagged.  ``step_time_stats`` equals JAX's;
``host_step_time_stats`` over 2 gloo ranks gathers every rank's value.
No JAX import at module level: the gloo ranks import this module."""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn, optim
from bigdl_tpu_torch.obs import attr, flight
from bigdl_tpu_torch.optim.metrics import Metrics, global_metrics
from test_torch_port_collectives import pools  # noqa: F401 (fixture)


@pytest.fixture(autouse=True)
def _clean():
    flight.global_recorder().clear()
    yield
    attr.recompile_sentinel().mark_warmup()


WINDOWS = [(4, 1.0, 0.2, 0.1, 0.1), (4, 0.8, 0.1, 0.1, 0.0)]


def test_attribution_report_and_table_equal_jax():
    from bigdl_tpu.obs import attr as jattr
    from bigdl_tpu.optim.metrics import Metrics as JMetrics

    m, jm = Metrics(), JMetrics()
    a, ja = attr.StepAttribution(m), jattr.StepAttribution(jm)
    for w in WINDOWS:
        assert a.window(*w) == ja.window(*w)
    rep = a.report()
    assert rep == ja.report() and a.table() == ja.table()
    assert rep["steps"] == 8 and rep["windows"] == 2
    assert sum(c["total_s"] for c in rep["components"].values()) \
        == pytest.approx(rep["wall_s"], rel=1e-9)
    # host timers that overlap the wall: device clamps at 0, as in JAX
    clamp = (2, 0.1, 0.08, 0.05, 0.0)
    assert a.window(*clamp) == ja.window(*clamp)
    assert a.report()["components"]["device"]["total_s"] \
        == pytest.approx(1.2)
    for name in attr.COMPONENTS:
        assert m.hists[f"train.attr.{name}_s"].n == 3
    assert a.window(0, 1.0, 0, 0, 0) == {}


def test_step_time_stats_equal_jax():
    from bigdl_tpu.obs import attr as jattr

    for vals in ([0.10, 0.12, 0.11, 0.19], [0.5], []):
        assert attr.step_time_stats(vals) == jattr.step_time_stats(vals)
    assert attr.host_step_time_stats(0.1) is None


def _gather(rank, world):
    return attr.host_step_time_stats(0.1 + 0.05 * rank)


def test_host_step_time_stats_over_gloo_ranks(pools):
    got = pools(2).run(_gather)
    want = attr.step_time_stats([0.1 + 0.05 * r for r in range(2)])
    assert got == [want, want]
    assert want["skew"] == pytest.approx(0.05) and want["n_hosts"] == 2


def _sentinel_deltas(pkg_attr, metrics, fire):
    sent = pkg_attr.recompile_sentinel()
    sent.mark_warmup()
    keys = ("train.xla_compiles_total", "train.unexpected_recompiles_total")
    base = [metrics.counter(k) for k in keys]
    n0 = (metrics.hists["train.compile_time_s"].n
          if "train.compile_time_s" in metrics.hists else 0)
    fire(0.25)                                   # warmup: counted only
    sent.mark_steady(step=42)
    fire(0.5)                                    # steady: flagged
    with pkg_attr.expected_compile():
        fire(0.75)                               # announced: not flagged
    sent.note_step(43)
    fire(1.0)                                    # flagged at step 43
    sent.mark_warmup()
    fire(1.25)                                   # warmup again
    return ([metrics.counter(k) - b for k, b in zip(keys, base)],
            metrics.hists["train.compile_time_s"].n - n0)


def test_recompile_sentinel_counts_as_jax_does():
    from bigdl_tpu.obs import attr as jattr
    from bigdl_tpu.obs import flight as jflight
    from bigdl_tpu.optim.metrics import global_metrics as jglobal

    jflight.global_recorder().clear()
    want = _sentinel_deltas(
        jattr, jglobal(),
        lambda d: jattr.recompile_sentinel()._on_event(
            jattr.RecompileSentinel.EVENT, d))
    got = _sentinel_deltas(
        attr, global_metrics(),
        lambda d: attr.record_event_duration_secs(attr.COMPILE_EVENT, d,
                                                  kind="cuda_graph_capture"))
    assert got == want == ([5, 2], 5)
    flagged = [e for e in flight.global_recorder().snapshot()
               if e["kind"] == "unexpected_recompile"]
    jflagged = [e for e in jflight.global_recorder().snapshot()
                if e["kind"] == "unexpected_recompile"]
    assert [(e["step"], e["duration_s"]) for e in flagged] \
        == [(e["step"], e["duration_s"]) for e in jflagged] \
        == [(42, 0.5), (43, 1.0)]
    assert flagged[0]["compile_kind"] == "cuda_graph_capture"
    # another event name is not a compile
    before = global_metrics().counter("train.xla_compiles_total")
    attr.record_event_duration_secs("/something/else", 1.0)
    assert global_metrics().counter("train.xla_compiles_total") == before


def test_compile_event_times_its_block_and_a_listener_error_is_contained():
    seen = []
    attr.register_event_duration_secs_listener(
        lambda name, d, **kw: seen.append((name, d, kw)))
    attr.register_event_duration_secs_listener(
        lambda *a, **k: 1 / 0)
    with attr.compile_event("kernel_build"):
        pass
    name, d, kw = seen[-1]
    assert name == attr.COMPILE_EVENT and d >= 0
    assert kw == {"kind": "kernel_build"}


class _Builds(nn.Module):
    """A layer whose forward publishes a compile event at the steps (0
    based) in ``at``, as a kernel build or a capture inside a step
    would."""

    def __init__(self, at):
        super().__init__()
        self.lin = nn.Linear(8, 2)
        self.at, self.calls = set(at), 0

    def forward(self, x):
        if self.training:
            if self.calls in self.at:
                attr.record_event_duration_secs(attr.COMPILE_EVENT, 0.01,
                                                kind="test")
            self.calls += 1
        return self.lin(x)


def _run(model, iters, batch=8, **attrs):
    from bigdl_tpu_torch.data import DataSet
    from bigdl_tpu_torch.runtime import engine as engine_mod

    rs = np.random.RandomState(0)
    x = rs.randn(64, 8).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    engine_mod.Engine.reset()
    engine_mod.init_engine(engine_mod.EngineConfig(), device="cpu")
    try:
        opt = optim.Optimizer(model, DataSet.array(x, y),
                              nn.CrossEntropyCriterion(), batch_size=batch,
                              device="cpu")
        opt.set_end_when(optim.Trigger.max_iteration(iters))
        for k, v in attrs.items():
            setattr(opt, k, v)
        opt.optimize()
    finally:
        engine_mod.Engine.reset()
    return opt


@pytest.mark.parametrize("k", [1, 2])
def test_driver_flags_a_compile_after_steady_only(k):
    """The first step is a new program (expected); steps 1-2 are before
    the driver goes steady (two windows); a compile at step 6 of the
    same signature is unexpected, once, with its flight event; the
    sentinel is back in warmup after the run."""
    g = global_metrics()
    keys = ("train.xla_compiles_total", "train.unexpected_recompiles_total")
    base = [g.counter(key) for key in keys]
    _run(_Builds(at=(0, 1, 6)), iters=8, steps_per_call=k)
    assert [g.counter(key) - b for key, b in zip(keys, base)] == [3, 1]
    evts = [e for e in flight.global_recorder().snapshot()
            if e["kind"] == "unexpected_recompile"]
    assert len(evts) == 1 and evts[0]["compile_kind"] == "test"
    assert not attr.recompile_sentinel().steady


def test_a_new_batch_signature_is_an_expected_program():
    """A first step at a new batch shape (the epoch's short tail) is a
    new program: its compile is expected even after steady."""
    g = global_metrics()
    base = g.counter("train.unexpected_recompiles_total")
    model = _Builds(at=())
    from bigdl_tpu_torch.optim.train_step import TrainStep

    step = TrainStep(model, nn.CrossEntropyCriterion(), optim.SGD(0.1))
    sent = attr.recompile_sentinel()
    x8, y8 = torch.zeros(8, 8), torch.zeros(8, dtype=torch.long)
    step(0, x8, y8)
    sent.mark_steady(1)
    model.at = {1, 2}
    step(1, x8[:4], y8[:4])               # a new signature: expected
    assert g.counter("train.unexpected_recompiles_total") == base
    step(2, x8[:4], y8[:4])               # the same signature again
    assert g.counter("train.unexpected_recompiles_total") == base + 1
