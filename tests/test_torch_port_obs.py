"""The port's observability (``bigdl_tpu_torch.obs``: ``trace``,
``flight``, ``export``, ``slo``) against the JAX package.

The trace, flight and export specs of tests/test_obs.py and the
labelled-export, federation and SLO specs of tests/test_slo.py run on
the port's modules: :class:`PortSpecs` loads a JAX spec file with its
``bigdl_tpu`` imports rewritten to ``bigdl_tpu_torch`` and puts the
named specs and the file's fixtures into this module, where pytest
collects them under their JAX names.  Beside them: the port's Prometheus text equals
the JAX package's byte for byte for the same sequence of metric calls,
the SLO evaluator's burn rates and gauges equal JAX's on the same samples
and clock, and ``EngineConfig(metrics_port=, slo_specs=)`` serve
``/metrics`` and run an evaluator."""

import ast
import json
import os
import re
import sys
import time
from urllib import request as urlreq

import numpy as np
import pytest

from bigdl_tpu.obs import export as jexport
from bigdl_tpu.obs import slo as jslo
from bigdl_tpu.optim import metrics as jmetrics
from bigdl_tpu_torch.obs import export, flight, slo, trace
from bigdl_tpu_torch.ops import common
from bigdl_tpu_torch.optim import metrics
from bigdl_tpu_torch.resilience import faults
from bigdl_tpu_torch.runtime import engine as engine_mod

HERE = os.path.dirname(os.path.abspath(__file__))
_JAX_NAME = re.compile(r"\bbigdl_tpu\b(?!_torch)")


class PortSpecs:
    """A JAX spec file of this suite, loaded with every ``bigdl_tpu``
    name rewritten to ``bigdl_tpu_torch`` (lines holding one of
    ``keep`` stay on the JAX package), so its specs run on the port.
    ``patch`` replaces names in the loaded module before any spec runs
    (a fixture helper that builds a JAX model, say).  :meth:`export`
    puts chosen specs and the file's fixtures into a test module, where
    pytest collects them and resolves their fixtures itself."""

    def __init__(self, filename: str, keep=(), patch=None):
        self.path = os.path.join(HERE, filename)
        with open(self.path) as f:
            src = f.read()
        self.tree = ast.parse(src)
        lines = [line if any(k in line for k in keep)
                 else _JAX_NAME.sub("bigdl_tpu_torch", line)
                 for line in src.split("\n")]
        self.ns = {"__name__": "port_" + filename[:-3],
                   "__file__": self.path}
        exec(compile("\n".join(lines), self.path, "exec"), self.ns)
        self.ns.update(patch or {})

    def names(self, first: int, last: int, skip=()):
        """The specs defined on lines [first, last] of the file (a class's
        as ``Class::test``), in file order, less ``skip`` and those
        marked ``slow``."""
        out = []

        def slow(node):
            return any("slow" in ast.unparse(d)
                       for d in getattr(node, "decorator_list", ()))

        for node in self.tree.body:
            if not first <= node.lineno <= last or slow(node):
                continue
            if isinstance(node, ast.FunctionDef) \
                    and node.name.startswith("test_"):
                out.append(node.name)
            elif isinstance(node, ast.ClassDef) \
                    and node.name.startswith("Test"):
                out += [f"{node.name}::{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and m.name.startswith("test_") and not slow(m)]
        return [n for n in out if n not in skip]

    def fixtures(self):
        """The names of the file's module-level fixtures."""
        return [node.name for node in self.tree.body
                if isinstance(node, ast.FunctionDef)
                and any("fixture" in ast.unparse(d)
                        for d in node.decorator_list)]

    def export(self, namespace, *ranges, skip=()) -> None:
        """Put the specs of ``ranges`` (``(first, last)`` line pairs, as
        :meth:`names` takes them; a class whole) and every module-level
        fixture of the file into ``namespace``, a test module's globals,
        with :func:`_port_on_cpu`.  A fixture name the module already
        holds stays the module's (its own fixture goes first); a spec
        name it already holds is an error."""
        namespace.setdefault("_port_on_cpu", _port_on_cpu)
        for name in self.fixtures():
            namespace.setdefault(name, self.ns[name])
        for first, last in ranges:
            for name in self.names(first, last, skip):
                top = name.split("::")[0]
                if namespace.setdefault(top, self.ns[top]) \
                        is not self.ns[top]:
                    raise ValueError(f"{self.path}: spec {top} is taken")


def cpu_default(monkeypatch) -> None:
    """Make ``device=None`` mean the CPU in every loaded port module that
    resolves devices (the JAX specs build models without a device)."""
    orig = common.resolve_device

    def on_cpu(device=None):
        return orig("cpu" if device is None else device)

    for name, mod in list(sys.modules.items()):
        if name.startswith("bigdl_tpu_torch") \
                and getattr(mod, "resolve_device", None) is orig:
            monkeypatch.setattr(mod, "resolve_device", on_cpu)


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    """The specs' models are built without a device: on the CPU here."""
    cpu_default(monkeypatch)


@pytest.fixture(autouse=True)
def _clean_obs():
    faults.clear()
    flight.global_recorder().clear()
    yield
    faults.clear()
    trace.disable()


PortSpecs("test_obs.py").export(globals(), (164, 491), (642, 690))
PortSpecs("test_slo.py").export(globals(), (94, 537))


# ---------------------------------------------------------------------------
# the exposition, byte for byte


def _script(m, clock):
    """One sequence of registry calls: counters, labelled series, timers,
    gauges, histograms, help strings and colliding names."""
    m.inc("serving.requests", 3)
    m.inc('serving.tenant_requests{tenant="a"}', 2)
    m.inc('serving.tenant_requests{tenant="b"}', 5)
    m.add("step_dispatch", 0.25)
    m.add("step_dispatch", 0.35)
    m.gauge("serving.queue_depth", 7.0)
    m.gauge("collide.name", 1.0)
    m.gauge("collide_name", 2.0)
    m.describe("serving.requests", "requests seen")
    for i, v in enumerate((0.0004, 0.002, 0.004, 0.09, 0.4, 2.5, 1e9)):
        clock[0] = 100.0 + i
        m.observe("serving.latency_s", v)
        m.observe('serving.tenant_latency_seconds{tenant="a"}', v / 2)
    m.inc("retries_by_cause.poisoned-batch")
    m.gauge("9lives", float("nan"))


def test_render_prometheus_equals_jax_byte_for_byte(monkeypatch):
    clock = [100.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    texts = []
    for mod, exp in ((metrics, export), (jmetrics, jexport)):
        m = mod.Metrics()
        _script(m, clock)
        texts.append(exp.render_prometheus(m))
    assert texts[0] == texts[1]
    assert "serving_tenant_requests{tenant=\"b\"} 5.0" in texts[0]
    parsed = export.parse_exposition(texts[0])
    assert parsed == jexport.parse_exposition(texts[1])
    # federation of two scrapes: the same merged text in both packages
    parts = [({"worker": "worker-0"}, texts[0]),
             ({"worker": "worker-1"}, texts[0])]
    assert export.federate(parts) == jexport.federate(parts)


def mod_key(m, name):
    """``name{tenant="lm"}`` keyed by the registry's own package."""
    mod = metrics if isinstance(m, metrics.Metrics) else jmetrics
    return mod.label_key(name, tenant="lm")


def test_slo_burn_rates_equal_jax_on_same_samples(monkeypatch):
    """Both evaluators over registries fed the same requests, failures
    and latencies on one fake clock: the same burn rates, gauges and
    ``slo_health`` at every tick."""
    clock = [1000.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    spec = [{"tenant": "lm", "window_s": 60.0,
             "objectives": {"predict_p99_s": 0.05, "ttft_p90_s": 0.04,
                            "availability": 0.99}}]
    sides = []
    for mod, s in ((metrics, slo), (jmetrics, jslo)):
        m = mod.Metrics()
        sides.append((m, s.SLOEvaluator(spec, metrics=m,
                                        clock=lambda: clock[0])))
    rs = np.random.RandomState(0)
    for tick in range(12):
        lat = rs.exponential(0.03, size=20)
        bad = rs.randint(0, 3)
        clock[0] += 5.0
        reads = []
        for m, ev in sides:
            for v in lat:
                m.inc(mod_key(m, "serving.tenant_requests_total"))
                m.observe(mod_key(m, "serving.tenant_latency_seconds"),
                          float(v))
                m.observe(mod_key(m, "serving.tenant_ttft_seconds"),
                          float(v) * 0.7)
            m.inc(mod_key(m, "serving.tenant_failed_total"), bad)
            ev.evaluate()
            reads.append((ev.snapshot(),
                          {k: v for k, v in m.snapshot()["gauges"].items()
                           if k.startswith("slo.")}))
        assert json.dumps(reads[0], sort_keys=True, default=str) == \
            json.dumps(reads[1], sort_keys=True, default=str)
    burns = {o["objective"]: o["burn"] for o in reads[0][0]["objectives"]}
    assert burns["availability"] > 0 and burns["predict_p99_s"] > 0
    assert any(k.startswith("slo.burn") for k in reads[0][1])


# ---------------------------------------------------------------------------
# the engine's endpoint and evaluator


@pytest.fixture
def _engine_reset():
    engine_mod.Engine.reset()
    yield
    eng = engine_mod.Engine._instance
    if eng is not None:
        if eng.metrics_server is not None:
            eng.metrics_server.stop()
        if eng.slo_evaluator is not None:
            eng.slo_evaluator.stop()
    engine_mod.Engine.reset()


def test_engine_config_metrics_port_serves_metrics(_engine_reset):
    eng = engine_mod.init_engine(engine_mod.EngineConfig(metrics_port=0),
                                 device="cpu")
    metrics.global_metrics().inc("obs_port.engine_scrape_total", 2)
    body = urlreq.urlopen(eng.metrics_server.url,
                          timeout=10).read().decode()
    fam = {f["name"]: f for f in export.parse_exposition(body)}
    assert fam["obs_port_engine_scrape_total"]["type"] == "counter"
    assert float(fam["obs_port_engine_scrape_total"]["samples"][0][2]) >= 2


def test_engine_config_slo_specs_start_an_evaluator(_engine_reset,
                                                    monkeypatch):
    spec = [{"tenant": "t0", "objectives": {"availability": 0.9},
             "window_s": 30.0}]
    eng = engine_mod.init_engine(engine_mod.EngineConfig(slo_specs=spec),
                                 device="cpu")
    assert eng.slo_evaluator is not None
    assert [s.tenant for s in eng.slo_evaluator.specs] == ["t0"]
    # the environment's specs, as the JAX EngineConfig.from_env reads them
    monkeypatch.setenv("BIGDL_TPU_SLO_SPECS", json.dumps(spec))
    monkeypatch.setenv("BIGDL_TPU_METRICS_PORT", "0")
    cfg = engine_mod.EngineConfig.from_env()
    assert (cfg.slo_specs, cfg.metrics_port) == (json.dumps(spec), 0)
    # the peak-FLOPs pin is ported: the run's peak, below the environment
    from bigdl_tpu_torch.obs import cost

    cfg = engine_mod.EngineConfig(peak_flops=1e15)
    cfg.check()
    monkeypatch.delenv("BIGDL_TPU_PEAK_FLOPS", raising=False)
    assert cost.peak_flops(cost.device_name("cpu"), cfg.peak_flops) == 1e15
