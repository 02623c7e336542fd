"""Observability — the port of ``bigdl_tpu.obs``: spans (``trace``), the
crash flight recorder (``flight``), the Prometheus exposition
(``export``), declarative SLOs with burn rates (``slo``), the
log-bucketed histogram (``hist``), step-time attribution with the
recompile sentinel and straggler stats (``attr``), the analytic cost
model and peak table behind the live ``train.mfu`` gauge (``cost``), and
the read-only perf-regression gate (``sentinel``,
``python -m bigdl_tpu_torch.obs.sentinel``)."""

# obs.sentinel is not imported here: it is the `python -m` CLI, and an
# eager package import would trip runpy's double-import warning
from bigdl_tpu_torch.obs import attr, cost, flight, slo, trace
from bigdl_tpu_torch.obs.attr import (RecompileSentinel, StepAttribution,
                                      expected_compile, recompile_sentinel)
from bigdl_tpu_torch.obs.cost import CostReport, forward_costs, peak_flops
from bigdl_tpu_torch.obs.export import (MetricsServer, federate,
                                        parse_exposition, render_prometheus,
                                        sanitize_metric_name)
from bigdl_tpu_torch.obs.flight import FlightRecorder
from bigdl_tpu_torch.obs.hist import LogHistogram
from bigdl_tpu_torch.obs.slo import SLOEvaluator, SLOSpec
from bigdl_tpu_torch.obs.trace import Span, Tracer

__all__ = [
    "trace", "flight", "attr", "cost", "slo", "Tracer", "Span",
    "FlightRecorder", "LogHistogram", "MetricsServer", "render_prometheus",
    "parse_exposition", "federate", "SLOEvaluator", "SLOSpec",
    "sanitize_metric_name", "StepAttribution", "RecompileSentinel",
    "recompile_sentinel", "expected_compile", "CostReport", "forward_costs",
    "peak_flops",
]
