"""Observability — the port of ``bigdl_tpu.obs``: spans (``trace``), the
crash flight recorder (``flight``), the Prometheus exposition
(``export``), declarative SLOs with burn rates (``slo``) and the
log-bucketed histogram (``hist``).  The JAX package's ``attr``, ``cost``
and ``sentinel`` are not ported yet (ROADMAP A.6.7)."""

from bigdl_tpu_torch.obs import flight, slo, trace
from bigdl_tpu_torch.obs.export import (MetricsServer, federate,
                                        parse_exposition, render_prometheus,
                                        sanitize_metric_name)
from bigdl_tpu_torch.obs.flight import FlightRecorder
from bigdl_tpu_torch.obs.hist import LogHistogram
from bigdl_tpu_torch.obs.slo import SLOEvaluator, SLOSpec
from bigdl_tpu_torch.obs.trace import Span, Tracer

__all__ = ["FlightRecorder", "LogHistogram", "MetricsServer", "SLOEvaluator",
           "SLOSpec", "Span", "Tracer", "federate", "flight",
           "parse_exposition", "render_prometheus", "sanitize_metric_name",
           "slo", "trace"]
