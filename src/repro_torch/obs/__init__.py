"""repro_torch.obs — span tracing, metrics and the report CLI, the port of
``repro.obs`` (a leaf package: torch and the standard library).

* **Span tracer** (:mod:`.tracer`): ``with obs.span("rho") as sp: ...;
  sp.sync(out)`` records nested phase timings, host wall time and fenced
  device time, optionally appended to a JSON-lines trace file.
* **Metrics registry** (:mod:`.metrics`): named counters, gauges and
  histograms with labels; the planner's plan and worklist caches, the
  stream, the resilience layer and the service write here.
* **Report CLI** (``python -m repro_torch.obs report``): the phase-time
  table and the ``repro.obs/1`` snapshot.

``configure(level=...)`` selects ``"off"`` (default, zero overhead),
``"metrics"`` (host wall-time spans) or ``"trace"`` (spans fenced with
``torch.cuda.synchronize()``, JSON-lines emission).  The level changes
what is measured, never what is computed.
"""
from . import metrics, report, tracer
from .metrics import (Counter, Gauge, Histogram, counter, gauge, get_metric,
                      histogram)
from .metrics import reset as reset_metrics
from .metrics import snapshot as metrics_snapshot
from .tracer import (LEVELS, NULL_SPAN, configure, enabled, flush, level,
                     reset_spans, span, spans, tracing)

__all__ = [
    "LEVELS", "NULL_SPAN", "configure", "level", "enabled", "tracing",
    "span", "spans", "reset_spans", "flush",
    "Counter", "Gauge", "Histogram", "counter", "gauge", "histogram",
    "get_metric", "metrics_snapshot", "reset_metrics",
    "metrics", "tracer", "report",
]
