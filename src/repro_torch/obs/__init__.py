"""repro_torch.obs — phase spans and counters (leaf package: torch + stdlib).

``configure(level=...)`` selects ``"off"`` (default, zero overhead),
``"metrics"`` (host wall-time spans) or ``"trace"`` (spans fenced with
``torch.cuda.synchronize()``).  The level changes what is measured, never
what is computed.
"""
from . import metrics, tracer
from .metrics import counter
from .metrics import reset as reset_metrics
from .tracer import LEVELS, NULL_SPAN, configure, reset_spans, span, spans

__all__ = ["LEVELS", "NULL_SPAN", "configure", "span", "spans",
           "reset_spans", "counter", "reset_metrics", "metrics", "tracer"]
