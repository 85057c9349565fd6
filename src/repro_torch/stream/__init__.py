"""Streaming DPC (the port of ``repro.stream``).

``StreamDPC`` maintains Approx-DPC state over a fixed-capacity sliding
window with micro-batch ``ingest`` (incremental rho repair through K4/K5,
maxima-only dependent updates through K6, full-rebuild fallback on
capacity overflow, stable cluster ids across ticks).  ``StreamService``
wraps it with buffered submits and read-only queries.
"""
from .incremental import CellOverflow, IncrementalGrid, repair_rho
from .service import (QueryResult, QueryStatus, StreamServeConfig,
                      StreamService)
from .stream_dpc import StreamDPC, StreamDPCConfig, StreamTick
from .window import SlidingWindow

__all__ = ["StreamDPC", "StreamDPCConfig", "StreamTick", "SlidingWindow",
           "IncrementalGrid", "CellOverflow", "repair_rho",
           "StreamService", "StreamServeConfig", "QueryResult",
           "QueryStatus"]
