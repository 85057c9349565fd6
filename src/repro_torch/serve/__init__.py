"""Serving layer: the batched engine (prefill and decode), DPC-KV
compression, and the online-clustering endpoint (re-exported from
``repro_torch.stream``)."""
from repro_torch.stream.service import (QueryResult, QueryStatus,
                                        StreamServeConfig, StreamService)

from .dpc_kv import DPCKVConfig, compress_kv
from .engine import ServeConfig, ServeEngine

__all__ = ["ServeConfig", "ServeEngine", "DPCKVConfig", "compress_kv",
           "StreamService", "StreamServeConfig", "QueryResult",
           "QueryStatus"]
