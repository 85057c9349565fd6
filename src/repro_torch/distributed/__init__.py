"""Distributed DPC over a shard mesh (the port of ``repro.distributed``)."""
from .dpc import DistDPCConfig, distributed_dpc

__all__ = ["DistDPCConfig", "distributed_dpc"]
