"""The shard mesh (the port of ``repro.launch.mesh``'s DPC part)."""
from .mesh import ShardMesh

__all__ = ["ShardMesh"]
