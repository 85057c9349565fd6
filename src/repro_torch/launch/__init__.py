"""Launchers: the shard mesh (the port of ``repro.launch.mesh``'s DPC
part), the training driver ``python -m repro_torch.launch.train`` and the
tuned launch settings (``launch.tuned``)."""
from .mesh import ShardMesh

__all__ = ["ShardMesh"]
