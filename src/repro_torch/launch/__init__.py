"""Launchers: the shard mesh (the port of ``repro.launch.mesh``'s DPC
part), the training driver ``python -m repro_torch.launch.train``, the
tuned launch settings (``launch.tuned``), and the cost tooling: every
kernel's work and bound (``launch.kernel_cost``), the mesh's collective
traffic (``launch.collective_stats``) and the dry runs of the model cells
and the distributed DPC phases (``python -m repro_torch.launch.dryrun``,
``python -m repro_torch.launch.dryrun_dpc``)."""
from .mesh import ShardMesh

__all__ = ["ShardMesh"]
