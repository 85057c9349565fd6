"""ExecSpec, planner and the DPCEngine facade (the port of ``repro.engine``)."""
from .dpc_engine import DPCEngine
from .planner import DPCPlan, PointsSpec, as_plan, plan
from .spec import ExecSpec

__all__ = ["DPCEngine", "DPCPlan", "ExecSpec", "PointsSpec", "as_plan", "plan"]
