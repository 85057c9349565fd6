"""Algorithms, grid index, labels, tuning (the port of ``repro.core``).

The paper's two baselines' runners are exported here, as the reference's
``dpc_api`` imports them; they load on first use, since their modules
import the planner, whose backends import this package's ``dpc_types``.
"""

__all__ = ["run_lsh_ddp", "run_cfsfdp_a"]


def __getattr__(name: str):
    if name == "run_lsh_ddp":
        from .lsh_ddp import run_lsh_ddp
        return run_lsh_ddp
    if name == "run_cfsfdp_a":
        from .cfsfdp_a import run_cfsfdp_a
        return run_cfsfdp_a
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
