"""repro_torch.analysis: the port's static analyzer and plan-time gate, the
counterpart of ``repro.analysis``.

The reference walks traced jaxprs; eager PyTorch has none, so the port's
analyzer reads three things instead: a **launch record** (:mod:`.record`:
the canonical targets run on the reference's 96-point input, and every
kernel wrapper of ``kernels/ops.py`` reports its call in order — the
kernel, the shapes and dtypes, the row padding, the worklist's entries,
the threshold, the device), the **built library's attributes** (on the
card: ``kernels/build.py::kernel_attrs``, one row for each ``__global__``
instantiation of ``csrc/sweep.cu``) and the **source tree**.  The rules:

=====================  =====================================================
R2-check-rep-audit     every function that runs per shard around a
                       ``ShardMesh`` collective carries an
                       ``@audit_check_rep`` annotation (source scan)
R3-precision-flow      every bf16 sweep launch (K12, K13) is followed by
                       the f32 direct-difference resolve (launch record)
R4-launch-legality     worklist rows in whole row tiles, extents inside
                       int32; on the card, every instantiation launched
                       within the card's blocks, grids, shared-memory
                       opt-in and occupancy (launch record + attributes)
R5-spec-coverage       ExecSpec axes x validation x dispatch x tests stay
                       mutually exhaustive
R6-merge-race          every atomic of the CUDA sources sits beside an
                       ``// audit-merge:`` line naming an order-free merge
                       (source scan)
R7-transfer-retrace    the same plan under ``d_cut`` spelled as a float,
                       ``np.float32``, ``np.float64`` or a 0-d tensor gives
                       one f32 ``d2cut`` and one answer; the sweep reports
                       each target's host syncs on the card
R8-determinism         order-dependent sum-like scatters (``index_add_``
                       and kin) sit inside an ``@audit_determinism``
                       function (source scan)
R9-memory-budget       registers, shared memory and local bytes of every
                       instantiation launched within the budget table
                       (``limits``, surfaced in ``DPCPlan.telemetry()``);
                       the canonical run's peak device bytes within
                       ``REPRO_LIMIT_LIVE_BYTES`` when set
=====================  =====================================================

Rules run (a) at plan time — ``repro_torch.engine.planner.plan`` analyzes
each fresh plan's canonical run and the plan itself on the plan's device
(the card wherever one exists); ``REPRO_ANALYSIS=0`` bypasses the raise
but still records findings on the ``analysis_findings_total`` counter —
and (b) in the CLI sweep, ``python -m repro_torch.analysis`` (``--sarif``
emits SARIF 2.1.0; ``baseline.json`` in this package holds expiring
suppression leases).

Parts of the reference with no counterpart here:

* **R1** (``r1_spmd_gather.py``) and ``spmd_gather_safe`` guard a
  jax-0.4.37 XLA CPU SPMD miscompile of sort-derived gathers inside
  multi-partition ``shard_map`` bodies.  The port has no compiler between
  its gathers and the device, and its distributed block-sparse phases are
  already decided by ``distributed/dpc.py::shard_blocksparse_layout``.
* **absint.py**'s affine index-map domain and its VMEM estimator model the
  Pallas grid.  Their roles pass to the launch record, the kernel
  attribute table and R6.

The top level imports nothing of the port (kernel modules import
:mod:`.audit` and :mod:`.record` at definition time); what runs targets
loads lazily via ``__getattr__``.
"""
from __future__ import annotations

from .audit import (CheckRepAudit, DeterminismAudit, all_audits,
                    all_determinism_audits, audit_check_rep,
                    audit_determinism, audit_of, determinism_audit_of)
from .limits import KernelLimits, card_limits
from .rules import (AnalysisError, Finding, Rule, all_rules,
                    analyze_launches, launch_rules, plan_rules,
                    project_rules, register_rule)

__all__ = [
    "AnalysisError", "CheckRepAudit", "DeterminismAudit", "Finding",
    "KernelLimits", "Rule", "card_limits",
    "all_audits", "all_determinism_audits", "all_rules", "analyze_launches",
    "analyze_plan", "audit_check_rep", "audit_determinism", "audit_of",
    "determinism_audit_of", "launch_rules",
    "plan_memory", "plan_rules", "plan_targets", "project_rules",
    "register_rule", "run_sweep", "to_sarif",
]

_LAZY = {
    "analyze_plan": ("targets", "analyze_plan"),
    "plan_targets": ("targets", "plan_targets"),
    "plan_memory": ("r9_memory_budget", "plan_memory"),
    "run_sweep": ("report", "run_sweep"),
    "to_sarif": ("sarif", "to_sarif"),
}


def __getattr__(name: str) -> object:
    if name in _LAZY:
        import importlib

        mod_name, attr = _LAZY[name]
        mod = importlib.import_module(f".{mod_name}", __name__)
        return getattr(mod, attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
