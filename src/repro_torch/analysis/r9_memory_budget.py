"""R9 memory-budget: the kernels fit the card's memory, provably, at plan
time; the port of ``r9_memory_budget.py``.

Two gates share the budget table (:mod:`.limits`, with R4):

* per kernel launched by a target (a launch rule): every instantiation the
  launch reaches (``r4_launch.instantiations``) keeps its registers within
  255 a thread and 65,536 an SM for its block, its static plus dynamic
  shared memory within ``REPRO_LIMIT_SMEM_BYTES`` (default: the card's
  opt-in) and its local (spill) bytes within 512 KiB a thread — over
  budget is an **error** (it would fail to launch or crawl on the card long
  after ``plan()`` succeeded).  Launches on the CPU have no attributes and
  pass here (R4 records the skip);
* the canonical run's peak device bytes (a plan rule): the
  ``torch.cuda.max_memory_allocated`` delta over the plan's one canonical
  run (``targets.canonical_run``, which resets the peak statistic for it);
  None, with its reason, on the CPU.  It arms only when ``REPRO_LIMIT_LIVE_BYTES`` is
  set (peaks scale with the caller's data, so a hard default would fail
  legitimate fits).

:func:`plan_memory` builds the ``memory`` block ``DPCPlan.telemetry()``
reports from the same table.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import limits, r4_launch, record
from .rules import Finding, Rule, register_rule

RULE_NAME = "R9-memory-budget"


def _fmt(n: int) -> str:
    return f"{n} B ({n / (1 << 20):.2f} MiB)"


def budget_findings(row: dict, lim: limits.KernelLimits) -> list[str]:
    """One instantiation's overruns of the budget, as messages."""
    name = row["name"]
    msgs = []
    if row["num_regs"] > lim.regs_thread or \
            row["num_regs"] * row["threads"] > lim.regs_sm:
        msgs.append(f"{name}: {row['num_regs']} registers a thread x "
                    f"{row['threads']} threads, past {lim.regs_thread} a "
                    f"thread or {lim.regs_sm} an SM")
    smem = row["static_smem"] + row["dyn_smem"]
    if smem > lim.smem_bytes:
        msgs.append(f"{name}: {row['static_smem']} B static + "
                    f"{row['dyn_smem']} B dynamic shared memory = "
                    f"{_fmt(smem)}, past the budget {_fmt(lim.smem_bytes)} "
                    f"(REPRO_LIMIT_SMEM_BYTES overrides the card's opt-in)")
    if row["local_bytes"] > lim.local_thread_bytes:
        msgs.append(f"{name}: {row['local_bytes']} B of local (spill) "
                    f"memory a thread, past {lim.local_thread_bytes}")
    return msgs


@dataclass(frozen=True)
class MemoryBudgetRule(Rule):
    name: str = RULE_NAME
    description: str = ("every kernel instantiation launched keeps its "
                        "registers, static and dynamic shared memory and "
                        "local bytes within the card's budget table; the "
                        "canonical run's peak device bytes within "
                        "REPRO_LIMIT_LIVE_BYTES when set")
    kind: str = "launch"

    def check_launches(self, target: str, events: Any) -> list[Finding]:
        lim = limits.card_limits()
        out: list[Finding] = []
        seen: set = set()
        for pos, e in enumerate(events):
            if not isinstance(e, record.Launch):
                continue
            table = r4_launch.kernel_table(e.device, e.d)
            for row in r4_launch.instantiations(e, table or []):
                for msg in budget_findings(row, lim):
                    if msg not in seen:
                        seen.add(msg)
                        out.append(Finding(rule=self.name, severity="error",
                                           target=target, message=msg,
                                           where=f"launch[{pos}]"))
        return out


def live_peak(pl: Any) -> tuple[int | None, str]:
    """(peak device bytes of the plan's canonical run, how it was taken),
    or (None, the reason) on the CPU."""
    from .targets import canonical_run

    run = canonical_run(pl)
    return run.peak_bytes, run.peak_how


@dataclass(frozen=True)
class LivePeakRule(Rule):
    name: str = RULE_NAME
    description: str = MemoryBudgetRule.description
    kind: str = "plan"

    def check_plan(self, pl: Any) -> list[Finding]:
        budget = limits.live_budget_bytes()
        if budget is None:
            return []
        from .targets import label_of

        peak, how = live_peak(pl)
        if peak is None:
            return [Finding(rule=self.name, severity="warn",
                            target=label_of(pl),
                            message=f"live-byte gate not applied: {how}",
                            where="<live-bytes>")]
        if peak <= budget:
            return []
        return [Finding(rule=self.name, severity="error",
                        target=label_of(pl),
                        message=(f"the canonical run's peak device bytes "
                                 f"{_fmt(peak)} ({how}) exceed "
                                 f"REPRO_LIMIT_LIVE_BYTES {_fmt(budget)}"),
                        where="<live-bytes>")]


def plan_memory(pl: Any) -> dict:
    """The ``memory`` telemetry block of one plan: each kernel its
    canonical run launched, with its instantiations' registers, shared
    memory, local bytes and occupancy (on the card; on the CPU the launches
    alone, ``attributes`` None), the run's peak device bytes and the
    budgets they are held to.  A canonical target that raised raises
    here."""
    from .rules import AnalysisError
    from .targets import canonical_run

    run = canonical_run(pl)
    if run.failures:
        raise AnalysisError(run.failures)
    kernels: list[dict] = []
    for name, events in run.events.items():
        for e in record.launches(events):
            table = r4_launch.kernel_table(e.device, e.d)
            entry = {"target": name, "kernel": e.kernel, "d": e.d,
                     "rows": e.rows, "device": e.device,
                     "attributes": None}
            if table is not None:
                entry["attributes"] = [
                    {k: row[k] for k in (
                        "name", "threads", "num_regs", "static_smem",
                        "dyn_smem", "local_bytes", "max_dyn_smem",
                        "occupancy")}
                    for row in r4_launch.instantiations(e, table)]
            kernels.append(entry)
    peak, how = live_peak(pl)
    return {
        "kernels": kernels,
        "live_peak_bytes": peak,
        "live_peak_how": how,
        "live_budget_bytes": limits.live_budget_bytes(),
        "limits": limits.card_limits().to_dict(),
    }


register_rule(MemoryBudgetRule())
register_rule(LivePeakRule())
