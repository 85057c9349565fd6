"""R4 launch-legality: static checks on every recorded kernel launch, the
port of ``r4_pallas.py``.

Two halves, both per launch of a target's record (:mod:`.record`):

* **the record's shapes**, on every device — a worklist launch's query
  rows are covered by whole row tiles of the worklist
  (``padded_rows`` a multiple of ``row_tile``, no tile past the last
  row: the pad-to-row-tile contract of the worklist wrappers,
  ``kernels/ops.py::_check_worklist``), and the row, column and
  worklist-entry counts, and the row counts times the dimension, stay
  inside int32 (the kernels index with ``int``);
* **the built library's attributes**, where the launch ran on a CUDA
  device — every ``__global__`` instantiation the wrapper's entry point
  launches at that dimension (``kernels/build.py::kernel_attrs``, the
  table in ``csrc/sweep.cu`` that reads the launch sites' constants) has
  its block within ``maxThreadsPerBlock`` and the card's 1,024, its grid
  within 2^31 - 1 along x and 65,535 along y, static plus dynamic shared
  memory within the card's opt-in, and at least one block resident per
  SM.  On a host with no card the library is not loaded and this half
  records one warn-severity "skipped" finding per target with its reason,
  as the reference does for a target it cannot trace.  On a host with a
  card, a library that cannot be loaded raises, as the backend probe
  does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from . import limits, record
from .rules import Finding, Rule, register_rule

RULE_NAME = "R4-launch-legality"

_INT32_MAX = 2**31 - 1

# (device index, d) -> the attribute table
_TABLES: dict = {}


def kernel_table(device: str, d: int) -> list[dict] | None:
    """The attribute table at dimension ``d`` for launches on ``device``,
    or None where ``device`` is not a CUDA device (no library is loaded
    for the CPU's plain versions).  Cached per device and d."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    index = torch.cuda.current_device() if dev.index is None else dev.index
    rows = _TABLES.get((index, d))
    if rows is None:
        from repro_torch.kernels import build

        with torch.cuda.device(index):
            rows = build.kernel_attrs(d)
        _TABLES[(index, d)] = rows
    return rows


def instantiations(launch: record.Launch, table: list[dict]) -> list[dict]:
    """The table's rows a launch reaches: its wrapper's entry point
    launches them at its dimension."""
    return [r for r in table if launch.kernel in r["launch"]
            and r["d_lo"] <= launch.d <= r["d_hi"]]


def grid_x(launch: record.Launch, row: dict) -> int:
    """Blocks along x: the recorded grid where the wrapper knows it, else
    the query rows over the rows a block covers (1 where the grid does
    not follow the rows)."""
    if launch.grid is not None:
        return launch.grid[0]
    rpb = row["rows_per_block"]
    return -(-launch.rows // rpb) if rpb > 0 else 1


def _shape_findings(e: record.Launch) -> list[str]:
    msgs = []
    if e.row_tile > 1 and (e.padded_rows % e.row_tile
                           or not e.rows <= e.padded_rows
                           < e.rows + e.row_tile):
        msgs.append(f"{e.rows} query rows covered by {e.padded_rows} "
                    f"worklist rows: not whole row tiles of {e.row_tile} "
                    f"ending at the last row (the worklist wrappers' "
                    f"pad-to-row-tile contract)")
    for what, value in (("rows", e.rows), ("columns", e.cols),
                        ("worklist entries", e.entries),
                        ("rows x d", e.rows * e.d),
                        ("columns x d", e.cols * e.d)):
        if value is not None and value > _INT32_MAX:
            msgs.append(f"{what} {value} past int32 (the kernels index "
                        f"with int)")
    return msgs


def _attribute_findings(e: record.Launch, row: dict,
                        lim: limits.KernelLimits) -> list[str]:
    name = row["name"]
    msgs = []
    if row["error"]:
        msgs.append(f"{name}: its attribute query failed with CUDA error "
                    f"{row['error']} (an opt-in of {row['dyn_smem']} B "
                    f"refused?)")
    if row["threads"] > min(row["max_threads"], lim.threads_block):
        msgs.append(f"{name}: {row['threads']} threads a block, past its "
                    f"maxThreadsPerBlock {row['max_threads']} or the card's "
                    f"{lim.threads_block}")
    gx = grid_x(e, row)
    if gx > lim.grid_x or row["grid_y_max"] > lim.grid_yz:
        msgs.append(f"{name}: a grid of {gx} x {row['grid_y_max']} blocks, "
                    f"past the card's {lim.grid_x} x {lim.grid_yz}")
    smem = row["static_smem"] + row["dyn_smem"]
    if smem > lim.smem_optin_bytes:
        msgs.append(f"{name}: {row['static_smem']} B static + "
                    f"{row['dyn_smem']} B dynamic shared memory, past the "
                    f"card's opt-in of {lim.smem_optin_bytes} B")
    if row["occupancy"] < 1:
        msgs.append(f"{name}: no block of {row['threads']} threads and "
                    f"{row['dyn_smem']} B dynamic shared memory fits an SM")
    return msgs


@dataclass(frozen=True)
class LaunchLegalityRule(Rule):
    name: str = RULE_NAME
    description: str = ("recorded launches: worklist rows in whole row "
                        "tiles, extents inside int32; on the card, blocks, "
                        "grids, shared memory and occupancy of every "
                        "instantiation launched within the card's limits")
    kind: str = "launch"

    def check_launches(self, target: str, events: Any) -> list[Finding]:
        lim = limits.card_limits()
        out: list[Finding] = []
        seen: set = set()
        skip = False
        for pos, e in enumerate(events):
            if not isinstance(e, record.Launch):
                continue
            where = f"launch[{pos}]"
            for msg in _shape_findings(e):
                out.append(Finding(rule=self.name, severity="error",
                                   target=target, message=f"{e.kernel}: "
                                   f"{msg}", where=where))
            table = kernel_table(e.device, e.d)
            if table is None:
                skip = True
                continue
            rows = instantiations(e, table)
            if not rows:
                out.append(Finding(
                    rule=self.name, severity="error", target=target,
                    message=(f"{e.kernel}: no instantiation in the kernel "
                             f"attribute table serves d = {e.d} (the "
                             f"table has drifted from the dispatch)"),
                    where=where))
            for row in rows:
                for msg in _attribute_findings(e, row, lim):
                    if msg not in seen:
                        seen.add(msg)
                        out.append(Finding(rule=self.name, severity="error",
                                           target=target, message=msg,
                                           where=where))
        if skip:
            out.append(Finding(
                rule=self.name, severity="warn", target=target,
                message=("kernel attribute checks skipped: the launches "
                         "ran the plain versions on a host with no CUDA "
                         "device, where the kernel library is not loaded; "
                         "the record's shape checks ran"),
                where="<attributes>"))
        return out


register_rule(LaunchLegalityRule())
