"""R6 merge-race: every atomic in the CUDA sources names its merge; the
port of ``r6_pallas_race.py`` and, with it, of ``absint.py``'s write
classifier.

The reference's Pallas kernels revisit output blocks across their grid
(many worklist entries share a row tile), which is sound only because
every revisit-path write is an associative merge of the block's old
value; R6 proves it by abstract interpretation of the index maps and the
kernel body's writes.  The port's CUDA kernels write each output from one
thread, or merge through atomics: several blocks or warps of one row
tile, the splits of one piece, the chunks of one row.  An atomic is sound
only where its merge does not depend on the order of arrival — an
integer sum, a maximum, a bitwise OR, a 64-bit ``atomicMin`` on the
``(d2 bits << 32 | index)`` key that makes the lexicographic minimum a
total order — or where it schedules work and holds no data (a work-queue
cursor).  An ``atomicExch`` / ``atomicCAS`` store, or a float
``atomicAdd``, is a lost update or an order-dependent sum.

R6 is a source scan of ``src/repro_torch/kernels/csrc/*.cu``: every call
of ``atomicAdd``, ``atomicSub``, ``atomicMin``, ``atomicMax``,
``atomicInc``, ``atomicDec``, ``atomicAnd``, ``atomicOr``,
``atomicXor``, ``atomicCAS`` or ``atomicExch`` (scoped forms included)
must sit beside an ``// audit-merge:`` line that names the merge and why
its result does not depend on the order of arrival: on its own line, or
in the comment lines above it, reading up through the control headers
(``if``, ``for``, ``else``, ``#pragma``) and the other atomics of its
group.  An unannotated atomic is an error.
"""
from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass

from .rules import Finding, Rule, register_rule

RULE_NAME = "R6-merge-race"
TAG = "audit-merge:"

_ATOMIC = re.compile(r"\batomic(Add|Sub|Min|Max|Inc|Dec|And|Or|Xor|CAS|Exch)"
                     r"(_block|_system)?\s*\(")
_HEADER = re.compile(r"^(if\b|if constexpr\b|for\b|else\b|\}\s*else\b|"
                     r"#pragma\b)")


def _code(line: str) -> str:
    return line.split("//", 1)[0]


def _annotated(lines: list[str], i: int) -> bool:
    """An ``// audit-merge:`` with a reason beside line ``i``."""
    def tagged(line: str) -> bool:
        _, _, tail = line.partition(TAG)
        return TAG in line and bool(tail.strip())

    if tagged(lines[i]):
        return True
    for j in range(i - 1, -1, -1):
        text = lines[j].strip()
        if text.startswith("//"):
            if tagged(text):
                return True
            continue
        if _ATOMIC.search(_code(text)) or _HEADER.match(text):
            continue
        return False
    return False


def scan_source(path: str, rel: str) -> list[Finding]:
    with open(path, encoding="utf-8") as fh:
        lines = fh.read().splitlines()
    findings = []
    for i, line in enumerate(lines):
        m = _ATOMIC.search(_code(line))
        if m is None or _annotated(lines, i):
            continue
        findings.append(Finding(
            rule=RULE_NAME, severity="error", target=rel,
            message=(f"atomic{m.group(1)} with no `// audit-merge:` line "
                     f"beside it — name the merge and why its result does "
                     f"not depend on the order of arrival (an integer sum, "
                     f"a min/max over a total order, a work-queue cursor "
                     f"that holds no data)"),
            where=f"{rel}:{i + 1}"))
    return findings


@dataclass(frozen=True)
class MergeRaceRule(Rule):
    name: str = RULE_NAME
    description: str = ("every atomic in the CUDA sources sits beside an "
                        "// audit-merge: line naming an order-free merge")
    kind: str = "project"

    def check_project(self, repo_root: str) -> list[Finding]:
        pattern = os.path.join(repo_root, "src", "repro_torch", "kernels",
                               "csrc", "*.cu")
        findings: list[Finding] = []
        for path in sorted(glob.glob(pattern)):
            findings.extend(scan_source(path,
                                        os.path.relpath(path, repo_root)))
        return findings


register_rule(MergeRaceRule())
