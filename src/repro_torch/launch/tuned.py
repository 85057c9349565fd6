"""Per-(architecture, step kind) tuned launch settings, as data: the port
of ``repro/launch/tuned.py``.

Without ``tuned`` every architecture runs the uniform baseline layout;
with it, the entries below apply.  mamba2-130m's dims (24 heads,
d_model 768) cannot use 16-way tensor parallelism, so its training folds
the model axis into data parallelism, one sequence a device, no
gradient accumulation.  The mesh these settings shape waits for ROADMAP
item 9b.
"""

TUNED: dict[str, dict[str, dict]] = {
    "mamba2-130m": {"train": {"data_only": True, "microbatches": 1}},
}


def launch_kwargs(arch: str, kind: str, tuned: bool) -> dict:
    if not tuned:
        return {}
    return dict(TUNED.get(arch, {}).get(kind, {}))
