"""ExecSpec: one execution plan for every DPC subsystem.

The port of ``repro/engine/spec.py``: the *how-to-execute* axes

    backend x layout x precision x block x data_axis

validated eagerly at construction and resolved once by
:func:`repro_torch.engine.planner.plan`.  Names and values are the
reference's, so a spec carries across (``repro_torch.carry``).
``precision="bf16"`` runs the fused sweep's bf16 kernels on the ``cuda``
backend; the ``torch`` reference backend refuses it.  ``block`` caps the
stencil route's row chunks (the CUDA kernels' row tile is fixed);
``data_axis`` names the axis of the shard mesh the distributed phases run
over.  The legacy ``merge_legacy`` shims are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from repro_torch.kernels.backend import available_backends
from repro_torch.kernels.ops import PRECISIONS

__all__ = ["ExecSpec", "LAYOUTS", "PRECISIONS"]

LAYOUTS = ("dense", "block-sparse")


@dataclass(frozen=True)
class ExecSpec:
    """The execution axes.

    * ``backend`` — kernel backend name: ``"cuda"`` (the kernels) or
      ``"torch"`` (the direct-difference reference math, no kernel);
      ``None``/``"auto"`` selects the default, ``"cuda"``.
    * ``layout`` — ``"dense"`` (default) or ``"block-sparse"``.
    * ``precision`` — ``"f32"`` (default) or ``"bf16"`` (``cuda`` only).
    * ``block`` — caps the rows evaluated together by the stencil route
      (``None``: no cap, the pair budget alone sizes each chunk); results
      do not depend on it.
    * ``data_axis`` — mesh axis name for the sharded paths.

    Frozen and hashable, so it keys the plan cache.
    """

    backend: str | None = None
    layout: str | None = None
    precision: str | None = None
    block: int | None = None
    data_axis: str = "data"

    def __post_init__(self):
        if self.backend not in (None, "auto") \
                and self.backend not in available_backends():
            raise ValueError(
                f"unknown kernel backend {self.backend!r}; available: "
                f"{available_backends()} (or None/'auto' for the default)")
        if self.layout not in (None, *LAYOUTS):
            raise ValueError(f"unknown layout {self.layout!r}; "
                             f"expected one of {LAYOUTS}")
        if self.precision not in (None, *PRECISIONS):
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"expected one of {PRECISIONS}")
        if self.precision == "bf16" and self.backend == "torch":
            raise ValueError(
                "precision='bf16' needs the cuda backend: the torch backend "
                "is the f32 direct-difference reference")
        if self.block is not None and (not isinstance(self.block, int)
                                       or self.block < 1):
            raise ValueError(f"block must be a positive int or None, "
                             f"got {self.block!r}")
        if not self.data_axis or not isinstance(self.data_axis, str):
            raise ValueError(f"data_axis must be a non-empty mesh-axis "
                             f"name, got {self.data_axis!r}")

    @property
    def sparse(self) -> bool:
        return self.layout == "block-sparse"

    @property
    def resolved_layout(self) -> str:
        return self.layout or "dense"

    @property
    def resolved_precision(self) -> str:
        return self.precision or "f32"

    @classmethod
    def parse(cls, text: str, **overrides) -> "ExecSpec":
        """Build a spec from the CLI form ``backend:layout:precision``
        (trailing segments optional; empty / ``-`` / ``auto`` segments mean
        default).  A bad segment is named with its axis's valid values."""
        axes = ("backend", "layout", "precision")
        valids = {"backend": tuple(available_backends()),
                  "layout": LAYOUTS, "precision": PRECISIONS}
        parts = (text or "").split(":")
        if len(parts) > 3:
            detail = "; ".join(f"{a}: {', '.join(valids[a])}" for a in axes)
            raise ValueError(
                f"--exec takes at most 3 ':'-separated segments "
                f"(backend:layout:precision), got {len(parts)} in {text!r} "
                f"— valid values per segment: {detail}")
        parts += [""] * (3 - len(parts))
        norm = [None if p in ("", "-", "auto") else p for p in parts]
        for pos, (axis, value) in enumerate(zip(axes, norm), start=1):
            if value is None or value in valids[axis]:
                continue
            other = next((a for a in axes
                          if a != axis and value in valids[a]), None)
            hint = (f" ({value!r} is a {other} — segment order is "
                    f"backend:layout:precision)") if other else ""
            raise ValueError(
                f"--exec segment {pos} ({axis}) got {value!r}; valid "
                f"{axis} values: {', '.join(valids[axis])}, or "
                f"empty/'-'/'auto' for the default{hint}")
        return cls(backend=norm[0], layout=norm[1], precision=norm[2],
                   **overrides)

    def replace(self, **kw) -> "ExecSpec":
        return replace(self, **kw)

    def describe(self) -> str:
        return (f"{self.backend or 'auto'}:{self.resolved_layout}:"
                f"{self.resolved_precision}")
