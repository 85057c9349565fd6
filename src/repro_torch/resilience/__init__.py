"""repro_torch.resilience — failure containment for the streaming engine
(the port of ``repro.resilience``):

* :mod:`.checkpoint` — versioned, atomic ``StreamDPC.save``/``restore``
  in the reference's file format, onto any shard count;
* :mod:`.sanitize` — admission control (``reject`` | ``drop`` |
  ``clamp``) and the :func:`finite_or` guard;
* :mod:`.faultinject` — deterministic named-site fault injection for the
  chaos tests;
* :mod:`.degrade` — the plan-time backend probe (K4 launched once on the
  card): a failed probe raises at ``plan()``, never a fallback to the
  plain PyTorch math.
"""
from repro_torch.resilience import checkpoint, degrade, faultinject, sanitize
from repro_torch.resilience.checkpoint import (CheckpointError,
                                               restore_stream, save_stream)
from repro_torch.resilience.degrade import probe_backend, resolve_backend
from repro_torch.resilience.faultinject import (KILL_EXIT_CODE, KNOWN_SITES,
                                                FaultError, activate,
                                                deactivate, fire)
from repro_torch.resilience.sanitize import (AdmissionConfig,
                                             AdmissionResult,
                                             PoisonedInputError, admit,
                                             finite_or)

__all__ = [
    "AdmissionConfig", "AdmissionResult", "CheckpointError",
    "FaultError", "KILL_EXIT_CODE", "KNOWN_SITES",
    "PoisonedInputError", "activate", "admit", "checkpoint", "deactivate",
    "degrade", "faultinject", "finite_or", "fire", "probe_backend",
    "resolve_backend", "restore_stream", "sanitize", "save_stream",
]
