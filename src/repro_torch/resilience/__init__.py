"""repro_torch.resilience — failure containment for the streaming engine
(the port of ``repro.resilience``):

* :mod:`.checkpoint` — versioned, atomic ``StreamDPC.save``/``restore``
  in the reference's file format, onto any shard count;
* :mod:`.sanitize` — admission control (``reject`` | ``drop`` |
  ``clamp``) and the :func:`finite_or` guard;
* :mod:`.faultinject` — deterministic named-site fault injection for the
  chaos tests.

``degrade`` (the plan-time backend chain) waits for the port's reference
backend (ROADMAP Queue A items 1 and 7).
"""
from repro_torch.resilience import checkpoint, faultinject, sanitize
from repro_torch.resilience.checkpoint import (CheckpointError,
                                               restore_stream, save_stream)
from repro_torch.resilience.faultinject import (KILL_EXIT_CODE, KNOWN_SITES,
                                                FaultError, activate,
                                                deactivate, fire)
from repro_torch.resilience.sanitize import (AdmissionConfig,
                                             AdmissionResult,
                                             PoisonedInputError, admit,
                                             finite_or)

__all__ = [
    "AdmissionConfig", "AdmissionResult", "CheckpointError", "FaultError",
    "KILL_EXIT_CODE", "KNOWN_SITES", "PoisonedInputError", "activate",
    "admit", "checkpoint", "deactivate", "faultinject", "finite_or", "fire",
    "restore_stream", "sanitize", "save_stream",
]
