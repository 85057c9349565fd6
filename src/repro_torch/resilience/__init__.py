"""Admission control at the fit boundary (the port of ``repro.resilience``)."""
