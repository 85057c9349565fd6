"""Synthetic point sets (numpy; the port of ``repro.data.points``)."""
