"""Algorithms, grid index, labels, tuning (the port of ``repro.core``)."""
