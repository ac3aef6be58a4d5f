"""Layers of the port's transformer (counterpart: ``src/repro/models/layers/``)."""
