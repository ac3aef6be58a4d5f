"""Core of the port (counterpart: ``src/repro/core/``): the schema, the host
and numeric tables, ``LocalMatrix``, the emulated distributed runner,
interfaces, optimizers and algorithms."""
