"""Core of the port (counterpart: ``src/repro/core/``): the numeric table,
the emulated distributed runner, interfaces, optimizers and algorithms."""
