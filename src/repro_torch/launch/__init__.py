"""Command-line launchers of the port (counterpart: ``src/repro/launch/``)."""
