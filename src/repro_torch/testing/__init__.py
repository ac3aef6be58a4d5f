"""Test and chaos support shipped with the port (counterpart:
``src/repro/testing/``): the fault injector drives the chaos tests, the
card smoke's multi-host legs and manual drives of ``launch/fit.py``."""
from repro_torch.testing.chaos import (
    DROP_EXIT_CODE,
    ENV_VAR,
    ChaosInjector,
    Fault,
    faults_to_env,
)

__all__ = ["ChaosInjector", "Fault", "faults_to_env", "ENV_VAR",
           "DROP_EXIT_CODE"]
