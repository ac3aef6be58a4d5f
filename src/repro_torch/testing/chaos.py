"""Deterministic fault injection for multi-host chaos tests.

Counterpart: ``src/repro/testing/chaos.py`` (``Fault``, ``ChaosInjector``,
``faults_to_env``, ``ENV_VAR``, ``DROP_EXIT_CODE``), with the reference's
environment variable and exit code, so a fault spec means the same to
either package.

A *fault* is (host, round, action): at the moment the targeted host asks for
the window of the targeted round, the injector

  * ``kill``  — delivers an uncatchable ``SIGKILL`` to the host's own
    process (a preemption: no cleanup, no flush — only what is already
    atomically on disk survives);
  * ``delay`` — sleeps ``seconds`` first (a straggler: the round completes,
    late);
  * ``drop``  — marks the host departed on its exchange store (graceful
    leave) and exits the process with :data:`DROP_EXIT_CODE`.

Faults are injected *inside* the victim, at a deterministic stream step —
not by an outside killer racing the training loop — so every chaos scenario
is exactly reproducible.  The spec travels to host subprocesses through one
environment variable (:data:`ENV_VAR`), encoded as JSON by
:func:`faults_to_env`.

The injector hooks a :class:`repro_torch.data.pipeline.BatchIterator` (or
any step-positioned stream) via :meth:`ChaosInjector.wrap_stream`: the
stream's ``step`` counter is the round clock, so one mechanism serves the
BSP mesh, the SSP exchange lane, and plain single-host streaming alike.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Dict, List, Optional, Sequence

__all__ = ["Fault", "ChaosInjector", "faults_to_env", "ENV_VAR",
           "DROP_EXIT_CODE"]

#: environment variable carrying the JSON fault spec into host subprocesses
ENV_VAR = "REPRO_CHAOS"

#: exit code of a host that executed a ``drop`` fault (graceful departure)
DROP_EXIT_CODE = 76

_ACTIONS = ("kill", "delay", "drop")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault: ``action`` on ``host`` at stream ``round``."""

    host: int
    round: int
    action: str
    seconds: float = 0.0  # delay only

    def __post_init__(self) -> None:
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r} "
                             f"(one of {_ACTIONS})")
        if self.action == "delay" and self.seconds <= 0:
            raise ValueError("delay faults need seconds > 0")


def faults_to_env(faults: Sequence[Fault]) -> Dict[str, str]:
    """Encode a fault list as the environment entry host processes read."""
    payload = [dataclasses.asdict(f) for f in faults]
    return {ENV_VAR: json.dumps(payload)}


class ChaosInjector:
    """Executes the faults targeting one host, keyed by round index.

    Build with :meth:`from_env` inside a host process (returns an inert
    injector when no spec is present, so programs can install it
    unconditionally), or directly with a fault list for in-process use
    (the straggler benchmark).
    """

    def __init__(self, faults: Sequence[Fault] = (), host_id: int = 0,
                 store: Optional[object] = None):
        self.host_id = int(host_id)
        self.store = store  # ParamStore for drop faults (optional)
        self._by_round: Dict[int, Fault] = {}
        for f in faults:
            if f.host != self.host_id:
                continue
            if f.round in self._by_round:
                raise ValueError(
                    f"two faults target host {f.host} round {f.round}")
            self._by_round[f.round] = f
        self.injected: List[Fault] = []

    @staticmethod
    def faults_from_env() -> List[Fault]:
        """The fault list :data:`ENV_VAR` carries (empty when unset)."""
        raw = os.environ.get(ENV_VAR)
        return [Fault(**d) for d in json.loads(raw)] if raw else []

    @classmethod
    def from_env(cls, host_id: Optional[int] = None,
                 store: Optional[object] = None) -> "ChaosInjector":
        """Injector for this process from :data:`ENV_VAR` (inert when
        unset).  ``host_id`` defaults to ``REPRO_HOST_ID``/0."""
        if host_id is None:
            host_id = int(os.environ.get("REPRO_HOST_ID", "0"))
        return cls(cls.faults_from_env(), host_id=host_id, store=store)

    def __bool__(self) -> bool:
        return bool(self._by_round)

    # ------------------------------------------------------------------ #
    # injection
    # ------------------------------------------------------------------ #
    def step(self, round_index: int) -> None:
        """Inject the fault registered for ``round_index``, if any.  Called
        by the wrapped stream right before it yields that round's window."""
        fault = self._by_round.get(round_index)
        if fault is None:
            return
        if fault.action == "kill":
            # uncatchable, like a pod preemption: no cleanup runs
            os.kill(os.getpid(), signal.SIGKILL)
        elif fault.action == "delay":
            self.injected.append(fault)
            time.sleep(fault.seconds)
        elif fault.action == "drop":
            if self.store is not None:
                self.store.mark_left()
            # graceful leave: flush stdio, exit with the marker code the
            # harness recognizes as departure (not failure)
            raise SystemExit(DROP_EXIT_CODE)

    def wrap_stream(self, stream):
        """Return a stream that injects this host's faults keyed by the
        underlying stream's ``step`` counter — the one mechanism every
        execution lane shares (the stream position IS the round clock)."""
        return _ChaosStream(stream, self)


class _ChaosStream:
    """Iterator proxy: ``injector.step(stream.step)`` before each window.

    Proxies the attributes the runner contract relies on (``step``,
    ``seek``, ``source``, ``mesh``, ``device``) so it is drop-in wherever a
    :class:`repro_torch.data.pipeline.BatchIterator` is accepted.
    """

    def __init__(self, stream, injector: ChaosInjector):
        self._stream = stream
        self._injector = injector

    @property
    def step(self):
        return self._stream.step

    @property
    def mesh(self):
        return getattr(self._stream, "mesh", None)

    @property
    def device(self):
        return getattr(self._stream, "device", None)

    @property
    def source(self):
        return self._stream.source

    def seek(self, step: int):
        self._stream.seek(step)
        return self

    def restrict(self, indices):
        return _ChaosStream(self._stream.restrict(indices), self._injector)

    def __iter__(self):
        return self

    def __next__(self):
        self._injector.step(self._stream.step)
        return next(self._stream)
