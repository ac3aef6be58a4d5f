"""File-based parameter exchange between hosts (the SSP transport).

Counterpart: ``src/repro/core/exchange.py`` (``PeerTimeout``,
``ParamStore``), on :mod:`repro_torch.checkpoint.store`, which writes the
reference's file format: a publish from one package is read by the other.

Stale-synchronous rounds cannot ride the collectives: a collective is a
barrier by construction, which is the BSP discipline SSP relaxes.  So the
SSP lane exchanges partials through a shared directory: every host
publishes its per-round partial as one atomic file (fsync + atomic rename,
so a SIGKILL mid-publish never corrupts what peers read), and reads its
peers' freshest publishes under the staleness bound of
:class:`repro_torch.core.collectives.SyncPolicy`.  The layout under
``root`` is one subdirectory per host::

    root/h0/step_0.npz  step_1.npz ...   # host 0's per-round partials
    root/h1/...
    root/h1/LEFT                          # host 1 left the mesh gracefully

A host's *clock* is its newest published step: a killed host's clock
freezes, a straggler's lags, and peers see both by scanning directories.
``LEFT`` markers tell a graceful departure (the ``drop`` fault) from a
death: peers stop waiting at once instead of timing out.  A bulletin board,
not a message queue: publishes are idempotent and reads repeatable.
"""
from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from repro_torch.checkpoint.store import (
    _STEP_RE,
    atomic_write_text,
    latest_step,
    prune_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core.runner import _first_device

__all__ = ["PeerTimeout", "ParamStore"]

#: name of the graceful-departure marker inside a host's directory
_LEFT_MARKER = "LEFT"


class PeerTimeout(TimeoutError):
    """A peer failed to publish within the deadline — it is presumed dead.
    Carries the peer id and the round waited for."""

    def __init__(self, peer: int, wanted_round: int, timeout: float):
        self.peer = peer
        self.wanted_round = wanted_round
        super().__init__(
            f"host {peer} has not published round {wanted_round} after "
            f"{timeout:.1f}s — presumed dead (SSP can absorb a straggler, "
            f"not a corpse; an elastic controller should resize the mesh)")


class ParamStore:
    """One host's handle on the shared exchange directory.

    ``root`` is the shared directory (one per run or generation);
    ``host_id``, ``num_hosts`` this host's id and the host count;
    :meth:`wait_clock` polls every ``poll`` seconds and declares a peer dead
    after ``timeout`` seconds without progress; ``keep`` publishes are
    retained per host (more than the staleness bound: the executor passes
    ``staleness + 2``)."""

    def __init__(self, root: str, host_id: int, num_hosts: int, *,
                 timeout: float = 60.0, poll: float = 0.002,
                 keep: Optional[int] = None):
        if not 0 <= host_id < num_hosts:
            raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
        self.root = root
        self.host_id = int(host_id)
        self.num_hosts = int(num_hosts)
        self.timeout = float(timeout)
        self.poll = float(poll)
        self.keep = keep
        os.makedirs(self._host_dir(host_id), exist_ok=True)

    def _host_dir(self, host: int) -> str:
        return os.path.join(self.root, f"h{host}")

    # ------------------------------------------------------------------ #
    # publishing
    # ------------------------------------------------------------------ #
    def publish(self, round_index: int, tree: Any) -> None:
        """Atomically publish this host's partial for ``round_index`` (a
        tree of tensors or numpy arrays); the publish is the clock tick
        peers observe."""
        save_checkpoint(self._host_dir(self.host_id), round_index, tree,
                        metadata={"round": round_index, "host": self.host_id},
                        keep=self.keep)

    def mark_left(self) -> None:
        """Graceful departure: peers stop waiting for this host at their
        next scan."""
        atomic_write_text(os.path.join(self._host_dir(self.host_id),
                                       _LEFT_MARKER), "left")

    # ------------------------------------------------------------------ #
    # observing peers
    # ------------------------------------------------------------------ #
    def clock(self, host: int) -> int:
        """Number of rounds ``host`` has published (0 = nothing yet)."""
        step = latest_step(self._host_dir(host))
        return 0 if step is None else step + 1

    def has_left(self, host: int) -> bool:
        return os.path.exists(os.path.join(self._host_dir(host), _LEFT_MARKER))

    def peers(self) -> List[int]:
        """Every other host that has not marked itself departed."""
        return [h for h in range(self.num_hosts)
                if h != self.host_id and not self.has_left(h)]

    def wait_clock(self, host: int, min_clock: int) -> int:
        """Block until ``host``'s clock reaches ``min_clock`` (or it marks
        itself departed: returns its final clock).  Raises
        :class:`PeerTimeout` after ``timeout`` seconds of no observed
        progress: the deadline resets whenever the clock advances, so a
        slow straggler that keeps publishing is waited out and a frozen
        clock times out after ``timeout``."""
        last = self.clock(host)
        deadline = time.monotonic() + self.timeout
        while True:
            c = self.clock(host)
            if c >= min_clock or self.has_left(host):
                return c
            if c > last:
                last = c
                deadline = time.monotonic() + self.timeout
            if time.monotonic() >= deadline:
                raise PeerTimeout(host, min_clock - 1, self.timeout)
            time.sleep(self.poll)

    def read(self, host: int, round_index: int, template: Any) -> Any:
        """``host``'s published partial for ``round_index`` in the structure
        of ``template``, on the device of its first tensor leaf (the CPU if
        it has none)."""
        restored, _ = restore_checkpoint(self._host_dir(host), template,
                                         step=round_index,
                                         device=_first_device(template) or "cpu")
        return restored

    def rounds(self, host: int) -> List[int]:
        """Every round ``host`` currently has on the board, ascending."""
        d = self._host_dir(host)
        if not os.path.isdir(d):
            return []
        out = []
        for fn in os.listdir(d):
            m = _STEP_RE.match(fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def read_at_most(self, host: int, round_index: int, template: Any
                     ) -> Optional[tuple]:
        """Freshest publish of ``host`` not newer than ``round_index``:
        ``(tree, round)``, or None when nothing that old is on the board.
        A file listed by :meth:`rounds` may be pruned by the peer before it
        is opened; such a miss is retried against a fresh scan (pruning
        only deletes older publishes, so the loop ends)."""
        while True:
            have = [r for r in self.rounds(host) if r <= round_index]
            if not have:
                return None
            r = have[-1]
            try:
                return self.read(host, r, template), r
            except FileNotFoundError:
                continue  # pruned between the scan and the open — rescan

    def clocks(self) -> Dict[int, int]:
        return {h: self.clock(h) for h in range(self.num_hosts)}

    def prune(self, keep: int) -> None:
        prune_checkpoints(self._host_dir(self.host_id), keep)
