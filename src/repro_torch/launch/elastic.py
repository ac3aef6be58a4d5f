"""Elastic multi-host controller: spawn, watch, resize, resume.

Counterpart: ``src/repro/launch/elastic.py`` (``HostExit``, ``Generation``,
``ElasticReport``, ``ElasticController``).

The restart-the-world elasticity model (the one torchelastic made
standard): host processes of one *generation* run as a gang; when a member
dies, the controller SIGKILLs the survivors, shrinks the world, and spawns
the next generation with a fresh rendezvous — every survivor resumes from
the newest atomic checkpoint with ``DistributedRunner.resume(...,
allow_resize=True)``, which revalidates the row partitioning on the new
world size through :func:`repro_torch.core.partition.plan_resize`.
Checkpoint + deterministic seekable streams make this live migration as
checkpoint-and-restart: the resumed run is bit-identical to a run that had
started on the small mesh from that same snapshot.

Each generation's rendezvous is ``127.0.0.1:<free port>``, or, with
``rendezvous_dir``, a fresh ``file://`` path in it (no port to race for).
Host programs are ordinary argv commands following the ``REPRO_*``
environment contract of :mod:`repro_torch.core.hostmesh` plus::

    REPRO_GENERATION    generation index (0 = first launch)
    REPRO_RESUME        "1" when a checkpoint should be picked up

Chaos fault specs (:mod:`repro_torch.testing.chaos`) are forwarded to
generation 0 only — a kill fault is keyed to a deterministic stream step,
and the resumed generation replays through that step, so re-arming it
would kill the run forever.

Exit-code protocol: ``0`` success, :data:`repro_torch.testing.chaos.
DROP_EXIT_CODE` graceful departure (the SSP lane absorbs it in place, no
restart), :data:`repro_torch.core.hostmesh.PEER_LOST_EXIT_CODE` a casualty
(its collective failed because a peer died: the generation restarts, but
the world does not shrink for it), anything else a death that shrinks the
world and restarts the generation.  The reference's survivors hang in
their collective until the controller kills them; a gloo survivor fails at
once, hence the casualty code.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core import hostmesh
from repro_torch.core.hostmesh import PEER_LOST_EXIT_CODE, free_port
from repro_torch.testing.chaos import DROP_EXIT_CODE, ENV_VAR as CHAOS_ENV

__all__ = ["HostExit", "Generation", "ElasticReport", "ElasticController",
           "run_hosts", "run_host", "mesh_from_env"]


@dataclasses.dataclass
class HostExit:
    """One host process's final word."""

    host_id: int
    returncode: int
    stdout: str
    stderr: str
    #: True when the controller itself SIGKILLed this (healthy) host to
    #: break up a generation after a peer's death — not an organic death,
    #: so it must not shrink the world a second time
    evicted: bool = False

    @property
    def died(self) -> bool:
        return not self.evicted and self.returncode not in (
            0, DROP_EXIT_CODE, PEER_LOST_EXIT_CODE)

    @property
    def dropped(self) -> bool:
        return self.returncode == DROP_EXIT_CODE

    @property
    def casualty(self) -> bool:
        """Exited because a peer died (not an organic death)."""
        return not self.evicted and self.returncode == PEER_LOST_EXIT_CODE


@dataclasses.dataclass
class Generation:
    """One gang launch: its world size, rendezvous, and every exit."""

    index: int
    num_hosts: int
    coordinator: str
    exits: List[HostExit] = dataclasses.field(default_factory=list)
    started: float = 0.0
    ended: float = 0.0

    @property
    def deaths(self) -> List[HostExit]:
        return [e for e in self.exits if e.died]

    @property
    def duration(self) -> float:
        return self.ended - self.started


@dataclasses.dataclass
class ElasticReport:
    """What an elastic run did: every generation plus recovery timing."""

    generations: List[Generation]
    #: seconds from each death detection to the next generation's spawn
    restart_seconds: List[float] = dataclasses.field(default_factory=list)

    @property
    def final(self) -> Generation:
        return self.generations[-1]

    @property
    def resized(self) -> bool:
        return len(self.generations) > 1

    def host_output(self, host_id: int, generation: int = -1) -> str:
        gen = self.generations[generation]
        for e in gen.exits:
            if e.host_id == host_id:
                return e.stdout
        raise KeyError(f"no host {host_id} in generation {gen.index}")


class ElasticController:
    """Gang-spawns host subprocesses and restarts the world on a death.

    ``argv`` is the host program (every host runs the same program; its
    rank arrives in ``REPRO_HOST_ID``); ``num_hosts`` the generation-0
    world; ``env`` extra environment for every host of every generation;
    ``faults`` :class:`repro_torch.testing.chaos.Fault`\\ s forwarded to
    generation 0 only; ``max_restarts`` the generation restarts allowed;
    ``min_hosts`` the smallest world worth restarting with (below it the
    controller raises); ``timeout`` the per-generation wall-clock limit;
    ``poll`` the seconds between liveness scans; ``global_mesh`` True (BSP)
    hands every host one rendezvous (one process group), False (the SSP
    lane) none; ``rendezvous_dir`` holds ``file://`` rendezvous files, one
    per generation (None: TCP on a free port).

    The partitions each host holds are the host program's own argument
    (``launch/fit.py --devices-per-host``): the reference's
    ``devices_per_host`` forced an XLA device count, which the port has no
    use for.
    """

    def __init__(self, argv: Sequence[str], num_hosts: int, *,
                 env: Optional[Dict[str, str]] = None,
                 faults: Sequence = (),
                 max_restarts: int = 2, min_hosts: int = 1,
                 timeout: float = 300.0, poll: float = 0.05,
                 global_mesh: bool = True,
                 rendezvous_dir: Optional[str] = None):
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        self.argv = list(argv)
        self.num_hosts = int(num_hosts)
        self.env = dict(env or {})
        self.faults = list(faults)
        self.max_restarts = int(max_restarts)
        self.min_hosts = int(min_hosts)
        self.timeout = float(timeout)
        self.poll = float(poll)
        self.global_mesh = bool(global_mesh)
        self.rendezvous_dir = rendezvous_dir

    # ------------------------------------------------------------------ #
    def _host_env(self, generation: int, num_hosts: int, host_id: int,
                  coordinator: str) -> Dict[str, str]:
        env = dict(os.environ)
        env.update(self.env)
        env.update({
            "REPRO_NUM_HOSTS": str(num_hosts),
            "REPRO_HOST_ID": str(host_id),
            "REPRO_GENERATION": str(generation),
            "REPRO_RESUME": "1" if generation > 0 else "0",
        })
        if self.global_mesh:
            env["REPRO_COORDINATOR"] = coordinator
        else:
            env.pop("REPRO_COORDINATOR", None)
        if generation == 0 and self.faults:
            from repro_torch.testing.chaos import faults_to_env

            env.update(faults_to_env(self.faults))
        else:
            env.pop(CHAOS_ENV, None)
        return env

    def _coordinator(self, generation: int) -> str:
        if self.rendezvous_dir is None:
            return f"127.0.0.1:{free_port()}"
        os.makedirs(self.rendezvous_dir, exist_ok=True)
        path = os.path.join(os.path.abspath(self.rendezvous_dir),
                            f"rendezvous_gen{generation}")
        if os.path.exists(path):
            os.remove(path)
        return f"file://{path}"

    def _spawn(self, generation: int, num_hosts: int) -> tuple:
        coordinator = self._coordinator(generation)
        procs = []
        for h in range(num_hosts):
            out = tempfile.TemporaryFile(mode="w+")
            err = tempfile.TemporaryFile(mode="w+")
            p = subprocess.Popen(
                self.argv, env=self._host_env(generation, num_hosts, h,
                                              coordinator),
                stdout=out, stderr=err, text=True)
            procs.append((h, p, out, err))
        return coordinator, procs

    @staticmethod
    def _collect(h: int, p: subprocess.Popen, out, err,
                 evicted: bool = False) -> HostExit:
        out.seek(0)
        err.seek(0)
        exit_ = HostExit(host_id=h, returncode=p.returncode,
                         stdout=out.read(), stderr=err.read(),
                         evicted=evicted)
        out.close()
        err.close()
        return exit_

    @staticmethod
    def _kill_survivors(procs) -> List[bool]:
        """SIGKILL every process still running; returns, per process,
        whether the controller killed it (an eviction) or it had exited on
        its own."""
        evicted = []
        for _, p, _, _ in procs:
            evicted.append(p.poll() is None)
            if evicted[-1]:
                try:
                    p.send_signal(signal.SIGKILL)
                except ProcessLookupError:  # pragma: no cover - exit race
                    pass
        for _, p, _, _ in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
        return evicted

    def _end(self, gen: Generation, pending) -> None:
        """Kill and collect what is left of a generation."""
        kills = self._kill_survivors(pending)
        for (h, p, out, err), ev in zip(pending, kills):
            gen.exits.append(self._collect(h, p, out, err, evicted=ev))
        gen.ended = time.monotonic()

    # ------------------------------------------------------------------ #
    def run(self) -> ElasticReport:
        """Run generations until one finishes cleanly (or restarts are
        exhausted / the world shrinks below ``min_hosts``)."""
        report = ElasticReport(generations=[])
        world = self.num_hosts
        for generation in range(self.max_restarts + 1):
            coordinator, procs = self._spawn(generation, world)
            gen = Generation(index=generation, num_hosts=world,
                             coordinator=coordinator)
            gen.started = time.monotonic()
            report.generations.append(gen)
            deadline = gen.started + self.timeout

            death_at = None
            pending = list(procs)
            while pending and death_at is None:
                still = []
                for h, p, out, err in pending:
                    if p.poll() is None:
                        still.append((h, p, out, err))
                        continue
                    exit_ = self._collect(h, p, out, err)
                    gen.exits.append(exit_)
                    if exit_.died or exit_.casualty:
                        death_at = time.monotonic()
                pending = still
                if death_at is None and pending:
                    if time.monotonic() > deadline:
                        self._end(gen, pending)
                        raise TimeoutError(
                            f"generation {generation} exceeded "
                            f"{self.timeout:.0f}s; killed "
                            f"{len(pending)} hosts")
                    time.sleep(self.poll)

            if death_at is None:
                gen.ended = time.monotonic()
                return report
            # the gang is broken (a collective would wait on the dead host,
            # or has failed already): kill the survivors, shrink, respawn.
            # Evictions and casualties are not deaths: only organic deaths
            # shrink the world.
            self._end(gen, pending)
            world = world - len(gen.deaths)
            if generation == self.max_restarts:
                first = (gen.deaths or [e for e in gen.exits if e.casualty])[0]
                raise RuntimeError(
                    f"host(s) {[e.host_id for e in gen.deaths]} died in "
                    f"generation {generation} and no restarts remain; "
                    f"stderr of host {first.host_id}:\n{first.stderr[-2000:]}")
            if world < self.min_hosts:
                raise RuntimeError(
                    f"world shrank to {world} host(s), below "
                    f"min_hosts={self.min_hosts}")
            report.restart_seconds.append(time.monotonic() - death_at)
        raise AssertionError("unreachable")  # pragma: no cover


# --------------------------------------------------------------------------- #
# the launchers' two sides
# --------------------------------------------------------------------------- #
def run_hosts(child: Sequence[str], num_hosts: int, *, timeout: float,
              work: Optional[str] = None, exchange_flag: Optional[str] = None,
              **controller: Any) -> ElasticReport:
    """Run ``child`` once a host under an :class:`ElasticController` with a
    ``file://`` rendezvous in ``work/rendezvous`` (the launcher side of
    ``launch/fit.py`` and ``launch/tune.py --hosts``).  With
    ``exchange_flag`` every host also gets ``exchange_flag work/exchange``
    (the SSP lane's store).  ``work=None`` is a temporary directory,
    removed when the run ends; ``controller`` holds the controller's other
    keywords."""
    own = work is None
    if own:
        work = tempfile.mkdtemp(prefix="mli-hosts-")
    argv = list(child)
    if exchange_flag is not None:
        argv += [exchange_flag, os.path.join(work, "exchange")]
    try:
        return ElasticController(
            argv, num_hosts, timeout=timeout,
            rendezvous_dir=os.path.join(work, "rendezvous"), **controller).run()
    finally:
        if own:
            shutil.rmtree(work, ignore_errors=True)


def run_host(body: Callable[[], Any]) -> Any:
    """Run a host program's ``body`` and leave the process group after it.
    A peer lost under a collective ends the process at once with
    :data:`~repro_torch.core.hostmesh.PEER_LOST_EXIT_CODE`: the controller
    tells such a casualty apart from a death."""
    try:
        out = body()
        hostmesh.shutdown()
        return out
    except hostmesh.PeerLost as e:
        print(f"peer lost: {e}", file=sys.stderr)
        sys.stderr.flush()
        os._exit(PEER_LOST_EXIT_CODE)


def mesh_from_env(device: Any, local_partitions: int
                  ) -> Optional[hostmesh.HostMesh]:
    """This host's mesh of ``local_partitions`` on ``device`` when the
    ``REPRO_*`` environment names a process group (it is joined here), else
    None."""
    if hostmesh.initialize_from_env(device).multihost:
        return hostmesh.make_mesh(local_partitions, device)
    return None
