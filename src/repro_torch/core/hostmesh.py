"""Multi-host mesh bootstrap and data placement over ``torch.distributed``.

Counterpart: ``src/repro/core/hostmesh.py`` (``HostInfo``, ``free_port``,
``initialize``, ``initialize_from_env``, ``is_multihost``, ``host_id``,
``num_hosts``, ``local_row_slice``, ``place_global_rows``, ``fetch``).

One process per host, every process running the same program.  Where the
reference joins ``jax.distributed`` and builds one global device mesh, the
port joins a ``torch.distributed`` process group and describes its mesh with
:class:`HostMesh`: the group, its backend, the number of partitions each
host holds (``L``) and the host's device.  Global partition ``p = h·L + j``
is partition ``j`` of host ``h``, and host ``h`` owns rows ``[h·n/H,
(h+1)·n/H)`` of every global table or window (:func:`local_row_slice`).

The backend follows one rule, :func:`choose_backend`: NCCL when every host
has its own card, gloo on the CPU and when hosts share a card (NCCL refuses
two ranks on one GPU).  Under gloo a CUDA partial crosses processes through
a pinned host buffer (:meth:`HostMesh.staged`); the local step and its
kernels stay on the card.  Asking for NCCL with more hosts than cards
raises.  Every process group is made with a timeout, so a host that cannot
join raises within it.  :func:`initialize` takes a ``host:port`` (TCP) or a
``file://`` rendezvous, which needs no free port.

A collective that fails because a peer vanished raises :class:`PeerLost`;
a host program exits with :data:`PEER_LOST_EXIT_CODE` on it, which
:mod:`repro_torch.launch.elastic` reads as a casualty of another host's
death (gloo notices a dead peer at once, where the reference's collectives
hang until the controller kills the survivor).

Environment contract (set by the launcher for every host process):

    REPRO_COORDINATOR   host:port (or file://path) of the rendezvous
    REPRO_NUM_HOSTS     total host processes in the mesh
    REPRO_HOST_ID       this process's id in [0, num_hosts)
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import partition as pt
from repro_torch.device import DeviceLike, on_device, resolve_device

__all__ = [
    "HostInfo",
    "HostMesh",
    "PeerLost",
    "PEER_LOST_EXIT_CODE",
    "DEFAULT_TIMEOUT",
    "free_port",
    "choose_backend",
    "host_device",
    "initialize",
    "initialize_from_env",
    "make_mesh",
    "shutdown",
    "is_multihost",
    "host_id",
    "num_hosts",
    "local_row_slice",
    "place_global_rows",
    "fetch",
]

#: seconds a process group waits for its members (joining and collectives)
DEFAULT_TIMEOUT = 120.0

#: exit code of a host whose collective failed because a peer died
PEER_LOST_EXIT_CODE = 75


class PeerLost(RuntimeError):
    """A collective of the host mesh failed: a peer left the group (died,
    was killed) or did not answer within the group's timeout."""


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """What a host process knows about its place in the mesh."""

    host_id: int
    num_hosts: int
    coordinator: Optional[str] = None
    backend: Optional[str] = None

    @property
    def multihost(self) -> bool:
        return self.num_hosts > 1


def free_port() -> int:
    """An OS-assigned free TCP port (for a generation's coordinator)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_method(coordinator: str) -> str:
    if coordinator.startswith(("file://", "tcp://")):
        return coordinator
    return f"tcp://{coordinator}"


def host_device(device: DeviceLike, host: int) -> torch.device:
    """The device host ``host`` computes on: ``device`` (the CUDA card when
    None); a bare ``cuda`` is card ``host mod cards``, so hosts share the
    cards round-robin (all of them card 0 on a one-card machine)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", host % torch.cuda.device_count())
    return dev


def choose_backend(device: DeviceLike, num_hosts: int,
                   backend: Optional[str] = None) -> str:
    """The process group's backend by the port's one rule: ``nccl`` when
    every host has its own card, ``gloo`` on the CPU and when hosts share a
    card.  An explicit ``backend`` is checked against the rule's facts:
    NCCL needs a card per host and CUDA tensors."""
    dev = resolve_device(device)
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    own_cards = dev.type == "cuda" and torch.cuda.device_count() >= num_hosts
    if backend == "nccl" and not own_cards:
        raise ValueError(
            f"NCCL needs one card per host: {num_hosts} hosts on "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            f"card(s) of device {dev} (hosts that share a card use gloo)")
    if backend is None:
        backend = "nccl" if own_cards else "gloo"
    return backend


def initialize(coordinator: str, num_hosts: int, host_id: int, *,
               device: DeviceLike = None, backend: Optional[str] = None,
               timeout: float = DEFAULT_TIMEOUT) -> HostInfo:
    """Join the host mesh's process group (the default group).

    ``coordinator`` is ``host:port`` (process 0 serves a TCP store there)
    or a ``file://`` path every host can reach.  A world of one is a legal
    group (NCCL at a world of 1 is what one card can run).  Raises when the
    group does not form within ``timeout`` seconds."""
    import torch.distributed as dist

    if not 0 <= int(host_id) < int(num_hosts):
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    dev = host_device(device, int(host_id))
    backend = choose_backend(dev, int(num_hosts), backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=_init_method(coordinator),
        world_size=int(num_hosts), rank=int(host_id),
        timeout=datetime.timedelta(seconds=float(timeout)))
    return HostInfo(host_id=int(host_id), num_hosts=int(num_hosts),
                    coordinator=coordinator, backend=backend)


def initialize_from_env(device: DeviceLike = None, *,
                        backend: Optional[str] = None,
                        timeout: float = DEFAULT_TIMEOUT) -> HostInfo:
    """Bootstrap from the ``REPRO_*`` launcher contract; a no-op one-host
    :class:`HostInfo` when ``REPRO_NUM_HOSTS`` < 2 or no
    ``REPRO_COORDINATOR`` is set (the SSP lane's hosts are independent
    programs with ids but no group)."""
    n = int(os.environ.get("REPRO_NUM_HOSTS", "1"))
    coordinator = os.environ.get("REPRO_COORDINATOR")
    if n < 2 or not coordinator:
        return HostInfo(host_id=int(os.environ.get("REPRO_HOST_ID", "0")),
                        num_hosts=1)
    return initialize(coordinator, n, int(os.environ["REPRO_HOST_ID"]),
                      device=device, backend=backend, timeout=timeout)


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def is_multihost() -> bool:
    return num_hosts() > 1


def host_id() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def num_hosts() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The port's device mesh: ``num_hosts`` host processes in ``group``,
    each holding ``local_partitions`` (``L``) row partitions on its
    ``device``; one data axis of ``num_hosts · L`` partitions.  Build it
    with :func:`make_mesh` after :func:`initialize`."""

    local_partitions: int
    device: torch.device
    backend: str
    host_id: int
    num_hosts: int
    group: Any = None

    axis_names = ("data",)

    def __post_init__(self) -> None:
        if self.local_partitions < 1:
            raise ValueError(
                f"local_partitions must be >= 1, got {self.local_partitions}")

    @property
    def num_partitions(self) -> int:
        return self.num_hosts * self.local_partitions

    def staged(self, x: torch.Tensor) -> bool:
        """Whether ``x`` crosses processes through a pinned host buffer:
        a CUDA tensor under gloo."""
        return self.backend == "gloo" and x.is_cuda


def make_mesh(local_partitions: int = 1, device: DeviceLike = None,
              group: Any = None) -> HostMesh:
    """The :class:`HostMesh` of the joined process group (``group``, or the
    default group): this host's rank, the world size, the group's backend,
    and ``device`` (the card :func:`host_device` assigns when None)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "hostmesh.initialize (or initialize_from_env) first")
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    dev = host_device(device, rank)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"an NCCL group computes on CUDA devices, not {dev}")
    return HostMesh(local_partitions=int(local_partitions), device=dev,
                    backend=backend, host_id=rank,
                    num_hosts=dist.get_world_size(group), group=group)


def local_row_slice(num_rows: int, mesh: HostMesh) -> slice:
    """The contiguous rows of a ``(num_rows, ...)`` global array this host
    owns: ``[h·n/H, (h+1)·n/H)``.  Rows must divide over all partitions."""
    pt.check_rows_divisible(num_rows, mesh.num_partitions,
                            what="global row partitions")
    per = num_rows // mesh.num_hosts
    return slice(mesh.host_id * per, (mesh.host_id + 1) * per)


def place_global_rows(host_rows, num_rows: int, mesh: HostMesh) -> torch.Tensor:
    """This host's share of a global ``(num_rows, ...)`` array, on its
    device.  ``host_rows`` is exactly the slice :func:`local_row_slice`
    describes (every host passes its own); the mesh table built from it
    holds only these rows."""
    want = local_row_slice(num_rows, mesh)
    if host_rows.shape[0] != want.stop - want.start:
        raise ValueError(
            f"host {mesh.host_id} holds {host_rows.shape[0]} rows; its slice "
            f"of {num_rows} global rows is {want.stop - want.start}")
    return on_device(host_rows, mesh.device)


def fetch(x) -> np.ndarray:
    """A combined (replicated) result as numpy on the host.  Every combine
    of the runner leaves the same value on every host, so this is a copy;
    the reference checks replication, which a torch tensor does not
    carry."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
