"""Collective schedules for the per-round global combine (paper §IV-A).

Counterpart: ``src/repro/core/collectives.py`` (``CollectiveSchedule``,
``combine_mean``, ``combine_sum``, ``combine_concat``, ``SyncPolicy``,
``ssp_read_round``, ``ssp_trace``).

The schedule is the wire pattern of the combine: Spark's gather+broadcast,
Vowpal Wabbit's allreduce tree, or the two-phase reduce-scatter.  In
emulated mode (partitions on one device) every schedule is the same local
reduction, as the reference's ``_emulated_combine`` ignores it.  In mesh
mode (:class:`repro_torch.core.hostmesh.HostMesh`: host processes joined by
a ``torch.distributed`` group, each holding ``L`` partitions on its device)
the combines below run the schedule over the group.  A leaf is one host's
``(L, ...)`` stack of partials, partition ``host·L + j`` at index ``j``:

  * ``GATHER_BROADCAST`` — ``all_gather`` every host's stack into the
    ``(P, ...)`` stack of all partitions, then the emulated reduction on
    it (``mean(dim=0)`` / ``sum(dim=0)``), as the reference takes
    ``jnp.mean`` after its ``all_gather``.  Where each partition's partial
    does not depend on how many partitions share the launch, the result is
    bitwise that of ``P`` emulated partitions in one process.
  * ``ALLREDUCE`` — the host's local sum over its ``L`` partials, one
    ``all_reduce``, then (mean) a division by ``P``.
  * ``REDUCE_SCATTER`` — the local sum, flattened and zero-padded to a
    multiple of the world size as the reference pads, ``reduce_scatter``
    then ``all_gather``, then (mean) the division.

``combine_sum`` sums directly (the reference's mesh form is the mean times
``P``, which equals the sum only up to rounding).  ``combine_concat`` keeps
the reference's disjoint-support trick for allreduce and reduce-scatter: the
host's block is placed at its global offset in a zero tensor and the
supports are summed, so concat is the same values under all three schedules
(a -0.0 comes back as +0.0 from the sums).

Under gloo a CUDA leaf crosses processes through a pinned host buffer (the
mesh's ``staged`` rule, not a retry) and the result comes back to the
leaf's device, where the final reduction runs.

Beside the combines: :func:`gather_partitions` (every partition's partial
on every host whatever the schedule, for the table statistics' one order),
:func:`all_to_all_rows` (a fold view's rows to the hosts that hold them)
and :func:`barrier` (a snapshot or artifact host 0 writes is published
before any host goes on).

The barrier discipline (:class:`SyncPolicy`) and the executable spec of the
stale-synchronous read rule (:func:`ssp_read_round`, :func:`ssp_trace`) are
pure host logic, copied from the reference.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, List, Sequence, Union

import torch

__all__ = [
    "CollectiveSchedule",
    "SyncPolicy",
    "combine_mean",
    "combine_sum",
    "combine_concat",
    "gather_partitions",
    "all_to_all_rows",
    "barrier",
    "ssp_read_round",
    "ssp_trace",
]


class CollectiveSchedule(enum.Enum):
    """Wire schedule for the per-round global combine (paper §IV-A).

    Members:
      * ``ALLREDUCE`` — VW's reduction tree; O(d) bytes per device.
      * ``GATHER_BROADCAST`` — MLI/Spark's gather-to-master + broadcast;
        O(N·d) bytes per device.
      * ``REDUCE_SCATTER`` — beyond-paper two-phase reduce-scatter +
        all-gather.

    All members produce the same result to fp tolerance; in emulated mode
    they run the same arithmetic.
    """

    ALLREDUCE = "allreduce"
    GATHER_BROADCAST = "gather_broadcast"
    REDUCE_SCATTER = "reduce_scatter"

    @classmethod
    def parse(cls, v: Union[str, "CollectiveSchedule"]) -> "CollectiveSchedule":
        """Accept either a member or its lowercase string value; anything
        else raises ``ValueError: '<v>' is not a valid CollectiveSchedule``."""
        return v if isinstance(v, cls) else cls(str(v).lower())


# --------------------------------------------------------------------------- #
# the combines over a host mesh
# --------------------------------------------------------------------------- #
def _tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (dicts, lists and tuples are
    nodes; anything else is a leaf), zipped with the same leaves of
    ``rest`` — ``jax.tree.map`` for the trees this package carries."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(o[k] for o in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, v, *(o[i] for o in rest)) for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def _wire(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collective sends it: a pinned host copy when the mesh
    stages CUDA tensors (gloo), else ``x`` itself (contiguous)."""
    if mesh.staged(x):
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return buf.copy_(x)
    return x.contiguous()


def _empty_like_wire(mesh, x: torch.Tensor, shape) -> torch.Tensor:
    if mesh.staged(x):
        return torch.empty(shape, dtype=x.dtype, pin_memory=True)
    return torch.empty(shape, dtype=x.dtype, device=x.device)


def _all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every host's ``x`` (on the wire), stacked host-major: ``(H, *x.shape)``
    on ``x``'s wire device."""
    import torch.distributed as dist

    out = _empty_like_wire(mesh, x, (mesh.num_hosts,) + tuple(x.shape))
    _run(mesh, dist.all_gather, list(out.unbind(0)), x)
    return out


def _reduce_scatter(mesh, x: torch.Tensor) -> torch.Tensor:
    """This host's ``1/H`` slice of the sum over hosts of the flat ``x``
    (its length a multiple of ``H``), on ``x``'s wire device."""
    import torch.distributed as dist

    part = _empty_like_wire(mesh, x, (x.shape[0] // mesh.num_hosts,))
    _run(mesh, dist.reduce_scatter, part, list(x.chunk(mesh.num_hosts)),
         op=dist.ReduceOp.SUM)
    return part


def _back(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.device)


def _run(mesh, collective, *args, **kwargs) -> None:
    """One collective of ``torch.distributed`` on the mesh's group; a
    failure (a peer died, or the group's timeout passed) raises
    :class:`repro_torch.core.hostmesh.PeerLost`."""
    from repro_torch.core.hostmesh import PeerLost

    try:
        collective(*args, group=mesh.group, **kwargs)
    except RuntimeError as e:
        raise PeerLost(f"host {mesh.host_id}: {collective.__name__} "
                       f"failed: {e}") from e


def _gather_stack(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every host's ``(L, ...)`` stack gathered into the ``(P, ...)`` stack,
    host-major, on ``x``'s device."""
    return _back(_all_gather(mesh, _wire(mesh, x)), x).flatten(0, 1)


def gather_partitions(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every host's ``(L, ...)`` stack of per-partition values gathered into
    the ``(P, ...)`` stack of all partitions, partition order, on ``x``'s
    device, whatever the schedule (a table statistic's partials, sent
    whole so that every host sums them in one order)."""
    return _gather_stack(mesh, x)


def all_to_all_rows(mesh, send: Sequence[torch.Tensor], recv_counts: Sequence[int]
                    ) -> torch.Tensor:
    """One ``all_to_all`` of row blocks: ``send[h]`` (rows, ...) goes to host
    ``h`` (this host's own entry is empty), and the rows every host sends
    here come back concatenated in host order, ``recv_counts[h]`` from host
    ``h``, on the device of ``send``'s tensors.  Every host calls it, with
    counts that agree."""
    import torch.distributed as dist

    flat = torch.cat(list(send))
    wire = _wire(mesh, flat)
    got = _empty_like_wire(mesh, flat, (sum(recv_counts),) + tuple(flat.shape[1:]))
    _run(mesh, dist.all_to_all_single, got, wire, list(recv_counts),
         [int(t.shape[0]) for t in send])
    return _back(got, flat)


def barrier(mesh) -> None:
    """Every host of ``mesh`` waits here for the others."""
    import torch.distributed as dist

    _run(mesh, dist.barrier)


def _reduce_sum(mesh, x: torch.Tensor, schedule: CollectiveSchedule) -> torch.Tensor:
    """Σ over all ``P`` partitions of the leaf under ``schedule``."""
    import torch.distributed as dist

    if schedule is CollectiveSchedule.GATHER_BROADCAST:
        return _gather_stack(mesh, x).sum(dim=0)
    local = x.sum(dim=0)
    if schedule is CollectiveSchedule.ALLREDUCE:
        buf = _wire(mesh, local)
        _run(mesh, dist.all_reduce, buf, op=dist.ReduceOp.SUM)
        return _back(buf, local)
    if schedule is CollectiveSchedule.REDUCE_SCATTER:
        flat = local.reshape(-1)
        world = mesh.num_hosts
        pad = (-flat.shape[0]) % world
        if pad:
            flat = torch.cat([flat, flat.new_zeros((pad,))])
        part = _reduce_scatter(mesh, _wire(mesh, flat))
        full = _back(_all_gather(mesh, part).flatten(), local)
        if pad:
            full = full[: local.numel()]
        return full.reshape(local.shape)
    raise ValueError(schedule)


def _leaf_mean(mesh, x: torch.Tensor, schedule: CollectiveSchedule) -> torch.Tensor:
    if schedule is CollectiveSchedule.GATHER_BROADCAST:
        return _gather_stack(mesh, x).mean(dim=0)
    return _reduce_sum(mesh, x, schedule) / mesh.num_partitions


def _leaf_concat(mesh, x: torch.Tensor, schedule: CollectiveSchedule) -> torch.Tensor:
    """The ``(L, rows, ...)`` stack of every host concatenated into the
    ``(P·rows, ...)`` rows of all partitions, in partition order."""
    import torch.distributed as dist

    if schedule is CollectiveSchedule.GATHER_BROADCAST:
        return _gather_stack(mesh, x).flatten(0, 1)
    block = x.flatten(0, 1)
    rows = block.shape[0]
    full = block.new_zeros((mesh.num_hosts * rows,) + tuple(block.shape[1:]))
    full[mesh.host_id * rows:(mesh.host_id + 1) * rows] = block
    if schedule is CollectiveSchedule.ALLREDUCE:
        buf = _wire(mesh, full)
        _run(mesh, dist.all_reduce, buf, op=dist.ReduceOp.SUM)
        return _back(buf, block)
    if schedule is CollectiveSchedule.REDUCE_SCATTER:
        flat = full.reshape(-1)
        part = _reduce_scatter(mesh, _wire(mesh, flat))
        return _back(_all_gather(mesh, part), block).reshape(full.shape)
    raise ValueError(schedule)


def combine_mean(tree: Any, mesh,
                 schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE) -> Any:
    """Average a tree of per-host ``(L, ...)`` partial stacks over all ``P``
    partitions of ``mesh`` under ``schedule`` — the paper's 'average all
    parameters at each iteration' step (§IV-A, Fig. A4 ``avgWeights``).
    Every host receives the same value."""
    schedule = CollectiveSchedule.parse(schedule)
    return _tree_map(lambda x: _leaf_mean(mesh, x, schedule), tree)


def combine_sum(tree: Any, mesh,
                schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE) -> Any:
    """Sum a tree of per-host ``(L, ...)`` partial stacks over all
    partitions — the combine of sufficient statistics (k-means sums and
    counts, full-batch gradients)."""
    schedule = CollectiveSchedule.parse(schedule)
    return _tree_map(lambda x: _reduce_sum(mesh, x, schedule), tree)


def combine_concat(tree: Any, mesh,
                   schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.GATHER_BROADCAST) -> Any:
    """Concatenate every partition's row block, in partition order, on every
    host — BroadcastALS's 'broadcast the factor' step (paper §IV-B)."""
    schedule = CollectiveSchedule.parse(schedule)
    return _tree_map(lambda x: _leaf_concat(mesh, x, schedule), tree)


# --------------------------------------------------------------------------- #
# barrier discipline: BSP / SSP / elastic (beyond paper; Petuum, PAPERS.md)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SyncPolicy:
    """The *barrier discipline* of multi-host rounds — the second axis of the
    collective schedule (the first, :class:`CollectiveSchedule`, is the wire
    pattern of one combine; this is *when* workers may combine).

      * ``staleness == 0`` — **BSP**: every worker blocks at every round
        boundary until all peers publish that round.
      * ``staleness == s > 0`` — **SSP** (Petuum): a worker at round ``r``
        may use each peer's freshest partial no older than round ``r - s``;
        it blocks only when a peer falls more than ``s`` rounds behind.
        With ``s = 0`` this is BSP bit for bit.
      * ``elastic`` — membership may change mid-run: a host that dies
        triggers a restart of the world, resized, from the newest atomic
        checkpoint (:mod:`repro_torch.launch.elastic`).

    The executable spec of the SSP read rule is :func:`ssp_read_round` /
    :func:`ssp_trace`; the executor
    (:meth:`repro_torch.core.runner.DistributedRunner.run_epochs_ssp`)
    follows the same rule through :class:`repro_torch.core.exchange.ParamStore`.
    """

    staleness: int = 0
    elastic: bool = False

    def __post_init__(self) -> None:
        if self.staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {self.staleness}")

    @property
    def mode(self) -> str:
        return "bsp" if self.staleness == 0 else "ssp"

    @classmethod
    def parse(cls, v: Union[None, int, "SyncPolicy"]) -> "SyncPolicy":
        """Accept a policy, a bare staleness integer, or None (BSP)."""
        if v is None:
            return cls()
        if isinstance(v, cls):
            return v
        return cls(staleness=int(v))


def ssp_read_round(my_round: int, peer_clock: int, staleness: int) -> int:
    """Which round of a peer's publishes a worker at ``my_round`` combines.

    ``peer_clock`` is the number of rounds the peer has published.  The
    worker reads the peer's freshest partial capped at its own round, and
    must block until the peer has published at least round ``my_round -
    staleness``.  Raises if the peer is still too far behind (the caller
    waits and retries)."""
    if peer_clock <= my_round - staleness:
        raise ValueError(
            f"peer at clock {peer_clock} is more than {staleness} rounds "
            f"behind round {my_round} — SSP requires blocking here")
    return min(peer_clock - 1, my_round)


def ssp_trace(durations: Sequence[Sequence[float]], staleness: int
              ) -> List[List[Dict[int, int]]]:
    """Executable spec of the SSP discipline: simulate ``W`` workers running
    ``R`` rounds where worker ``w``'s round ``r`` takes ``durations[w][r]``
    seconds, and return ``trace[w][r] = {peer: read_round}``.

    Worker ``w`` computes round ``r`` and publishes; waits until every peer
    has published round ``>= r - s``; reads each peer's freshest publish
    available then, capped at ``r`` (:func:`ssp_read_round`).  Every read
    lies in ``[r - s, r]``; with ``s = 0`` every read is ``r`` (BSP)."""
    W = len(durations)
    R = len(durations[0]) if W else 0
    if any(len(d) != R for d in durations):
        raise ValueError("every worker needs a duration for every round")
    publish = [[0.0] * R for _ in range(W)]
    merged = [[0.0] * R for _ in range(W)]
    trace: List[List[Dict[int, int]]] = [[{} for _ in range(R)] for _ in range(W)]
    for r in range(R):
        for w in range(W):
            start = merged[w][r - 1] if r else 0.0
            publish[w][r] = start + durations[w][r]
        for w in range(W):
            t = publish[w][r]
            for p in range(W):
                if p != w and r - staleness >= 0:
                    t = max(t, publish[p][r - staleness])
            merged[w][r] = t
            for p in range(W):
                if p == w:
                    continue
                clock = 0
                for k in range(min(r, R - 1) + 1):
                    if publish[p][k] <= t:
                        clock = k + 1
                trace[w][r][p] = ssp_read_round(r, clock, staleness)
    return trace
