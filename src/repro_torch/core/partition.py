"""Row partitioning of numeric data (paper §III-A).

Counterpart: ``src/repro/core/partition.py`` (``check_rows_divisible``,
``partition_rows``, ``unpartition_rows``, ``place_rows``,
``infer_data_axes``, ``num_data_shards``, ``ResizePlan``, ``plan_resize``).
A (rows, ...) tensor maps onto ``num_shards`` equal, contiguous row blocks,
viewed as one ``(num_shards, rows_per_shard, ...)`` tensor — the partition
dimension the port writes out where the reference ``vmap``s over blocks.

On a host mesh (:class:`repro_torch.core.hostmesh.HostMesh`: ``H`` host
processes with ``L`` partitions each) global partition ``p = h·L + j`` is
block ``j`` of host ``h``'s rows, and host ``h`` owns the contiguous rows
``[h·n/H, (h+1)·n/H)`` (process-major, as the reference lays rows over
its global device order).  :func:`place_rows` keeps a host's own rows on
its device.  The mesh has one data axis, the hosts × their partitions, so
:func:`infer_data_axes` is ``("data",)`` and :func:`num_data_shards` is
``H·L``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = [
    "DATA_AXIS_CANDIDATES",
    "infer_data_axes",
    "num_data_shards",
    "check_rows_divisible",
    "partition_rows",
    "unpartition_rows",
    "place_rows",
    "ResizePlan",
    "plan_resize",
]

#: the reference's data-axis names, outermost first; the port's mesh has one
#: data axis, "data" (hosts × their partitions)
DATA_AXIS_CANDIDATES: Tuple[str, ...] = ("pod", "data")


def infer_data_axes(mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` that carry data partitions: ``("data",)``."""
    return tuple(a for a in DATA_AXIS_CANDIDATES if a in mesh.axis_names)


def num_data_shards(mesh, data_axes: Tuple[str, ...] = ("data",)) -> int:
    """Number of row partitions the mesh induces: hosts × partitions a host
    (1 without data axes)."""
    return mesh.num_partitions if data_axes else 1


def check_rows_divisible(num_rows: int, num_shards: int, *,
                         what: str = "partitions") -> None:
    """Raise if ``num_rows`` does not split evenly — MLI partitions are
    equal-sized by construction (pad first)."""
    if num_rows % num_shards != 0:
        raise ValueError(
            f"row count {num_rows} must divide evenly over {num_shards} {what} "
            f"(pad first)"
        )


def partition_rows(array: torch.Tensor, num_shards: int) -> torch.Tensor:
    """View (rows, ...) as (num_shards, rows/num_shards, ...) partition
    blocks.  Pure layout: a view of ``array`` whenever its rows are
    uniformly strided, so a column slice of a table stays a view."""
    check_rows_divisible(array.shape[0], num_shards)
    return array.unflatten(0, (num_shards, array.shape[0] // num_shards))


def unpartition_rows(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`partition_rows`: (shards, rows, ...) -> (shards·rows, ...)."""
    return blocks.flatten(0, 1)


def place_rows(array, mesh) -> torch.Tensor:
    """This host's rows of the global ``(rows, ...)`` array ``array`` (a
    numpy array or a tensor), on the mesh's device — the twin of the
    reference's ``device_put`` onto a row sharding.  Rows must divide over
    every partition of the mesh."""
    from repro_torch.core.hostmesh import local_row_slice
    from repro_torch.device import on_device

    rows = local_row_slice(int(array.shape[0]), mesh)
    return on_device(array[rows], mesh.device)


# --------------------------------------------------------------------------- #
# elastic resize: repartitioning a row layout onto a different shard count
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ResizePlan:
    """How a row-partitioned layout maps onto a new shard count.

    Rows stay in global order on both sides, so the plan is fully described
    by the two block sizes; ``moved_rows`` counts rows whose owning shard
    index changes, the wire cost of a live repartition.  Built by
    :func:`plan_resize`, consumed by
    :meth:`repro_torch.core.runner.DistributedRunner.resume`
    (``allow_resize``)."""

    num_rows: int
    old_shards: int
    new_shards: int

    @property
    def old_rows_per_shard(self) -> int:
        return self.num_rows // self.old_shards

    @property
    def new_rows_per_shard(self) -> int:
        return self.num_rows // self.new_shards

    def owner(self, row: int, *, new: bool = True) -> int:
        """Shard index owning ``row`` under the new (or old) layout."""
        per = self.new_rows_per_shard if new else self.old_rows_per_shard
        return row // per

    @property
    def moved_rows(self) -> int:
        """Rows whose shard index changes between the layouts; zero exactly
        when the shard counts match."""
        return sum(1 for r in range(self.num_rows)
                   if self.owner(r, new=False) != self.owner(r, new=True))

    def describe(self) -> str:
        return (f"repartition {self.num_rows} rows: {self.old_shards} -> "
                f"{self.new_shards} shards ({self.old_rows_per_shard} -> "
                f"{self.new_rows_per_shard} rows/shard, {self.moved_rows} "
                f"rows change owner)")


def plan_resize(num_rows: int, old_shards: int, new_shards: int) -> ResizePlan:
    """Validate and describe an elastic resize of the row partition layout;
    raises when the rows cannot split evenly over either side."""
    if old_shards < 1 or new_shards < 1:
        raise ValueError(
            f"shard counts must be >= 1, got {old_shards} -> {new_shards}")
    check_rows_divisible(num_rows, old_shards, what="old partitions")
    check_rows_divisible(num_rows, new_shards, what="new partitions")
    return ResizePlan(num_rows=num_rows, old_shards=old_shards,
                      new_shards=new_shards)
