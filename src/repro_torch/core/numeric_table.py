"""Device-tier MLNumericTable (paper §III-A).

Counterpart: ``src/repro/core/numeric_table.py``.  An MLNumericTable is the
all-numeric table most algorithms consume: each row is one feature vector.
In emulated mode it is a 2-D tensor on one device, split into
``num_shards`` logical row partitions;
:class:`repro_torch.core.runner.DistributedRunner` views it as one
``(num_shards, rows_per_shard, cols)`` tensor.  On a host mesh (``mesh=``,
a :class:`repro_torch.core.hostmesh.HostMesh`) each host keeps only its own
rows on its device, as ``L`` partitions of the mesh's ``H·L``: ``data`` is
that host's ``(rows/H, cols)`` slice, while ``num_rows`` and
``num_shards`` describe the global table.

The row-wise operations run on the partitions a process holds:
``map_rows``, ``filter_mask`` and ``reduce`` take a function of one row
(``(d,)`` tensors), mapped over rows with ``torch.vmap`` where the
reference ``jax.vmap``s; ``matrix_batch_map`` hands each partition's block
to the partition function as a
:class:`~repro_torch.core.local_matrix.LocalMatrix`, one partition after
another.  On a mesh the tables they return keep the mesh (a host maps its
own rows) and ``filter_mask`` is the mask of the host's rows.  Global
combination is explicit (``reduce``, ``sum_rows``, ``mean_rows``,
``matrix_batch_map`` + a reduce), the paper's shared-nothing principle, and
so is a gather of the whole table (``to_numpy``, ``to_local_matrix``).

**One order for every statistic.**  ``sum_rows`` (and ``mean_rows``, and
the featurizers' column statistics through :func:`column_sums`) sums each
partition's rows in the pairwise order of
:func:`repro_torch.core.fixed_sum.fixed_sum`, fixed by the rows a
partition holds, then adds the ``(P, d)`` partials left to right in
partition order; ``reduce`` folds each partition, then the partials, as
the reference does.  On a mesh the partials are gathered whole to every
host (:func:`repro_torch.core.collectives.gather_partitions`, whatever the
runner's schedule) and summed there in the same order, so a statistic of a
mesh table is bitwise the statistic of the same rows in ``P`` emulated
partitions.  The reference sums ``sum_rows`` in one ``jnp.sum`` over all
rows (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import partition as pt
from repro_torch.core.fixed_sum import fixed_sum
from repro_torch.core.local_matrix import LocalMatrix
from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = ["MLNumericTable", "column_sums"]


def _tree_fold_rows(rows: torch.Tensor, fn: Callable,
                    identity: torch.Tensor) -> torch.Tensor:
    """Log-depth tree reduction of (n, d) rows with an associative,
    commutative ``fn((d,), (d,)) -> (d,)``: padded with ``identity`` to a
    power of two, then halves combined pairwise (row i with row i + half),
    as the reference's ``_tree_fold_rows``."""
    n = rows.shape[0]
    if n == 0:
        return identity
    pow2 = 1 << (n - 1).bit_length()
    if pow2 != n:
        pad = identity.expand((pow2 - n,) + tuple(rows.shape[1:]))
        rows = torch.cat([rows, pad], dim=0)
    while rows.shape[0] > 1:
        half = rows.shape[0] // 2
        rows = torch.vmap(fn)(rows[:half], rows[half:])
    return rows[0]


def _all_partials(partials: torch.Tensor, mesh) -> torch.Tensor:
    """The ``(P, ...)`` partials of every partition: this process's own in
    emulated mode, every host's gathered in partition order on a mesh."""
    if mesh is None:
        return partials
    from repro_torch.core.collectives import gather_partitions

    return gather_partitions(partials, mesh)


#: elements of the column slice of a table that :func:`column_sums` sums
#: at once: the pairwise levels' temporaries stay below this whatever the
#: table's size
_SLICE_ELEMENTS = 1 << 26


def column_sums(x: torch.Tensor, num_shards: int, mesh=None,
                fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
    """Column sums of ``(rows, d)`` values laid out as a table's rows (this
    host's rows on a mesh), in the table statistics' order: each
    partition's rows by :func:`~repro_torch.core.fixed_sum.fixed_sum`, then
    the partitions' partials left to right in partition order, the same on
    every host and in emulated mode.  ``fn``, elementwise, is applied to
    the values first.  The columns go in slices of at most
    ``_SLICE_ELEMENTS`` values, which changes no column's bits."""
    local = mesh.local_partitions if mesh is not None else num_shards
    blocks = pt.partition_rows(x, local)
    d = blocks.shape[-1]
    step = max(1, _SLICE_ELEMENTS // max(1, blocks.shape[0] * blocks.shape[1]))
    parts = []
    for c in range(0, max(d, 1), step):
        b = blocks[..., c:c + step]
        parts.append(fixed_sum(fn(b) if fn is not None else b, dim=1))
    partials = _all_partials(parts[0] if len(parts) == 1
                             else torch.cat(parts, dim=-1), mesh)
    out = partials[0]
    for p in partials[1:]:
        out = out + p
    return out


class MLNumericTable:
    """Row-partitioned numeric table; the input type of MLI algorithms.

    ``MLNumericTable(tensor, num_shards)`` wraps a tensor where it lies,
    without a copy — how a table larger than host memory is made on the
    card; :meth:`from_numpy` copies a host array to a device.  ``names``
    are the column names (an ``MLTable``'s schema names after
    ``to_numeric``), read by the featurizers' label and bias skips.  With
    ``mesh=`` the tensor is this host's own rows (its slice of the global
    table, :func:`repro_torch.core.hostmesh.local_row_slice`) and
    ``num_shards`` is the mesh's."""

    def __init__(self, data: torch.Tensor, num_shards: int = 1,
                 names: Optional[Sequence[Optional[str]]] = None,
                 mesh=None) -> None:
        if data.ndim != 2:
            raise ValueError("MLNumericTable holds a 2-D (rows, features) array")
        self.mesh = mesh
        if mesh is not None:
            num_shards = mesh.num_partitions
            pt.check_rows_divisible(data.shape[0], mesh.local_partitions,
                                    what="local partitions")
        else:
            pt.check_rows_divisible(data.shape[0], num_shards)
        self.data = data
        self.num_shards = int(num_shards)
        self.names = tuple(names) if names is not None else None

    @classmethod
    def from_numpy(cls, array: np.ndarray, num_shards: Optional[int] = None,
                   device: DeviceLike = None,
                   names: Optional[Sequence[Optional[str]]] = None,
                   mesh=None) -> "MLNumericTable":
        """Copy a host array to ``device`` (the CUDA card unless
        ``device="cpu"``); float64 arrives as float32, as in the reference.
        With ``mesh=``, ``array`` is the global table (every host passes
        the same) and only this host's rows go to the mesh's device."""
        if mesh is not None:
            return cls(pt.place_rows(array, mesh), names=names, mesh=mesh)
        return cls(to_tensor(array, resolve_device(device)),
                   num_shards=num_shards or 1, names=names)

    def _like(self, data: torch.Tensor, names=None) -> "MLNumericTable":
        """A table of ``data`` (rows laid out as this table's) with this
        table's partitions and mesh."""
        return MLNumericTable(data, num_shards=self.num_shards, names=names,
                              mesh=self.mesh)

    @property
    def local_shards(self) -> int:
        """Partitions this process holds: the mesh's ``L``, or all of them
        in emulated mode."""
        return self.mesh.local_partitions if self.mesh is not None else self.num_shards

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def num_rows(self) -> int:
        """Rows of the global table (on a mesh: every host's)."""
        hosts = self.mesh.num_hosts if self.mesh is not None else 1
        return self.data.shape[0] * hosts

    @property
    def num_cols(self) -> int:
        return self.data.shape[1]

    numRows, numCols = num_rows, num_cols  # paper spelling

    @property
    def rows_per_shard(self) -> int:
        return self.num_rows // self.num_shards

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to_numpy(self) -> np.ndarray:
        """The whole table on the host (every host's rows, on a mesh)."""
        return self.to_local_matrix().data.cpu().numpy()

    def to_local_matrix(self) -> LocalMatrix:
        """Materialize the *whole* table as one LocalMatrix (small tables /
        final factors only — deliberately explicit, per the paper's refusal
        to hide global operations).  On a mesh every host's rows are
        gathered, in row order, onto this host's device."""
        if self.mesh is None:
            return LocalMatrix(self.data)
        from repro_torch.core.collectives import gather_partitions

        return LocalMatrix(gather_partitions(self.data, self.mesh))

    toLocalMatrix = to_local_matrix

    @property
    def context(self):  # parity with the paper's ``trainData.context``
        return self

    def broadcast(self, value):
        """Paper's ``ctx.broadcast``: partitions are emulated on one device,
        so the value every partition reads IS the broadcast; returned as-is
        so reference code reads identically."""
        return value

    # ------------------------------------------------------------------ #
    # row-wise ops (device tier)
    # ------------------------------------------------------------------ #
    def map_rows(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "MLNumericTable":
        out = torch.vmap(fn)(self.data)
        if out.ndim == 1:
            out = out[:, None]
        return self._like(out)

    def filter_mask(self, pred: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
        """Static-shape filter: returns the row validity mask (downstream
        ops take the mask, as in the reference); on a mesh, the mask of
        this host's rows."""
        return torch.vmap(pred)(self.data)

    def reduce(self, fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               identity: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Combine all rows with an associative+commutative fn (Fig. A1).

        Reduces within each partition, then across partitions — matching the
        distributed execution order; on a mesh the partitions' results are
        gathered to every host and folded there."""
        if identity is None:
            identity = torch.zeros((self.num_cols,), dtype=self.data.dtype,
                                   device=self.device)
        blocks = pt.partition_rows(self.data, self.local_shards)
        partials = torch.stack([_tree_fold_rows(b, fn, identity) for b in blocks])
        return _tree_fold_rows(_all_partials(partials, self.mesh), fn, identity)

    def sum_rows(self) -> torch.Tensor:
        """Column sums over every row (module docstring: one order)."""
        return column_sums(self.data, self.num_shards, self.mesh)

    def mean_rows(self) -> torch.Tensor:
        return self.sum_rows() / self.num_rows

    # ------------------------------------------------------------------ #
    # matrixBatchMap — the heart of the MLI API (Fig. A1)
    # ------------------------------------------------------------------ #
    def matrix_batch_map(
        self,
        fn: Callable[..., LocalMatrix],
        *broadcast_args: Any,
        out_rows_per_shard: Optional[int] = None,
    ) -> "MLNumericTable":
        """Execute ``fn(local_partition, *broadcast_args)`` on every partition
        and concatenate the output matrices row-wise into a new table.

        ``broadcast_args`` are replicated to every partition (the paper's
        broadcast from the coordinating process).  ``fn`` receives a
        LocalMatrix and must return a LocalMatrix (or tensor) with the same
        number of rows for every partition.  On a mesh each host runs its
        own partitions and the result keeps the mesh.
        """
        outs = []
        for block in pt.partition_rows(self.data, self.local_shards):
            out = fn(LocalMatrix(block), *broadcast_args)
            out = out.data if isinstance(out, LocalMatrix) else torch.as_tensor(out)
            outs.append(out[:, None] if out.ndim == 1 else out)
        return self._like(pt.unpartition_rows(torch.stack(outs)))

    matrixBatchMap = matrix_batch_map  # paper spelling

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MLNumericTable(rows={self.num_rows}, cols={self.num_cols}, "
                f"shards={self.num_shards}, device={self.device})")
