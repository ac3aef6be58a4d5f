"""Device-tier MLNumericTable (paper §III-A), emulated mode.

Counterpart: ``src/repro/core/numeric_table.py``.  An MLNumericTable is the
all-numeric table most algorithms consume: each row is one feature vector.
Here it is a 2-D tensor on one device, split into ``num_shards`` logical row
partitions; :class:`repro_torch.core.runner.DistributedRunner` views it as
one ``(num_shards, rows_per_shard, cols)`` tensor.  ``map_rows``,
``filter_mask`` and ``reduce`` take a function of one row (``(d,)`` tensors),
mapped over rows with ``torch.vmap`` where the reference ``jax.vmap``s;
``matrix_batch_map`` hands each partition's block to the partition function
as a :class:`~repro_torch.core.local_matrix.LocalMatrix`, one partition
after another.  Global combination is explicit (``reduce``,
``matrix_batch_map`` + a reduce), the paper's shared-nothing principle.
Mesh mode waits for the ``torch.distributed`` slice.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import partition as pt
from repro_torch.core.local_matrix import LocalMatrix
from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = ["MLNumericTable"]


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


class MLNumericTable:
    """Row-partitioned numeric table; the input type of MLI algorithms.

    ``MLNumericTable(tensor, num_shards)`` wraps a tensor where it lies,
    without a copy — how a table larger than host memory is made on the
    card; :meth:`from_numpy` copies a host array to a device.  ``names``
    are the column names (an ``MLTable``'s schema names after
    ``to_numeric``), read by the featurizers' label and bias skips."""

    def __init__(self, data: torch.Tensor, num_shards: int = 1,
                 names: Optional[Sequence[Optional[str]]] = None) -> None:
        if data.ndim != 2:
            raise ValueError("MLNumericTable holds a 2-D (rows, features) array")
        pt.check_rows_divisible(data.shape[0], num_shards)
        self.data = data
        self.num_shards = int(num_shards)
        self.names = tuple(names) if names is not None else None

    @classmethod
    def from_numpy(cls, array: np.ndarray, num_shards: Optional[int] = None,
                   device: DeviceLike = None,
                   names: Optional[Sequence[Optional[str]]] = None
                   ) -> "MLNumericTable":
        """Copy a host array to ``device`` (the CUDA card unless
        ``device="cpu"``); float64 arrives as float32, as in the reference."""
        return cls(to_tensor(array, resolve_device(device)),
                   num_shards=num_shards or 1, names=names)

    def _like(self, data: torch.Tensor, names=None) -> "MLNumericTable":
        return MLNumericTable(data, num_shards=self.num_shards, names=names)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

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
        return self.data.cpu().numpy()

    def to_local_matrix(self) -> LocalMatrix:
        """Materialize the *whole* table as one LocalMatrix (small tables /
        final factors only — deliberately explicit, per the paper's refusal
        to hide global operations)."""
        return LocalMatrix(self.data)

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
        ops take the mask, as in the reference)."""
        return torch.vmap(pred)(self.data)

    def reduce(self, fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
               identity: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Combine all rows with an associative+commutative fn (Fig. A1).

        Reduces within each partition, then across partitions — matching the
        distributed execution order."""
        if identity is None:
            identity = torch.zeros((self.num_cols,), dtype=self.data.dtype,
                                   device=self.device)
        blocks = pt.partition_rows(self.data, self.num_shards)
        partials = torch.stack([_tree_fold_rows(b, fn, identity) for b in blocks])
        return _tree_fold_rows(partials, fn, identity)

    def sum_rows(self) -> torch.Tensor:
        return torch.sum(self.data, dim=0)

    def mean_rows(self) -> torch.Tensor:
        return torch.mean(self.data, dim=0)

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
        number of rows for every partition.
        """
        outs = []
        for block in pt.partition_rows(self.data, self.num_shards):
            out = fn(LocalMatrix(block), *broadcast_args)
            out = out.data if isinstance(out, LocalMatrix) else torch.as_tensor(out)
            outs.append(out[:, None] if out.ndim == 1 else out)
        return self._like(pt.unpartition_rows(torch.stack(outs)))

    matrixBatchMap = matrix_batch_map  # paper spelling

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MLNumericTable(rows={self.num_rows}, cols={self.num_cols}, "
                f"shards={self.num_shards}, device={self.device})")
