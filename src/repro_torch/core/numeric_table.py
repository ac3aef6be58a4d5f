"""Device-tier MLNumericTable (paper §III-A), emulated mode.

Counterpart: ``src/repro/core/numeric_table.py``.  An MLNumericTable is the
all-numeric table most algorithms consume: each row is one feature vector.
Here it is a 2-D tensor on one device, split into ``num_shards`` logical row
partitions; :class:`repro_torch.core.runner.DistributedRunner` views it as
one ``(num_shards, rows_per_shard, cols)`` tensor.  Column names,
``LocalMatrix``, ``map_rows``, ``reduce`` and ``matrix_batch_map`` wait for
a later slice.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import partition as pt
from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = ["MLNumericTable"]


class MLNumericTable:
    """Row-partitioned numeric table; the input type of MLI algorithms.

    ``MLNumericTable(tensor, num_shards)`` wraps a tensor where it lies,
    without a copy — how a table larger than host memory is made on the
    card; :meth:`from_numpy` copies a host array to a device."""

    def __init__(self, data: torch.Tensor, num_shards: int = 1) -> None:
        if data.ndim != 2:
            raise ValueError("MLNumericTable holds a 2-D (rows, features) array")
        pt.check_rows_divisible(data.shape[0], num_shards)
        self.data = data
        self.num_shards = int(num_shards)

    @classmethod
    def from_numpy(cls, array: np.ndarray, num_shards: Optional[int] = None,
                   device: DeviceLike = None) -> "MLNumericTable":
        """Copy a host array to ``device`` (the CUDA card unless
        ``device="cpu"``); float64 arrives as float32, as in the reference."""
        return cls(to_tensor(array, resolve_device(device)),
                   num_shards=num_shards or 1)

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

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MLNumericTable(rows={self.num_rows}, cols={self.num_cols}, "
                f"shards={self.num_shards}, device={self.device})")
