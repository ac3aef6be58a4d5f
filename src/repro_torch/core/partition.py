"""Row partitioning of numeric data (paper §III-A), emulated mode.

Counterpart: ``src/repro/core/partition.py`` (``check_rows_divisible``,
``partition_rows``, ``unpartition_rows``).  A (rows, ...) tensor maps onto
``num_shards`` equal, contiguous row blocks, viewed as one
``(num_shards, rows_per_shard, ...)`` tensor — the partition dimension the
port writes out where the reference ``vmap``s over blocks.  Mesh placement
waits for the ``torch.distributed`` slice.
"""
from __future__ import annotations

import torch

__all__ = ["check_rows_divisible", "partition_rows", "unpartition_rows"]


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
