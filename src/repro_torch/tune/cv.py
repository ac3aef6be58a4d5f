"""Cross-validation splitters as row-index views.

Counterpart: ``src/repro/tune/cv.py`` (``KFold``, ``holdout_split``,
``take_rows``, ``fold_view``).  The index code is the reference's numpy
code, copied: for every ``(num_rows, k, seed)`` the folds are the same
arrays, which is what lets a search resumed in either package re-derive
the other's splits.

A fold is a sorted array of row indices.  :class:`KFold` shuffles
``range(num_rows)`` with a seeded numpy generator and deals the
permutation into k near-equal folds.  A split materializes as

  * a **table view**: :func:`fold_view` gathers an
    :class:`repro_torch.core.numeric_table.MLNumericTable`'s rows with one
    ``index_select`` on the table's device (no host round trip), keeping
    the partition count when the view's rows still divide it, or
  * a **stream view**: :meth:`repro_torch.data.pipeline.BatchIterator.
    restrict` applies the same gather to every window the source yields.

:func:`holdout_split` keeps the reference's refusal when
``ceil(val_fraction * num_rows) == num_rows`` (no train rows left), which
also refuses some fractions < 1 on small tables (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Tuple

import numpy as np
import torch

__all__ = ["KFold", "fold_view", "holdout_split", "take_rows"]


@dataclasses.dataclass(frozen=True)
class KFold:
    """Deterministic k-fold assignment over ``num_rows`` rows: the seeded
    permutation dealt into ``k`` folds whose sizes differ by at most one
    row; indices within each split sorted ascending.  A pure function of
    ``(num_rows, k, seed)``."""

    num_rows: int
    k: int
    seed: int = 0

    def __post_init__(self) -> None:
        if not 2 <= self.k <= self.num_rows:
            raise ValueError(
                f"need 2 <= k <= num_rows, got k={self.k}, "
                f"num_rows={self.num_rows}")
        perm = np.random.default_rng(self.seed).permutation(self.num_rows)
        fold_of = np.empty(self.num_rows, dtype=np.int64)
        for i, chunk in enumerate(np.array_split(perm, self.k)):
            fold_of[chunk] = i
        # frozen dataclass: the cached assignment is derived state, not a field
        object.__setattr__(self, "_fold_of", fold_of)

    def _assignment(self) -> np.ndarray:
        """(num_rows,) fold id per row — the permutation dealt in order."""
        return self._fold_of

    def val_indices(self, fold: int) -> np.ndarray:
        """Sorted row indices of validation fold ``fold``."""
        self._check_fold(fold)
        return np.flatnonzero(self._assignment() == fold)

    def train_indices(self, fold: int) -> np.ndarray:
        """Sorted row indices of every fold except ``fold``."""
        self._check_fold(fold)
        return np.flatnonzero(self._assignment() != fold)

    def split(self, fold: int) -> Tuple[np.ndarray, np.ndarray]:
        """(train_indices, val_indices) of one fold."""
        self._check_fold(fold)
        fold_of = self._assignment()
        return np.flatnonzero(fold_of != fold), np.flatnonzero(fold_of == fold)

    def splits(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Iterate all k (train_indices, val_indices) pairs."""
        fold_of = self._assignment()
        for i in range(self.k):
            yield np.flatnonzero(fold_of != i), np.flatnonzero(fold_of == i)

    def _check_fold(self, fold: int) -> None:
        if not 0 <= fold < self.k:
            raise ValueError(f"fold must be in [0, {self.k}), got {fold}")


def holdout_split(num_rows: int, val_fraction: float = 0.25, seed: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """One deterministic (train_indices, val_indices) split with
    ``ceil(val_fraction * num_rows)`` validation rows."""
    if not 0.0 < val_fraction < 1.0:
        raise ValueError(f"val_fraction must be in (0, 1), got {val_fraction}")
    n_val = math.ceil(num_rows * val_fraction)
    if not 0 < n_val < num_rows:
        raise ValueError(
            f"val_fraction {val_fraction} leaves no rows for one of the "
            f"splits of {num_rows}")
    perm = np.random.default_rng(seed).permutation(num_rows)
    return np.sort(perm[n_val:]), np.sort(perm[:n_val])


def take_rows(table: Any, indices: np.ndarray) -> Any:
    """Row view of any table tier: an :class:`repro_torch.core.mltable.
    MLTable` is gathered on the host (schema and partition count kept) —
    the view pipeline featurizers fit on in a fold-aware search — while
    numeric tables delegate to :func:`fold_view`."""
    from repro_torch.core.mltable import MLTable, _chunk

    if isinstance(table, MLTable):
        rows = table.collect()
        sel = [rows[int(i)] for i in np.asarray(indices)]
        return MLTable(_chunk(sel, table.num_partitions), table.schema)
    return fold_view(table, indices)


def fold_view(table: Any, indices: np.ndarray) -> Any:
    """An MLNumericTable of ``table``'s rows at ``indices`` (in the order
    given), gathered by ``index_select`` on the table's device.  The view
    keeps the table's partition count when its rows divide it, else it is
    one partition (the reference's emulated fallback)."""
    from repro_torch.core.numeric_table import MLNumericTable

    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64),
                          device=table.data.device)
    rows = table.data.index_select(0, idx)
    num_shards = table.num_shards if rows.shape[0] % table.num_shards == 0 else 1
    return MLNumericTable(rows, num_shards=num_shards,
                          names=getattr(table, "names", None))
