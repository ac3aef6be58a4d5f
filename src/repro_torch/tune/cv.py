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
    the partition count (and the mesh) when the view's rows still divide
    it, or
  * a **stream view**: :meth:`repro_torch.data.pipeline.BatchIterator.
    restrict` applies the same gather to every window the source yields.

A view of a mesh table lays its rows out as any mesh table: view row ``i``
(table row ``indices[i]``) belongs to host ``i // (m/H)``, the
process-major blocks of :func:`repro_torch.core.hostmesh.local_row_slice`.
A host takes the rows it owns in the table from its own data and the rest
from their owners in one ``all_to_all`` a view (under gloo a CUDA tensor
crosses through pinned host buffers, ``HostMesh.staged``; where no row
changes host, as at a world of one, nothing crosses).  Where the view's
rows do not divide the partitions, the view is one partition held whole by
every host, which then computes on it redundantly (ROADMAP.md, Queue 3).
``fold_view.rows_moved`` and ``fold_view.bytes_moved`` count the rows and
bytes views moved between hosts (every host's receipts, the same count on
every host), as the kernels count their launches.

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


def fold_view(table: Any, indices: np.ndarray, *, whole: bool = False) -> Any:
    """An MLNumericTable of ``table``'s rows at ``indices`` (in the order
    given), gathered by ``index_select`` on the table's device.  The view
    keeps the table's partition count (and its mesh) when its rows divide
    it, else it is one partition (the reference's fallback); on a mesh that
    partition is held whole by every host.  ``whole=True`` asks for the
    one-partition view in any case (a search's layout when a train view
    cannot fill its partitions)."""
    from repro_torch.core.numeric_table import MLNumericTable

    idx = np.asarray(indices, dtype=np.int64)
    names = getattr(table, "names", None)
    keep = not whole and idx.shape[0] % table.num_shards == 0
    mesh = getattr(table, "mesh", None)
    if mesh is None:
        rows = table.data.index_select(0, torch.as_tensor(idx, device=table.data.device))
        return MLNumericTable(rows, num_shards=table.num_shards if keep else 1,
                              names=names)
    hosts = mesh.num_hosts
    if keep:
        per = idx.shape[0] // hosts
        need = [np.arange(h * per, (h + 1) * per) for h in range(hosts)]
        return MLNumericTable(_exchange_rows(table, idx, need), names=names, mesh=mesh)
    need = [np.arange(idx.shape[0])] * hosts
    return MLNumericTable(_exchange_rows(table, idx, need), names=names)


def _exchange_rows(table: Any, idx: np.ndarray, need: list) -> torch.Tensor:
    """This host's rows of a view of a mesh table: ``need[h]`` are the view
    positions host ``h`` holds (view position ``i`` is table row
    ``idx[i]``, owned by host ``idx[i] // (n/H)``).  Owned rows come from
    this host's data, the rest from their owners in one ``all_to_all``;
    the plan is a function of ``idx`` and the layout, so every host makes
    the same one."""
    from repro_torch.core.collectives import all_to_all_rows

    mesh, data = table.mesh, table.data
    me, local = mesh.host_id, data.shape[0]
    owner = [idx[n] // local for n in need]
    mine = need[me]
    out = data.new_empty((mine.shape[0],) + tuple(data.shape[1:]))
    own = owner[me] == me

    def rows_of(positions: np.ndarray) -> torch.Tensor:
        return data.index_select(0, torch.as_tensor(idx[positions] - me * local,
                                                    device=data.device))

    out[torch.as_tensor(np.flatnonzero(own), device=data.device)] = rows_of(mine[own])
    moved = sum(int(np.sum(o != h)) for h, o in enumerate(owner))
    if moved:
        send = [rows_of(n[o == me]) if h != me else data[:0]
                for h, (n, o) in enumerate(zip(need, owner))]
        recv_counts = [int(np.sum(owner[me] == h)) if h != me else 0
                       for h in range(mesh.num_hosts)]
        got = all_to_all_rows(mesh, send, recv_counts)
        ofs = 0
        for h, count in enumerate(recv_counts):
            if count:
                at = np.flatnonzero(owner[me] == h)
                out[torch.as_tensor(at, device=data.device)] = got[ofs:ofs + count]
                ofs += count
        fold_view.rows_moved += moved
        fold_view.bytes_moved += moved * data[0].numel() * data.element_size()
    return out


fold_view.rows_moved = 0
fold_view.bytes_moved = 0
