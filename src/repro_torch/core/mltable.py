"""Host-tier MLTable (paper §III-A, API table Fig. A1).

Counterpart: ``src/repro/core/mltable.py``.  This is the ETL / feature
extraction tier: rows live in host memory, partitioned into
``num_partitions`` contiguous chunks that model the distributed
partitioning of the Spark implementation.  Once featurized, a table whose
schema is fully numeric is committed to the device tier with
:meth:`MLTable.to_numeric`, producing an :class:`~repro_torch.core.
numeric_table.MLNumericTable` on the CUDA card (or on the CPU when the
caller passes ``device="cpu"``); from there on all compute is PyTorch.

Supported operations follow Fig. A1 of the paper:

    project, union, filter, join, map, flatMap, reduce, reduceByKey,
    matrixBatchMap (on the numeric tier), numRows, numCols

One deviation in storage, none in values: a partition that a count
featurizer (``features.text``) produced is a :class:`CountRows`, which
keeps each row's non-zero counts as (column, count) pairs instead of one
Python float per vocabulary column.  At the paper's width (30,000 bigrams)
the reference's rows hold ~10⁹ Python floats for 32,768 documents;
:class:`CountRows` builds each :class:`MLRow` only when it is read, with
the reference's values, and :meth:`MLTable.to_numeric` scatters the counts
into the dense table on the device without building a row.
"""
from __future__ import annotations

import itertools
from collections.abc import Sequence as SequenceABC
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from repro_torch.core.schema import ColumnType, MLRow, Schema
from repro_torch.device import DeviceLike, resolve_device

__all__ = ["MLTable", "CountRows"]


def _chunk(rows: List[MLRow], num_partitions: int) -> List[List[MLRow]]:
    """Split rows into contiguous, nearly-equal partitions (Spark-style)."""
    n = len(rows)
    num_partitions = max(1, num_partitions)
    base, extra = divmod(n, num_partitions)
    out, start = [], 0
    for p in range(num_partitions):
        size = base + (1 if p < extra else 0)
        out.append(rows[start : start + size])
        start += size
    return out


class CountRows(SequenceABC):
    """One partition of a count table: per row, its passthrough cells and
    the non-zero (feature column, count) pairs of its feature columns.

    A sequence of :class:`MLRow` like a plain partition: indexing or
    iterating builds each row (passthrough cells, then one float per
    feature column, 0.0 where the row has no count), so every relational
    operation reads the reference's values.  ``indptr`` (rows + 1,) bounds
    each row's pairs in ``cols`` / ``counts`` (CSR layout); ``width`` is the
    number of feature columns, which follow the passthrough ones."""

    def __init__(self, schema: Schema, width: int,
                 passthrough: Sequence[Tuple[Any, ...]], indptr: np.ndarray,
                 cols: np.ndarray, counts: np.ndarray) -> None:
        self.schema = schema
        self.width = int(width)          # the feature columns, after the rest
        self.passthrough = list(passthrough)
        self.indptr = np.asarray(indptr, np.int64)
        self.cols = np.asarray(cols, np.int64)
        self.counts = np.asarray(counts, np.float64)
        if self.indptr.shape != (len(self.passthrough) + 1,):
            raise ValueError("indptr must hold one bound more than the rows")

    def __len__(self) -> int:
        return len(self.passthrough)

    def _row(self, i: int) -> MLRow:
        vec = [0.0] * self.width
        a, b = self.indptr[i], self.indptr[i + 1]
        for j, c in zip(self.cols[a:b].tolist(), self.counts[a:b].tolist()):
            vec[j] = c
        return MLRow(tuple(self.passthrough[i]) + tuple(vec), self.schema)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._row(j) for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError("row index out of range")
        return self._row(i)

    def __iter__(self):
        return (self._row(i) for i in range(len(self)))


def _scatter_counts(parts: Sequence[CountRows], ncols: int,
                    device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The dense (rows, ncols) table of count partitions, made on
    ``device``: the passthrough cells (as ``MLRow.to_floats`` gives them)
    in the first columns, each count at its (row, column)."""
    n = sum(len(p) for p in parts)
    npass = ncols - parts[0].width
    if any(p.width != parts[0].width for p in parts):
        raise ValueError("count partitions of different widths")
    data = torch.zeros((n, ncols), dtype=dtype, device=device)
    if npass and n:
        cells = np.asarray([MLRow(t).to_floats() for p in parts
                            for t in p.passthrough], np.float64)
        data[:, :npass] = torch.as_tensor(cells, dtype=dtype).to(device)
    rows, cols, counts, ofs = [], [], [], 0
    for p in parts:
        rows.append(ofs + np.repeat(np.arange(len(p), dtype=np.int64),
                                    np.diff(p.indptr)))
        cols.append(p.cols)
        counts.append(p.counts)
        ofs += len(p)
    flat = np.concatenate(rows) * ncols + npass + np.concatenate(cols)
    data.view(-1)[torch.as_tensor(flat).to(device)] = torch.as_tensor(
        np.concatenate(counts), dtype=dtype).to(device)
    return data


class MLTable:
    """A schema'd collection of rows, partitioned for data-local operation."""

    def __init__(
        self,
        partitions: Sequence[Sequence[MLRow]],
        schema: Schema,
        validate: bool = False,
    ) -> None:
        self._partitions: List[Sequence[MLRow]] = [
            p if isinstance(p, CountRows) else list(p) for p in partitions]
        self.schema = schema
        if validate:
            for row in self.rows():
                schema.validate_row(row)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_rows(
        cls,
        rows: Iterable[Sequence[Any]],
        schema: Optional[Schema] = None,
        names: Optional[Sequence[str]] = None,
        num_partitions: int = 4,
    ) -> "MLTable":
        materialized = [tuple(r) for r in rows]
        if not materialized and schema is None:
            raise ValueError("cannot infer schema from an empty table")
        if schema is None:
            schema = Schema.infer_from_row(materialized[0], names=names)
        mlrows = [MLRow(r, schema) for r in materialized]
        return cls(_chunk(mlrows, num_partitions), schema, validate=True)

    @classmethod
    def from_numpy(cls, array: np.ndarray, num_partitions: int = 4,
                   names: Optional[Sequence[str]] = None) -> "MLTable":
        if array.ndim != 2:
            raise ValueError("from_numpy expects a 2-D array")
        schema = Schema.of(*([ColumnType.SCALAR] * array.shape[1]), names=names)
        rows = [MLRow(tuple(float(v) for v in row), schema) for row in array]
        return cls(_chunk(rows, num_partitions), schema)

    @classmethod
    def from_text(cls, lines: Iterable[str], num_partitions: int = 4) -> "MLTable":
        """The paper's ``mc.textFile`` entry point: one STRING column per line."""
        schema = Schema.of(ColumnType.STRING, names=["text"])
        rows = [MLRow((ln.rstrip("\n"),), schema) for ln in lines]
        return cls(_chunk(rows, num_partitions), schema)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    @property
    def partitions(self) -> List[Sequence[MLRow]]:
        return self._partitions

    def rows(self) -> Iterable[MLRow]:
        return itertools.chain.from_iterable(self._partitions)

    def collect(self) -> List[MLRow]:
        return list(self.rows())

    @property
    def num_rows(self) -> int:
        return sum(len(p) for p in self._partitions)

    @property
    def num_cols(self) -> int:
        return len(self.schema)

    # Fig A1 spells these numRows/numCols; keep aliases for API fidelity.
    numRows = num_rows
    numCols = num_cols

    # ------------------------------------------------------------------ #
    # relational operations (Fig. A1)
    # ------------------------------------------------------------------ #
    def _index(self, col: Any) -> int:
        return self.schema.index_of(col) if isinstance(col, str) else int(col)

    def project(self, indices: Sequence[Any]) -> "MLTable":
        """Select a subset of columns (by index or name)."""
        idx = [self._index(i) for i in indices]
        schema = self.schema.project(idx)
        parts = [[MLRow((r[i] for i in idx), schema) for r in p] for p in self._partitions]
        return MLTable(parts, schema)

    def union(self, other: "MLTable") -> "MLTable":
        if self.schema != other.schema:
            raise TypeError("union requires identical schemas")
        return MLTable(self._partitions + other._partitions, self.schema)

    def filter(self, pred: Callable[[MLRow], bool]) -> "MLTable":
        parts = [[r for r in p if pred(r)] for p in self._partitions]
        return MLTable(parts, self.schema)

    def join(self, other: "MLTable", on: Sequence[Any]) -> "MLTable":
        """Inner hash-join on shared columns (paper: join(MLTable, Seq[Index]))."""
        left_idx = [self._index(i) for i in on]
        right_idx = [other._index(i) for i in on]
        right_keep = [j for j in range(len(other.schema)) if j not in right_idx]
        schema = Schema(
            tuple(self.schema.columns) + tuple(other.schema.columns[j] for j in right_keep)
        )
        table: Dict[Tuple[Any, ...], List[MLRow]] = {}
        for r in other.rows():
            table.setdefault(tuple(r[j] for j in right_idx), []).append(r)
        parts: List[List[MLRow]] = []
        for p in self._partitions:
            out = []
            for r in p:
                for match in table.get(tuple(r[i] for i in left_idx), ()):  # inner join
                    out.append(MLRow(tuple(r) + tuple(match[j] for j in right_keep), schema))
            parts.append(out)
        return MLTable(parts, schema)

    # ------------------------------------------------------------------ #
    # MapReduce operations (Fig. A1)
    # ------------------------------------------------------------------ #
    def map(self, fn: Callable[[MLRow], Sequence[Any]],
            schema: Optional[Schema] = None) -> "MLTable":
        parts: List[List[MLRow]] = []
        for p in self._partitions:
            out = []
            for r in p:
                v = fn(r)
                if schema is None:
                    schema = Schema.infer_from_row(tuple(v))
                out.append(MLRow(tuple(v), schema))
            parts.append(out)
        if schema is None:  # empty table
            schema = self.schema
        return MLTable(parts, schema)

    def flat_map(self, fn: Callable[[MLRow], Iterable[Sequence[Any]]],
                 schema: Optional[Schema] = None) -> "MLTable":
        parts: List[List[MLRow]] = []
        for p in self._partitions:
            out = []
            for r in p:
                for v in fn(r):
                    if schema is None:
                        schema = Schema.infer_from_row(tuple(v))
                    out.append(MLRow(tuple(v), schema))
            parts.append(out)
        if schema is None:
            schema = self.schema
        return MLTable(parts, schema)

    flatMap = flat_map  # paper spelling

    def reduce(self, fn: Callable[[MLRow, MLRow], Sequence[Any]]) -> MLRow:
        """Tree-combine all rows with an associative, commutative function.

        Mirrors the distributed semantics: reduce within each partition first,
        then across partition results.
        """
        partials = []
        for p in self._partitions:
            if not len(p):
                continue
            acc = p[0]
            for r in p[1:]:
                acc = MLRow(tuple(fn(acc, r)), self.schema)
            partials.append(acc)
        if not partials:
            raise ValueError("reduce of empty table")
        acc = partials[0]
        for r in partials[1:]:
            acc = MLRow(tuple(fn(acc, r)), self.schema)
        return acc

    def reduce_by_key(self, key_col: Any,
                      fn: Callable[[MLRow, MLRow], Sequence[Any]]) -> "MLTable":
        key_idx = self._index(key_col)
        groups: Dict[Any, MLRow] = {}
        for r in self.rows():
            k = r[key_idx]
            if k in groups:
                groups[k] = MLRow(tuple(fn(groups[k], r)), self.schema)
            else:
                groups[k] = r
        rows = list(groups.values())
        return MLTable(_chunk(rows, self.num_partitions), self.schema)

    reduceByKey = reduce_by_key  # paper spelling

    # ------------------------------------------------------------------ #
    # commit to device tier
    # ------------------------------------------------------------------ #
    def _dense(self, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
        """The table as a dense (rows, cols) tensor of ``MLRow.to_floats``
        values on ``device``: count partitions scattered there, other rows
        converted on the host, as in the reference."""
        if self._partitions and all(isinstance(p, CountRows) for p in self._partitions):
            return _scatter_counts(self._partitions, self.num_cols, device, dtype)
        data = np.asarray([r.to_floats() for r in self.rows()], np.float64)
        return torch.as_tensor(data.reshape(-1, self.num_cols), dtype=dtype).to(device)

    def to_numeric(self, num_shards: Optional[int] = None,
                   device: DeviceLike = None, dtype: torch.dtype = torch.float32):
        """Cast to MLNumericTable (paper §III-A) on ``device`` (the CUDA
        card unless ``device="cpu"``), split into ``num_shards`` partitions.

        Every column must be numeric; Empty cells become NaN (algorithms are
        expected to impute/filter first — matching the paper's convention that
        Empty is represented by a special value).
        """
        if not self.schema.is_numeric:
            bad = [c for c in self.schema.columns if not c.ctype.is_numeric]
            raise TypeError(f"non-numeric columns present: {bad}")
        from repro_torch.core.numeric_table import MLNumericTable  # avoids a cycle

        return MLNumericTable(self._dense(resolve_device(device), dtype),
                              num_shards=num_shards or 1, names=self.schema.names)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"MLTable(rows={self.num_rows}, cols={self.num_cols}, "
            f"partitions={self.num_partitions}, schema={[c.ctype.value for c in self.schema.columns]})"
        )
