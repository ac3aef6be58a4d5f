"""Text featurization (paper §III-A, Fig. A2) — fitted transformers.

Counterpart: ``src/repro/features/text.py`` (``NGrams``,
``HashingVectorizer``, ``TfIdf`` and the ``n_grams`` / ``tf_idf`` /
``hashing_vectorizer`` shims).  The paper's pipeline
``nGrams(rawText, n=2, top=30000) → tfIdf(...)`` as transformers whose
corpus statistics are computed once at ``fit`` and *replayed* at
``transform``:

  * :class:`NGrams` — fits the vocabulary (the corpus's ``top`` most
    frequent n-grams, ties to the gram met first in partition order, as
    ``Counter.most_common`` orders them); transform maps any table (or raw
    serving row) onto that fixed vocabulary.
  * :class:`TfIdf` — fits document frequencies (→ IDF weights) with one
    reduce; transform is the per-row map ``tf * idf`` on the device tier.
  * :class:`HashingVectorizer` — the stateless variant (a CRC32 of each
    gram, so replay is identical across processes).

The tokenizer, the grams, the hash and the column names (``ng:<gram>``)
are the reference's.  A count transform's table keeps each partition as
:class:`~repro_torch.core.mltable.CountRows` (each row's non-zero counts),
whose rows read the reference's values and which ``to_numeric`` scatters
into the dense table on the device.  Non-target columns (labels) pass
through in their original order ahead of the generated feature columns.
"""
from __future__ import annotations

import re
import zlib
from collections import Counter
from typing import Any, Callable, List, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.interfaces import FittedTransformer, Transformer
from repro_torch.core.mltable import CountRows, MLTable
from repro_torch.core.numeric_table import MLNumericTable, column_sums
from repro_torch.core.schema import Column, ColumnType, Schema
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.features.scaling import (
    SkipSpec,
    _feature_cols,
    _state_tensor,
    resolve_labels,
    resolve_skip,
)

__all__ = [
    "NGrams", "FittedNGrams",
    "TfIdf", "FittedTfIdf",
    "HashingVectorizer", "FittedHashingVectorizer",
    "n_grams", "tf_idf", "hashing_vectorizer",
]

_TOKEN = re.compile(r"[a-z0-9']+")

# a row's counts: (feature columns, counts), one pair per non-zero column
RowCounts = Callable[[str], Tuple[List[int], List[int]]]


def _tokens(text: str) -> List[str]:
    return _TOKEN.findall(text.lower())


def _grams(text: str, n: int) -> List[str]:
    toks = _tokens(text)
    return [" ".join(toks[i: i + n]) for i in range(len(toks) - n + 1)]


def _stable_hash(gram: str) -> int:
    """Process-independent gram hash (python's ``hash`` is salted per
    interpreter, which would break replay in another process)."""
    return zlib.crc32(gram.encode("utf-8"))


def _text_col(table: MLTable, column: Union[int, str]) -> int:
    return (table.schema.index_of(column) if isinstance(column, str)
            else int(column))


def _passthrough_idx(table: MLTable, col: int, keep_columns: bool
                     ) -> Tuple[int, ...]:
    if not keep_columns:
        return ()
    return tuple(i for i in range(table.num_cols) if i != col)


def _count_table(table: MLTable, col: int, passthrough: Tuple[int, ...],
                 feat_names: Sequence[str], row_counts: RowCounts) -> MLTable:
    """Rebuild a table: passthrough columns (original order) + generated
    count columns, preserving the partition layout; each partition a
    :class:`CountRows`."""
    in_cols = table.schema.columns
    schema = Schema(
        tuple(in_cols[i] for i in passthrough)
        + tuple(Column(ColumnType.SCALAR, n) for n in feat_names))
    parts = []
    for p in table.partitions:
        cells, indptr, cols, counts = [], [0], [], []
        for row in p:
            cells.append(tuple(row[i] for i in passthrough))
            c, v = row_counts(str(row[col]))
            cols.extend(c)
            counts.extend(v)
            indptr.append(len(cols))
        parts.append(CountRows(schema, len(feat_names), cells, indptr,
                               cols, counts))
    return MLTable(parts, schema)


def _count_matrix(rows: Any, width: int, row_counts: RowCounts) -> np.ndarray:
    """Raw serving rows (a str or sequence of str) → (n, width) fp32
    count matrix."""
    if isinstance(rows, str):
        rows = [rows]
    out = np.zeros((len(rows), width), np.float32)
    for i, r in enumerate(rows):
        c, v = row_counts(str(r))
        out[i, c] = v
    return out


class FittedNGrams(FittedTransformer):
    """Replay a fitted n-gram vocabulary over tables or raw text rows."""

    tier = "host"

    def __init__(self, vocab: Sequence[str], n: int, column: Union[int, str],
                 keep_columns: bool = True) -> None:
        self.vocab = list(vocab)
        self.n = int(n)
        self.column = column
        self.keep_columns = bool(keep_columns)
        self._index = {g: i for i, g in enumerate(self.vocab)}

    def _counts(self, text: str) -> Tuple[List[int], List[int]]:
        index = self._index
        cols, counts = [], []
        for gram, c in Counter(_grams(text, self.n)).items():
            j = index.get(gram)
            if j is not None:
                cols.append(j)
                counts.append(c)
        return cols, counts

    def transform(self, table: MLTable) -> MLTable:
        col = _text_col(table, self.column)
        passthrough = _passthrough_idx(table, col, self.keep_columns)
        # generated columns are namespaced (``ng:<gram>``) so a corpus that
        # happens to contain the token "label" or "bias" can never collide
        # with the auto-skip names of the passthrough columns; the seed
        # shim (keep_columns=False) keeps raw gram names for fidelity
        names = ([f"ng:{g}" for g in self.vocab] if self.keep_columns
                 else list(self.vocab))
        return _count_table(table, col, passthrough, names, self._counts)

    def transform_rows(self, rows: Any) -> np.ndarray:
        """Raw serving rows (a str or sequence of str) → (n, |vocab|)
        count matrix — the vocab-lookup step of a served pipeline."""
        return _count_matrix(rows, len(self.vocab), self._counts)

    def host_state(self) -> dict:
        return {"kind": "ngrams", "vocab": list(self.vocab), "n": self.n,
                "column": self.column, "keep_columns": self.keep_columns}

    @staticmethod
    def partial_template(host_state: dict) -> dict:
        return {}

    @classmethod
    def from_state(cls, host_state: dict, partial: dict,
                   device: DeviceLike = None) -> "FittedNGrams":
        return cls(host_state["vocab"], host_state["n"], host_state["column"],
                   host_state["keep_columns"])


class NGrams(Transformer):
    """Fit the corpus's ``top`` most frequent n-grams of one STRING column
    (Fig. A2 ``nGrams(rawTextTable, n=2, top=30000)``); transform emits one
    SCALAR count column per vocabulary gram, after the passthrough columns.
    """

    tier = "host"

    def __init__(self, n: int = 2, top: int = 30000,
                 column: Union[int, str] = 0, keep_columns: bool = True
                 ) -> None:
        self.n = int(n)
        self.top = int(top)
        self.column = column
        self.keep_columns = bool(keep_columns)
        self._config = {"n": n, "top": top, "column": column,
                        "keep_columns": keep_columns}

    def fit(self, table: MLTable, default_skip: Sequence[int] = ()
            ) -> FittedNGrams:
        col = _text_col(table, self.column)
        corpus: Counter = Counter()
        # counting a row's grams in order inserts each new gram where the
        # reference's per-row Counter update does: at its first occurrence
        for row in table.rows():
            corpus.update(_grams(str(row[col]), self.n))
        vocab = [g for g, _ in corpus.most_common(self.top)]
        return FittedNGrams(vocab, self.n, self.column, self.keep_columns)


class FittedHashingVectorizer(FittedTransformer):
    """Replay feature hashing (stateless statistics, fixed configuration)."""

    tier = "host"

    def __init__(self, num_features: int, n: int, column: Union[int, str],
                 keep_columns: bool = True) -> None:
        self.num_features = int(num_features)
        self.n = int(n)
        self.column = column
        self.keep_columns = bool(keep_columns)

    def _counts(self, text: str) -> Tuple[List[int], List[int]]:
        buckets = Counter(_stable_hash(g) % self.num_features
                          for g in _grams(text, self.n))
        return list(buckets), list(buckets.values())

    def transform(self, table: MLTable) -> MLTable:
        col = _text_col(table, self.column)
        passthrough = _passthrough_idx(table, col, self.keep_columns)
        names = [f"h{i}" for i in range(self.num_features)]
        return _count_table(table, col, passthrough, names, self._counts)

    def transform_rows(self, rows: Any) -> np.ndarray:
        return _count_matrix(rows, self.num_features, self._counts)

    def host_state(self) -> dict:
        return {"kind": "hashing", "num_features": self.num_features,
                "n": self.n, "column": self.column,
                "keep_columns": self.keep_columns}

    @staticmethod
    def partial_template(host_state: dict) -> dict:
        return {}

    @classmethod
    def from_state(cls, host_state: dict, partial: dict,
                   device: DeviceLike = None) -> "FittedHashingVectorizer":
        return cls(host_state["num_features"], host_state["n"],
                   host_state["column"], host_state["keep_columns"])


class HashingVectorizer(Transformer):
    """Stateless n-gram → bucket counts (streaming-friendly; no corpus
    pass, so ``fit`` only freezes the configuration)."""

    tier = "host"

    def __init__(self, num_features: int = 1024, n: int = 1,
                 column: Union[int, str] = 0, keep_columns: bool = True
                 ) -> None:
        self.num_features = int(num_features)
        self.n = int(n)
        self.column = column
        self.keep_columns = bool(keep_columns)
        self._config = {"num_features": num_features, "n": n,
                        "column": column, "keep_columns": keep_columns}

    def fit(self, table: MLTable, default_skip: Sequence[int] = ()
            ) -> FittedHashingVectorizer:
        return FittedHashingVectorizer(self.num_features, self.n, self.column,
                                       self.keep_columns)


class FittedTfIdf(FittedTransformer):
    """Replay fitted IDF weights: per row, ``tf = count / row_total`` over
    the feature columns, output ``tf * idf``.  Skipped columns (labels,
    bias) pass through; :meth:`apply` replays on label-free serving rows —
    only the *label* columns are absent there, other skipped columns are
    present and pass through as identities.

    A row's total adds its counts, integers, so it is exact in fp32 in any
    order while it stays below 2²⁴: a served row gets its table row's
    bits."""

    tier = "device"

    def __init__(self, idf: Any, skip_idx: Tuple[int, ...], num_cols: int,
                 label_idx: Tuple[int, ...] = (),
                 device: DeviceLike = None) -> None:
        self.idf = _state_tensor(idf, device)   # full table width; skips carry 0
        self.skip_idx = tuple(int(i) for i in skip_idx)
        self.label_idx = tuple(int(i) for i in label_idx)
        self.num_cols = int(num_cols)
        # serving-row columns = everything except the labels
        self._feat = _feature_cols(self.num_cols, self.label_idx)
        self._full = self._operands(np.arange(self.num_cols))
        self._serve = self._operands(self._feat)

    def _operands(self, cols: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mask, idf) over the columns ``cols`` of the rows applied to:
        mask 1.0 at true feature columns and 0.0 at skips."""
        skip = set(self.skip_idx)
        mask = torch.as_tensor([0.0 if int(c) in skip else 1.0 for c in cols],
                               dtype=self.idf.dtype, device=self.idf.device)
        idx = torch.as_tensor(cols, dtype=torch.long, device=self.idf.device)
        return mask, self.idf[idx]

    @staticmethod
    def _apply_cols(data: torch.Tensor, mask: torch.Tensor,
                    idf: torch.Tensor) -> torch.Tensor:
        """tf-idf over the true feature columns of ``data``; skipped columns
        pass through."""
        mask, idf = mask.to(data.dtype), idf.to(data.dtype)
        counts = data * mask
        tot = torch.clamp(torch.sum(counts, dim=-1, keepdim=True), min=1.0)
        tfidf = counts / tot * idf
        return torch.where(mask > 0, tfidf, data)

    def transform(self, table: Any) -> Any:
        if isinstance(table, MLTable):
            # the host tier: computed in fp32 where the weights lie, as the
            # reference's jnp of its float64 rows (jax's default dtype) is
            # fp32 on its default device; only the result comes back
            mat = table._dense(self.idf.device, torch.float32)
            out = self._apply_cols(mat, *self._full)
            return MLTable.from_numpy(out.cpu().numpy(),
                                      num_partitions=table.num_partitions,
                                      names=table.schema.names)
        if table.num_cols != self.num_cols:
            raise ValueError(f"fitted on {self.num_cols} columns, table has "
                             f"{table.num_cols}")
        return table._like(self._apply_cols(table.data, *self._full), table.names)

    def apply(self, feats: torch.Tensor) -> torch.Tensor:
        """(n, f) serving rows (label columns absent) → tf-idf rows."""
        return self._apply_cols(feats, *self._serve)

    @property
    def partial(self):
        return {"idf": self.idf}

    def host_state(self) -> dict:
        return {"kind": "tfidf", "skip": list(self.skip_idx),
                "label": list(self.label_idx), "num_cols": self.num_cols}

    @staticmethod
    def partial_template(host_state: dict) -> dict:
        """Structure of ``partial`` for a checkpoint restore (values unread)."""
        return {"idf": torch.zeros((int(host_state["num_cols"]),), dtype=torch.float32)}

    @classmethod
    def from_state(cls, host_state: dict, partial: dict,
                   device: DeviceLike = None) -> "FittedTfIdf":
        return cls(partial["idf"], tuple(host_state["skip"]),
                   host_state["num_cols"],
                   tuple(host_state.get("label", host_state["skip"])),
                   device=device)


class TfIdf(Transformer):
    """Fit smooth IDF weights ``log((1 + N) / (1 + df)) ≥ 0`` over a count
    table (Fig. A2 ``tfIdf(...)``) with one global reduce; transform is the
    per-row ``tf * idf`` map.

    ``device`` places the fit of a host-tier :class:`MLTable` (the CUDA card
    unless ``device="cpu"``), where the reference computes on JAX's default
    device; a numeric table is fitted where its data lies."""

    tier = "device"

    def __init__(self, skip: SkipSpec = "auto",
                 device: DeviceLike = None) -> None:
        self.skip = skip
        self.device = device
        self._config = {"skip": skip}

    def clone_with(self, **overrides: Any) -> "TfIdf":
        out = super().clone_with(**overrides)
        out.device = self.device
        return out

    def fit(self, table: Any, default_skip: Sequence[int] = ()
            ) -> FittedTfIdf:
        if isinstance(table, MLTable):
            data = table._dense(resolve_device(self.device), torch.float32)
            num_shards, mesh = 1, None
        else:
            data, num_shards, mesh = table.data, table.num_shards, table.mesh
        skip_idx = resolve_skip(table, self.skip, default_skip)
        label_idx = resolve_labels(table, default_skip)
        # every row of the table (every host's, on a mesh); the counts are
        # integers below 2**24, exact in fp32 in any order
        n_docs = table.num_rows
        df = column_sums(data, num_shards, mesh,
                         fn=lambda v: (v > 0).to(torch.float32))
        idf = torch.log((1.0 + n_docs) / (1.0 + df))
        if skip_idx:
            idf[list(skip_idx)] = 0.0
        return FittedTfIdf(idf, skip_idx, int(data.shape[1]), label_idx)


# --------------------------------------------------------------------------- #
# seed-era function shims (fit + transform on the same table)
# --------------------------------------------------------------------------- #
def n_grams(table: MLTable, n: int = 2, top: int = 30000,
            column: Union[int, str] = 0) -> MLTable:
    """One-shot corpus fit + transform (shim over :class:`NGrams` with
    ``keep_columns=False`` — the seed behavior of emitting only the gram
    columns)."""
    f, out = NGrams(n=n, top=top, column=column,
                    keep_columns=False).fit_transform(table)
    return out


def tf_idf(table: MLTable, device: DeviceLike = None) -> MLTable:
    """One-shot TF-IDF over a count table (shim over :class:`TfIdf`),
    computed on ``device`` (the CUDA card unless ``device="cpu"``)."""
    f, out = TfIdf(skip=None, device=device).fit_transform(table)
    return out


def hashing_vectorizer(table: MLTable, num_features: int = 1024, n: int = 1,
                       column: Union[int, str] = 0) -> MLTable:
    """Feature hashing (shim over :class:`HashingVectorizer` with
    ``keep_columns=False``)."""
    f, out = HashingVectorizer(num_features=num_features, n=n, column=column,
                               keep_columns=False).fit_transform(table)
    return out
