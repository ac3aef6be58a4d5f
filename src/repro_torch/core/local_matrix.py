"""LocalMatrix (paper §III-B, API table Fig. A3).

Counterpart: ``src/repro/core/local_matrix.py`` (``LocalMatrix`` and
``PaddedCSR``).  A MATLAB-style linear-algebra object over a
*partition* of the data: :meth:`MLNumericTable.matrix_batch_map` hands each
partition's block to the partition function as one.  It wraps a 2-D torch
tensor where it lies (a 1-D one becomes a column); host data and the
constructors go to the CUDA card unless the caller passes ``device="cpu"``.

  * Arithmetic follows Fig. A3: ``+ - * /`` are element-wise, ``times`` is
    matrix multiplication, ``dot`` is the scalar inner product, ``on`` /
    ``then`` compose row-wise / column-wise.
  * ``solve``, ``inverse``, ``svd``, ``eigen``, ``rank`` and ``norm`` are
    ``torch.linalg`` routines; ``rand`` draws from a ``torch.Generator``
    (the reference takes a JAX key, whose draws the port cannot reproduce).
  * ``updated`` returns a new matrix, as in the reference (whose arrays are
    immutable), and ``non_zero_indices`` keeps the reference's fixed-width
    padded form.

:class:`PaddedCSR` holds sparse rows at a fixed width for ALS.  The
reference fills it row by row in a Python loop; the port builds the same
arrays with one stable sort by row (:func:`_row_slots`), which at the
Netflix Prize's 10⁸ ratings takes a fraction of a second on the card.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, on_device, resolve_device, to_tensor

__all__ = ["LocalMatrix", "PaddedCSR"]

ArrayLike = Union[torch.Tensor, np.ndarray, float, int]


def _unwrap(x: Any) -> Any:
    return x.data if isinstance(x, LocalMatrix) else x


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    """``x`` as a tensor: a tensor where it lies, host data copied to
    ``device``."""
    x = _unwrap(x)
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=device)


class LocalMatrix:
    """Dense partition-local matrix with a MATLAB-flavoured API."""

    def __init__(self, data: ArrayLike, device: DeviceLike = None):
        """Wrap ``data``: a tensor where it lies (or moved to ``device`` when
        one is given), host data copied to ``device`` (the CUDA card unless
        ``device="cpu"``)."""
        if isinstance(_unwrap(data), torch.Tensor):
            arr = _unwrap(data)
            if device is not None:
                arr = arr.to(resolve_device(device))
        else:
            arr = _tensor(data, resolve_device(device))
        if arr.ndim == 1:
            arr = arr[:, None]
        if arr.ndim != 2:
            raise ValueError(f"LocalMatrix must be 2-D, got shape {tuple(arr.shape)}")
        self.data = arr

    # constructors -------------------------------------------------------- #
    # on ``device``: the CUDA card unless the caller passes ``device="cpu"``
    @classmethod
    def zeros(cls, m: int, n: int = 1, dtype=torch.float32,
              device: DeviceLike = None) -> "LocalMatrix":
        return cls(torch.zeros((m, n), dtype=dtype, device=resolve_device(device)))

    @classmethod
    def ones(cls, m: int, n: int = 1, dtype=torch.float32,
             device: DeviceLike = None) -> "LocalMatrix":
        return cls(torch.ones((m, n), dtype=dtype, device=resolve_device(device)))

    @classmethod
    def eye(cls, n: int, dtype=torch.float32,
            device: DeviceLike = None) -> "LocalMatrix":
        return cls(torch.eye(n, dtype=dtype, device=resolve_device(device)))

    @classmethod
    def rand(cls, m: int, n: int, generator: Optional[torch.Generator] = None,
             dtype=torch.float32, device: DeviceLike = None) -> "LocalMatrix":
        """Uniform [0, 1) entries from ``generator`` (seed 0 on ``device``
        when omitted; a given generator must lie on ``device``)."""
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return cls(torch.rand((m, n), generator=generator, dtype=dtype,
                              device=device))

    # shape (Fig. A3 "Shape" family) --------------------------------------- #
    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    @property
    def num_cols(self) -> int:
        return self.data.shape[1]

    numRows, numCols = num_rows, num_cols  # paper spelling

    @property
    def dims(self) -> Tuple[int, int]:
        return tuple(self.data.shape)  # type: ignore[return-value]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.data.shape)  # type: ignore[return-value]

    @property
    def dtype(self):
        return self.data.dtype

    # composition (Fig. A3 "Composition") ---------------------------------- #
    def on(self, other: "LocalMatrix") -> "LocalMatrix":
        """Stack row-wise: ``matA on matB``."""
        return LocalMatrix(torch.cat([self.data, _tensor(other, self.data.device)], dim=0))

    def then(self, other: "LocalMatrix") -> "LocalMatrix":
        """Concatenate column-wise: ``matA then matB``."""
        return LocalMatrix(torch.cat([self.data, _tensor(other, self.data.device)], dim=1))

    # indexing (Fig. A3 "Indexing"/"Updating") ------------------------------ #
    def __getitem__(self, key) -> "LocalMatrix":
        out = self.data[key]
        if out.ndim == 0:
            return out  # scalar passthrough (paper returns Scalar)
        return LocalMatrix(out)

    def row(self, i) -> "LocalMatrix":
        return LocalMatrix(self.data[i, :][None, :])

    def col(self, j) -> "LocalMatrix":
        return LocalMatrix(self.data[:, j][:, None])

    def slice_rows(self, idx) -> "LocalMatrix":
        index = torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                device=self.data.device)
        return LocalMatrix(self.data.index_select(0, index.reshape(-1)))

    def updated(self, key, value: ArrayLike) -> "LocalMatrix":
        """Functional update: ``mat(1,2)=5`` becomes
        ``mat = mat.updated((1,2), 5)`` (a new matrix; this one is kept)."""
        out = self.data.clone()
        out[key] = torch.as_tensor(_unwrap(value), dtype=out.dtype, device=out.device)
        return LocalMatrix(out)

    def non_zero_indices(self, row: int, max_nnz: int = None):
        """Padded analogue of Fig. A3 ``mat(0,??).nonZeroIndices``.

        Returns ``(indices, mask)`` where indices has static length
        ``max_nnz`` (default: num_cols); invalid slots hold zero-valued
        columns and mask=False.
        """
        r = self.data[row]
        if max_nnz is None:
            max_nnz = self.num_cols
        nz = r != 0
        order = torch.argsort((~nz).to(torch.int8), stable=True)  # non-zeros first
        idx = order[:max_nnz]
        mask = nz[idx]
        return idx, mask

    nonZeroIndices = non_zero_indices  # paper spelling

    # arithmetic (Fig. A3 "Arithmetic") ------------------------------------- #
    def _binop(self, other: ArrayLike, op) -> "LocalMatrix":
        o = _unwrap(other)
        if isinstance(o, np.ndarray):
            o = torch.as_tensor(o, device=self.data.device)
        return LocalMatrix(op(self.data, o))

    def __add__(self, o): return self._binop(o, torch.add)
    def __radd__(self, o): return self._binop(o, lambda a, b: torch.add(b, a))
    def __sub__(self, o): return self._binop(o, torch.sub)
    def __rsub__(self, o): return self._binop(o, lambda a, b: torch.sub(b, a))
    def __mul__(self, o): return self._binop(o, torch.mul)
    def __rmul__(self, o): return self._binop(o, lambda a, b: torch.mul(b, a))
    def __truediv__(self, o): return self._binop(o, torch.div)
    def __neg__(self): return LocalMatrix(-self.data)

    plus = __add__      # paper: `_ plus _` in the SGD reducer
    minus = __sub__

    # linear algebra (Fig. A3 "Linear Algebra") ------------------------------ #
    def times(self, other: "LocalMatrix") -> "LocalMatrix":
        """Matrix-matrix (or matrix-vector) product: ``matA times matB``."""
        return LocalMatrix(self.data @ _tensor(other, self.data.device))

    __matmul__ = times

    def dot(self, other: "LocalMatrix") -> torch.Tensor:
        """Scalar inner product of two vectors."""
        return torch.dot(self.data.reshape(-1), _tensor(other, self.data.device).reshape(-1))

    @property
    def T(self) -> "LocalMatrix":
        return LocalMatrix(self.data.T)

    def transpose(self) -> "LocalMatrix":
        return self.T

    def solve(self, rhs: ArrayLike) -> "LocalMatrix":
        """Solve ``self @ x = rhs`` (paper: ``matA.solve(v)``)."""
        b = _tensor(rhs, self.data.device)
        if b.ndim == 1:
            b = b[:, None]
        return LocalMatrix(torch.linalg.solve(self.data, b))

    def inverse(self) -> "LocalMatrix":
        return LocalMatrix(torch.linalg.inv(self.data))

    def svd(self):
        u, s, vt = torch.linalg.svd(self.data, full_matrices=False)
        return LocalMatrix(u), s, LocalMatrix(vt)

    def eigen(self):
        w, v = torch.linalg.eigh(self.data)
        return w, LocalMatrix(v)

    def rank(self, tol: float = 1e-6) -> torch.Tensor:
        s = torch.linalg.svdvals(self.data)
        return torch.sum(s > tol * s[0])

    def norm(self, ord=None) -> torch.Tensor:
        """``np.linalg.norm``'s ``ord`` convention, as the reference's
        ``jnp.linalg.norm``: Frobenius by default."""
        if ord is None:
            return torch.linalg.norm(self.data)
        return torch.linalg.matrix_norm(self.data, ord=ord)

    # conversion ------------------------------------------------------------ #
    def to_vector(self) -> torch.Tensor:
        return self.data.reshape(-1)

    toVector = to_vector  # paper spelling

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def __repr__(self) -> str:  # pragma: no cover
        return f"LocalMatrix(shape={tuple(self.data.shape)}, dtype={self.data.dtype})"


def _row_slots(rows: torch.Tensor, num_rows: int, max_nnz: int):
    """Where each entry of a COO list goes in a fixed-width row table.

    A stable sort by row keeps the entries of a row in input order; an
    entry's slot is its position among its row's entries, and entries at
    slot ``max_nnz`` or beyond are dropped (the reference's fill counter,
    vectorised).  Returns ``(order, row, slot)``: the kept entries' input
    positions, rows and slots."""
    if rows.numel() and (int(rows.min()) < 0 or int(rows.max()) >= num_rows):
        raise ValueError(f"row indices must lie in [0, {num_rows})")
    order = torch.argsort(rows, stable=True)
    row = rows[order]
    counts = torch.bincount(row, minlength=num_rows)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(row.numel(), device=row.device) - starts[row]
    keep = slot < max_nnz
    return order[keep], row[keep], slot[keep]


class PaddedCSR:
    """Fixed-width CSR-style sparse rows (the fixed-shape analogue of the
    paper's CSR-compressed LocalMatrix rows used by ALS).

    Each of the ``m`` rows stores up to ``max_nnz`` (column index, value)
    pairs plus a validity mask: ``indices`` int32, ``values`` in the
    values' dtype, ``mask`` bool, each ``(m, max_nnz)``.  They give ALS
    Fig. A9's ``nonZeroIndices`` + ``nonZeroProjection`` access pattern.
    """

    def __init__(self, indices: torch.Tensor, values: torch.Tensor,
                 mask: torch.Tensor):
        """Wrap the three tensors where they lie."""
        if not (indices.shape == values.shape == mask.shape):
            raise ValueError("indices/values/mask shapes must match")
        self.indices, self.values, self.mask = indices, values, mask

    @property
    def num_rows(self) -> int:
        return self.indices.shape[0]

    @property
    def max_nnz(self) -> int:
        return self.indices.shape[1]

    @property
    def device(self) -> torch.device:
        return self.indices.device

    @classmethod
    def _fill(cls, rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
              num_rows: int, max_nnz: int) -> "PaddedCSR":
        order, row, slot = _row_slots(rows, num_rows, max_nnz)
        dev = rows.device
        idx = torch.zeros((num_rows, max_nnz), dtype=torch.int32, device=dev)
        val = torch.zeros((num_rows, max_nnz), dtype=vals.dtype, device=dev)
        msk = torch.zeros((num_rows, max_nnz), dtype=torch.bool, device=dev)
        idx[row, slot] = cols[order].to(torch.int32)
        val[row, slot] = vals[order]
        msk[row, slot] = True
        return cls(idx, val, msk)

    @classmethod
    def from_dense(cls, dense, max_nnz: Optional[int] = None,
                   device: DeviceLike = None) -> "PaddedCSR":
        """Each row's non-zeros in ascending column order, the first
        ``max_nnz`` kept (default: the widest row's count), on ``device``
        (the CUDA card unless ``device="cpu"``).  float64 values arrive as
        float32, as in the reference."""
        dense = to_tensor(dense, resolve_device(device))
        if max_nnz is None:
            max_nnz = int((dense != 0).sum(1).max()) if dense.shape[0] else 0
        rows, cols = torch.nonzero(dense, as_tuple=True)   # row-major
        return cls._fill(rows, cols, dense[rows, cols], dense.shape[0], max_nnz)

    @classmethod
    def from_coo(cls, rows, cols, vals, num_rows: int, max_nnz: int,
                 device: DeviceLike = None) -> "PaddedCSR":
        """COO entries (numpy arrays or tensors) packed on ``device`` (the
        CUDA card unless ``device="cpu"``): each row keeps its first
        ``max_nnz`` entries in input order; values are float32."""
        dev = resolve_device(device)
        rows, cols, vals = (on_device(a, dev) for a in (rows, cols, vals))
        return cls._fill(rows.long(), cols, vals.to(torch.float32),
                         num_rows, max_nnz)

    def to_dense(self, num_cols: int) -> LocalMatrix:
        """The (m, num_cols) dense matrix; entries of a row that share a
        column add up, as in the reference's scatter-add."""
        m = self.num_rows
        dense = torch.zeros((m, num_cols), dtype=self.values.dtype,
                            device=self.device)
        rows = torch.arange(m, device=self.device)[:, None].expand(-1, self.max_nnz)
        dense.index_put_((rows, self.indices.long()),
                         torch.where(self.mask, self.values,
                                     torch.zeros_like(self.values)),
                         accumulate=True)
        return LocalMatrix(dense)

    def gather_rows_of(self, factor: torch.Tensor, row: int):
        """``(Yq, ratings, mask)`` for one sparse row: Fig. A9's
        ``Y.getRows(tuple.nonZeroIndices)`` at a fixed width."""
        yq = factor.index_select(0, self.indices[row])     # (max_nnz, k)
        return yq, self.values[row], self.mask[row]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PaddedCSR(rows={self.num_rows}, max_nnz={self.max_nnz}, "
                f"device={self.device})")
