"""Matrix factorization via Alternating Least Squares (paper §IV-B, Fig. A9).

Counterpart: ``src/repro/core/algorithms/als.py`` (``pack_csr_table``,
``unpack_csr_block``, ``ALSParameters``, ``MatrixFactorizationModel``,
``_local_als``, ``_local_als_stacked``, ``BroadcastALS`` with
``compute_factor``, ``fit``, ``rebuild``, ``train`` and
``train_stacked``).

``BroadcastALS`` updates the rows of U (users) with V broadcast to every
partition, then the rows of V with U broadcast, over the *transposed*
ratings ("We distribute both the matrix M and a transposed version of this
matrix across machines").  Each ratings row is packed at a fixed width as
``[indices | values | mask]`` (:func:`pack_csr_table`), so the packed rows
form a normal ``MLNumericTable`` and each half-sweep is Fig. A9's
``trainData.map(localALS(_, fixedFactor, lambI))``: one
``partition_apply(..., combine="concat")`` of :func:`_local_als`.

The port's local function takes the whole ``(P, rows, 3w)`` partition stack
and solves every row of every partition in one batch, so the arithmetic of
a row does not depend on the partition count: a fit with 8 partitions and
with 1 gives the same bits.  The reference's packer fills rows in a Python
loop; the port's is :class:`PaddedCSR`'s stable sort on the device.

Initialisation differs from the reference, which draws U0 and V0 with
``jax.random.uniform`` under a split ``PRNGKey``: ``fit`` draws them
uniform in [0, 1) from a ``torch.Generator`` seeded from ``seed`` on the
table's device, or starts from ``init_factors=(U0, V0)``;
``train_stacked`` takes one such pair per config.

``train_stacked`` factors the same ratings under K configs at once: the K
λ values ride as a (K,) tensor, the K lanes' rows are gathered, multiplied
and solved as one batch, and one ``concat`` combine a half-sweep carries
all K factors.  Its lanes share one batched solve, so a lane is held to
its solo fit at a tolerance, not bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.fixed_sum import fixed_sum
from repro_torch.core.interfaces import Model, NumericAlgorithm, _warn_deprecated
from repro_torch.core.local_matrix import PaddedCSR
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import DistributedRunner
from repro_torch.device import DeviceLike, on_device

__all__ = ["ALSParameters", "MatrixFactorizationModel", "BroadcastALS",
           "pack_csr_table", "unpack_csr_block"]

# (user, item) pairs :meth:`MatrixFactorizationModel.rmse` predicts at once
_RMSE_CHUNK = 1 << 23


def pack_csr_table(rows, cols, vals, num_rows: int, max_nnz: int,
                   num_shards: Optional[int] = None,
                   device: DeviceLike = None) -> MLNumericTable:
    """COO ratings (numpy arrays or tensors) as a (num_rows, 3·max_nnz)
    fp32 table on ``device`` (the CUDA card unless ``device="cpu"``) whose
    row layout is [indices | values | mask].  A row keeps its first
    ``max_nnz`` ratings in input order (dataset builders choose max_nnz ≥
    the widest row)."""
    csr = PaddedCSR.from_coo(rows, cols, vals, num_rows, max_nnz, device=device)
    packed = torch.cat([csr.indices.to(torch.float32), csr.values,
                        csr.mask.to(torch.float32)], dim=1)
    return MLNumericTable(packed, num_shards=num_shards or 1)


def unpack_csr_block(block: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Inverse of the packing: (indices int32, values, mask), each
    ``(..., max_nnz)``, of packed rows ``(..., 3·max_nnz)``."""
    w = block.shape[-1] // 3
    return (block[..., :w].to(torch.int32), block[..., w:2 * w],
            block[..., 2 * w:])


@dataclasses.dataclass
class ALSParameters:
    rank: int = 10          # paper: rank 10
    lam: float = 0.01       # paper: lambda = .01
    max_iter: int = 10      # paper: 10 iterations
    seed: int = 0
    # wire pattern of the per-sweep factor broadcast; GATHER_BROADCAST is the
    # paper's literal schedule (gather factor rows, broadcast the whole factor)
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.GATHER_BROADCAST


class MatrixFactorizationModel(Model):
    def __init__(self, U: torch.Tensor, V: torch.Tensor, params: ALSParameters):
        self.U = U
        self.V = V
        self.params = params

    def predict(self, pairs: torch.Tensor) -> torch.Tensor:
        """``pairs`` (n, 2) of (user, item) → the predicted ratings (n,).
        Each rating is U[user]·V[item] summed in :func:`fixed_sum`'s order,
        so a served pair is bitwise its offline prediction."""
        pairs = on_device(pairs, self.U.device).long()
        u = self.U.index_select(0, pairs[:, 0])
        v = self.V.index_select(0, pairs[:, 1])
        return fixed_sum(u * v)

    def rmse(self, rows, cols, vals) -> torch.Tensor:
        """Root mean squared error of the predictions at (rows, cols)
        against ``vals`` (numpy arrays or tensors), predicted in chunks of
        ``_RMSE_CHUNK`` pairs."""
        dev = self.U.device
        rows, cols, vals = (on_device(a, dev) for a in (rows, cols, vals))
        sq = torch.zeros((), dtype=self.U.dtype, device=dev)
        for i in range(0, rows.shape[0], _RMSE_CHUNK):
            pairs = torch.stack([rows[i:i + _RMSE_CHUNK], cols[i:i + _RMSE_CHUNK]], 1)
            sq = sq + ((self.predict(pairs) - vals[i:i + _RMSE_CHUNK]) ** 2).sum()
        return torch.sqrt(sq / rows.shape[0])

    @property
    def partial(self):
        return {"U": self.U, "V": self.V}


def _gather_masked(idx: torch.Tensor, msk: torch.Tensor, Y: torch.Tensor
                   ) -> torch.Tensor:
    """Yq (R, w, k): the fixed factor's rows at each packed row's indices,
    zeroed where the mask is (Fig. A9's masked projection)."""
    R, w = idx.shape
    Yq = Y.index_select(0, idx.reshape(-1)).view(R, w, Y.shape[1])
    return Yq.mul_(msk.unsqueeze(-1))


def _normal_equations(Yq: torch.Tensor, val: torch.Tensor, msk: torch.Tensor,
                      lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """A = YqᵀYq + λI (R, k, k) and b = Yqᵀ(v·m) (R, k, 1) by batched
    products; λ joins the diagonal in place, which adds exactly what
    ``+ lam·I`` adds."""
    A = torch.bmm(Yq.transpose(1, 2), Yq)
    A.diagonal(dim1=-2, dim2=-1).add_(lam)
    b = torch.bmm(Yq.transpose(1, 2), (val * msk).unsqueeze(-1))
    return A, b


def _solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (R, k) of A x = b: an LU solve, as ``jnp.linalg.solve``; the
    ``_ex`` form returns its status instead of checking it, so the host
    does not wait for the card (A is SPD for λ > 0)."""
    return torch.linalg.solve_ex(A, b)[0][..., 0]


def _local_als(blocks: torch.Tensor, Y: torch.Tensor, lam: float) -> torch.Tensor:
    """Fig. A9 ``localALS``: for each packed CSR row of every partition,
    solve the regularized normal equations against the fixed factor Y.
    ``blocks`` (P, rows, 3w) → (P, rows, k).  The partitions' rows are
    solved as one batch, so a row's bits do not depend on P."""
    lead = blocks.shape[:-1]
    idx, val, msk = unpack_csr_block(blocks.reshape(-1, blocks.shape[-1]))
    Yq = _gather_masked(idx, msk, Y)
    A, b = _normal_equations(Yq, val, msk, lam)
    return _solve(A, b).reshape(*lead, Y.shape[1])


def _local_als_stacked(blocks: torch.Tensor, Ys: torch.Tensor,
                       lams: torch.Tensor) -> torch.Tensor:
    """K stacked half-sweep solves: ``Ys`` (K, n, k), ``lams`` (K,).  The
    K lanes' masked projections are one gather from the flattened factors,
    their normal equations one batched product and their solves one
    batch; the result is rows-major, ``blocks`` (P, rows, 3w) → (P, rows,
    K, k), so the partitions' blocks concatenate over rows and one
    ``concat`` combine carries all K factors."""
    lead = blocks.shape[:-1]
    K, n, k = Ys.shape
    idx, val, msk = unpack_csr_block(blocks.reshape(-1, blocks.shape[-1]))
    R, w = idx.shape
    lanes = (torch.arange(K, device=idx.device, dtype=idx.dtype) * n).view(K, 1, 1)
    Yq = _gather_masked((idx.unsqueeze(0) + lanes).reshape(K * R, w),
                        msk.repeat(K, 1), Ys.reshape(K * n, k))
    A = torch.bmm(Yq.transpose(1, 2), Yq)
    A.view(K, R, k, k).diagonal(dim1=-2, dim2=-1).add_(lams.view(K, 1, 1))
    b = torch.bmm(Yq.transpose(1, 2), (val * msk).repeat(K, 1).unsqueeze(-1))
    x = _solve(A, b).view(K, R, k)
    return x.transpose(0, 1).reshape(*lead, K, k)


class BroadcastALS(NumericAlgorithm[ALSParameters, MatrixFactorizationModel]):
    """Instance-based Estimator: ``BroadcastALS(rank=10).fit(packed,
    data_transposed=packed_T) -> (U, V) model``."""

    Parameters = ALSParameters
    supervised = False

    @classmethod
    def compute_factor(cls, train_data: MLNumericTable, fixed_factor: torch.Tensor,
                       lam: float,
                       schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.GATHER_BROADCAST,
                       ) -> torch.Tensor:
        """Fig. A9 ``computeFactor``: one half-sweep through the same
        runner call ``fit`` makes: solve the partitions' factor rows
        locally, then concatenate (broadcast) the completed factor."""
        runner = DistributedRunner.for_table(train_data, schedule=schedule)
        return runner.partition_apply(train_data.data, _local_als,
                                      (fixed_factor, lam), combine="concat")

    def fit(self, data: MLNumericTable,
            data_transposed: Optional[MLNumericTable] = None, *,
            init_factors: Optional[Sequence[torch.Tensor]] = None,
            ) -> MatrixFactorizationModel:
        """2·max_iter half-sweeps from ``init_factors=(U0, V0)`` (moved to
        the table's device) or from U0, V0 uniform in [0, 1) drawn from a
        ``torch.Generator`` on the table's device seeded from
        ``params.seed``.  Both halves run with ``data``'s partition count,
        as in the reference, so both tables' row counts must divide it."""
        if data_transposed is None:
            raise ValueError("BroadcastALS.fit requires the transposed ratings "
                             "table (the paper distributes both M and Mᵀ)")
        p = self.params
        m, n = data.num_rows, data_transposed.num_rows
        dev = data.device
        U, V = self._init(p, m, n, dev, init_factors)
        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        for _ in range(p.max_iter):
            U = runner.partition_apply(data.data, _local_als, (V, p.lam),
                                       combine="concat")
            V = runner.partition_apply(data_transposed.data, _local_als,
                                       (U, p.lam), combine="concat")
        return MatrixFactorizationModel(U, V, p)

    @staticmethod
    def _init(p: ALSParameters, m: int, n: int, dev: torch.device,
              init_factors: Optional[Sequence[torch.Tensor]]):
        """(U0, V0): ``init_factors`` on ``dev``, or uniform in [0, 1) from
        a ``torch.Generator`` on ``dev`` seeded from ``p.seed``."""
        if init_factors is None:
            gen = torch.Generator(device=dev).manual_seed(p.seed)
            U = torch.rand((m, p.rank), generator=gen, device=dev)
            V = torch.rand((n, p.rank), generator=gen, device=dev)
            return U, V
        U, V = (on_device(f, dev).to(torch.float32) for f in init_factors)
        if tuple(U.shape) != (m, p.rank) or tuple(V.shape) != (n, p.rank):
            raise ValueError(
                f"init_factors {tuple(U.shape)}, {tuple(V.shape)} must be "
                f"({m}, {p.rank}), ({n}, {p.rank})")
        return U, V

    def rebuild(self, partial) -> MatrixFactorizationModel:
        return MatrixFactorizationModel(partial["U"], partial["V"], self.params)

    @classmethod
    def train(cls, data: MLNumericTable,
              params: Optional[ALSParameters] = None,
              data_transposed: Optional[MLNumericTable] = None,
              ) -> MatrixFactorizationModel:
        """Deprecated positional-``data_transposed`` spelling; delegates to
        ``cls(params).fit(data, data_transposed=…)`` (bit-identical)."""
        _warn_deprecated(
            f"{cls.__name__}.train(data, params, data_transposed)",
            f"{cls.__name__}(params).fit(data, data_transposed=…)")
        return cls(params).fit(data, data_transposed=data_transposed)

    @classmethod
    def train_stacked(cls, data: MLNumericTable, params_list: list,
                      data_transposed: MLNumericTable, *,
                      init_factors: Optional[Sequence[Sequence[torch.Tensor]]] = None,
                      ) -> list:
        """Factor the SAME ratings under K configs at once (model search
        over ``lam`` / ``seed``).  ``rank`` and ``max_iter`` must agree
        across configs.  ``init_factors`` is one ``(U0, V0)`` per config
        (else each config draws its own from its seed, as :meth:`fit`
        does).  Each half-sweep solves all K lanes in one batch
        (:func:`_local_als_stacked`) and broadcasts them with ONE
        ``concat`` combine.  Returns one :class:`MatrixFactorizationModel`
        per config, each within fp32 rounding of its solo fit."""
        ps = [p or cls.default_parameters() for p in params_list]
        if not ps:
            raise ValueError("params_list must not be empty")
        for field in ("rank", "max_iter"):
            vals = {getattr(p, field) for p in ps}
            if len(vals) > 1:
                raise ValueError(
                    f"stacked ALS trials must share {field}, got {sorted(vals)}"
                    f" — run ragged configs in separate calls")
        if init_factors is not None and len(init_factors) != len(ps):
            raise ValueError(f"init_factors has {len(init_factors)} pairs for "
                             f"{len(ps)} configs")
        p0 = ps[0]
        m, n, dev = data.num_rows, data_transposed.num_rows, data.device
        inits = [cls._init(p, m, n, dev, None if init_factors is None else init_factors[i])
                 for i, p in enumerate(ps)]
        U = torch.stack([u for u, _ in inits])                  # (K, m, rank)
        V = torch.stack([v for _, v in inits])                  # (K, n, rank)
        del inits
        lams = torch.tensor([p.lam for p in ps], dtype=torch.float32, device=dev)
        runner = DistributedRunner.for_table(data, schedule=p0.schedule)

        def half_sweep(ratings: MLNumericTable, fixed: torch.Tensor) -> torch.Tensor:
            rows_major = runner.partition_apply(
                ratings.data, _local_als_stacked, (fixed, lams), combine="concat")
            return rows_major.transpose(0, 1).contiguous()       # (K, rows, rank)

        for _ in range(p0.max_iter):
            U = half_sweep(data, V)
            V = half_sweep(data_transposed, U)
        return [MatrixFactorizationModel(U[i], V[i], ps[i]) for i in range(len(ps))]
