"""The port's §IV-B (BroadcastALS, PaddedCSR, pack_csr_table,
synth_netflix_tiled) against the JAX reference, on the CPU.

Tolerances, fixed from what fp32 rounding gives at these sizes (rank 4
and 10, λ = 0.01 and 0.05, 10-40 ratings a row): the generator, the packers and PaddedCSR
are bitwise; one half-sweep (``_local_als`` / ``compute_factor``) against
the reference's for the same fixed factor within ``HALF_TOL`` of max |U|
(the two sum the Gram products in other orders; one fp32 half-sweep lies
2e-5 of max |U| from an fp64 solve at these sizes); whole fits, where ten
iterations amplify that rounding to a few 1e-4, within ``FIT_TOL``.  The
reference draws U0, V0 with ``jax.random``, which the port cannot
reproduce: the fits start from JAX's draws through ``init_factors=``.
"""
import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.algorithms.als import ALSParameters as JParams
from repro.core.algorithms.als import BroadcastALS as JALS
from repro.core.algorithms.als import _local_als as j_local_als
from repro.core.algorithms.als import pack_csr_table as j_pack
from repro.core.local_matrix import PaddedCSR as JCSR
from repro.data import synth_netflix_tiled as j_netflix
from repro_torch.core.algorithms.als import ALSParameters, BroadcastALS
from repro_torch.core.algorithms.als import _local_als, pack_csr_table, unpack_csr_block
from repro_torch.core.local_matrix import PaddedCSR
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.data import synth_netflix_tiled
from repro_torch.serve.predictor import ModelPredictor
from repro_torch.weights import from_reference

HALF_TOL = 1e-4
FIT_TOL = 1e-3
SCHEDULES = ["allreduce", "gather_broadcast", "reduce_scatter"]


def _coo(M):
    r, c = np.nonzero(M)
    return r, c, M[r, c]


def _tables(tiles=1, max_nnz=32, shards=4, users=64, items=48, rank=4,
            density=0.2, seed=0):
    """The reference tests' ratings (``tests/test_algorithms.py``), packed
    by both packers."""
    M = j_netflix(users=users, items=items, rank=rank, tiles=tiles,
                  density=density, seed=seed)
    r, c, v = _coo(M)
    m, n = M.shape
    jd = j_pack(r, c, v, m, max_nnz, num_shards=shards)
    jdt = j_pack(c, r, v, n, max_nnz, num_shards=shards)
    td = pack_csr_table(r, c, v, m, max_nnz, num_shards=shards, device="cpu")
    tdt = pack_csr_table(c, r, v, n, max_nnz, num_shards=shards, device="cpu")
    return (jd, jdt), (td, tdt), (r, c, v)


def _jax_init(m, n, rank, seed):
    """The reference's U0, V0 (``als.py:158-161``)."""
    key_u, key_v = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jax.random.uniform(key_u, (m, rank), jnp.float32)),
            np.asarray(jax.random.uniform(key_v, (n, rank), jnp.float32)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


# --------------------------------------------------------------------------- #
# data and packing: bitwise
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(),
    dict(users=64, items=48, rank=4, tiles=1, density=0.2),
    dict(users=32, items=20, rank=3, tiles=3, density=0.3, seed=5),
    dict(users=128, items=96, rank=6, tiles=2, density=0.15),
])
def test_synth_netflix_tiled_is_the_reference_bitwise(kw):
    got, want = synth_netflix_tiled(**kw), j_netflix(**kw)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _planted_dense():
    """Rows longer than max_nnz, empty rows, a full row."""
    rng = np.random.default_rng(3)
    D = ((rng.random((9, 11)) < 0.35) * rng.normal(size=(9, 11))).astype(np.float32)
    D[2] = 0.0
    D[5] = rng.normal(size=11)
    D[8] = 0.0
    return D


def _assert_csr_equal(t: PaddedCSR, j: JCSR):
    for got, want in ((t.indices, j.indices), (t.values, j.values), (t.mask, j.mask)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    assert (t.num_rows, t.max_nnz) == (j.num_rows, j.max_nnz)


@pytest.mark.parametrize("max_nnz", [None, 1, 3, 11, 14])
def test_padded_csr_from_dense_is_the_reference_bitwise(max_nnz):
    D = _planted_dense()
    t, j = PaddedCSR.from_dense(D, max_nnz, device="cpu"), JCSR.from_dense(D, max_nnz)
    _assert_csr_equal(t, j)
    np.testing.assert_array_equal(t.to_dense(11).to_numpy(),
                                  np.asarray(j.to_dense(11).data))


@pytest.mark.parametrize("max_nnz", [1, 4, 40])
def test_padded_csr_from_coo_is_the_reference_bitwise(max_nnz):
    """Unsorted COO with repeated (row, col) entries, rows past max_nnz
    and empty rows: each row keeps its first entries in input order."""
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 6, 60)
    rows[rows == 4] = 3                  # row 4 empty, row 3 long
    cols = rng.integers(0, 9, 60)
    vals = rng.normal(size=60)           # float64: stored as float32
    t = PaddedCSR.from_coo(rows, cols, vals, 8, max_nnz, device="cpu")
    j = JCSR.from_coo(rows, cols, vals, 8, max_nnz)
    _assert_csr_equal(t, j)
    np.testing.assert_array_equal(t.to_dense(9).to_numpy(),
                                  np.asarray(j.to_dense(9).data))
    # tensors in, the same table out
    t2 = PaddedCSR.from_coo(torch.from_numpy(rows), torch.from_numpy(cols),
                            torch.from_numpy(vals), 8, max_nnz, device="cpu")
    _assert_csr_equal(t2, j)
    Y = rng.normal(size=(9, 3)).astype(np.float32)
    for row in (0, 3, 4):
        got = t.gather_rows_of(torch.from_numpy(Y), row)
        want = j.gather_rows_of(jnp.asarray(Y), row)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_padded_csr_raises_on_rows_out_of_range():
    with pytest.raises(ValueError, match="row indices"):
        PaddedCSR.from_coo([0, 5], [1, 1], [1.0, 2.0], 5, 2, device="cpu")


@pytest.mark.parametrize("max_nnz", [5, 12, 32])
def test_pack_csr_table_is_the_reference_bitwise(max_nnz):
    """Truncated rows (max_nnz below the widest row at 5), both tables."""
    (jd, jdt), (td, tdt), (r, c, v) = _tables(max_nnz=max_nnz)
    for t, j in ((td, jd), (tdt, jdt)):
        assert t.data.dtype == torch.float32 and t.num_shards == j.num_shards
        np.testing.assert_array_equal(t.to_numpy(), np.asarray(j.data))
    idx, val, msk = unpack_csr_block(td.data)
    assert idx.dtype == torch.int32
    degree = np.bincount(r, minlength=td.num_rows)
    assert int(msk.sum()) == int(np.minimum(degree, max_nnz).sum())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jd.data[:, :max_nnz]).astype(np.int32))
    # a shuffled COO order packs the first entries of each row in that order
    perm = np.random.default_rng(1).permutation(len(v))
    m = td.num_rows
    np.testing.assert_array_equal(
        pack_csr_table(r[perm], c[perm], v[perm], m, max_nnz, device="cpu").to_numpy(),
        np.asarray(j_pack(r[perm], c[perm], v[perm], m, max_nnz).data))


# --------------------------------------------------------------------------- #
# the half-sweep and the fit
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("tiles,max_nnz", [(1, 32), (2, 32), (1, 8)])
def test_local_als_matches_the_reference(tiles, max_nnz):
    (jd, jdt), (td, tdt), _ = _tables(tiles=tiles, max_nnz=max_nnz)
    rng = np.random.default_rng(tiles)
    V = rng.random((tdt.num_rows, 10)).astype(np.float32)
    want = np.asarray(j_local_als(jd.data, jnp.asarray(V), 0.01))
    got = _local_als(td.data.view(1, td.num_rows, -1), torch.from_numpy(V), 0.01)
    assert got.shape == (1, td.num_rows, 10)
    assert _rel(got[0].numpy(), want) <= HALF_TOL


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_compute_factor_matches_the_reference(schedule):
    (jd, jdt), (td, tdt), _ = _tables()
    U = np.random.default_rng(2).random((td.num_rows, 10)).astype(np.float32)
    want = np.asarray(JALS.compute_factor(jdt, jnp.asarray(U), 0.01, schedule))
    got = BroadcastALS.compute_factor(tdt, torch.from_numpy(U), 0.01, schedule)
    assert got.shape == (tdt.num_rows, 10)
    assert _rel(got.numpy(), want) <= HALF_TOL


@pytest.mark.parametrize("rank,lam,iters,seed", [
    (4, 0.05, 10, 0),
    (4, 0.01, 10, 1),
    (4, 0.05, 1, 2),
])
def test_fit_from_jax_init_matches_the_reference(rank, lam, iters, seed):
    """At the data's rank (the paper's hyperparameters run in the example
    twin below: rank 10 on this rank-4 table makes the Gram matrices
    nearly singular, and the two packages' fits part by 1.2e-3)."""
    (jd, jdt), (td, tdt), (r, c, v) = _tables()
    jm = JALS(JParams(rank=rank, lam=lam, max_iter=iters, seed=seed)).fit(
        jd, data_transposed=jdt)
    U0, V0 = _jax_init(td.num_rows, tdt.num_rows, rank, seed)
    tm = BroadcastALS(rank=rank, lam=lam, max_iter=iters, seed=seed).fit(
        td, data_transposed=tdt, init_factors=(U0, V0))
    assert _rel(tm.U.numpy(), jm.U) <= FIT_TOL
    assert _rel(tm.V.numpy(), jm.V) <= FIT_TOL
    rj, rt = float(jm.rmse(r, c, v)), tm.rmse(r, c, v).item()
    assert abs(rt - rj) <= FIT_TOL * rj
    assert rt < 0.5 or iters == 1


def test_rmse_decreases_from_its_own_init():
    """The reference's ``test_rmse_decreases`` on the port's own draws."""
    _, (td, tdt), (r, c, v) = _tables()
    m1 = BroadcastALS(rank=4, lam=0.05, max_iter=1).fit(td, data_transposed=tdt)
    m10 = BroadcastALS(rank=4, lam=0.05, max_iter=10).fit(td, data_transposed=tdt)
    assert m10.rmse(r, c, v).item() < m1.rmse(r, c, v).item()
    assert m10.rmse(r, c, v).item() < 0.5
    # the same seed draws the same init; another seed another
    again = BroadcastALS(rank=4, lam=0.05, max_iter=1).fit(td, data_transposed=tdt)
    assert torch.equal(again.U, m1.U) and torch.equal(again.V, m1.V)
    other = BroadcastALS(rank=4, lam=0.05, max_iter=1, seed=1).fit(td, data_transposed=tdt)
    assert not torch.equal(other.U, m1.U)


def test_fit_is_bitwise_the_same_for_any_partition_count():
    _, (td, tdt), _ = _tables(shards=4)
    models = [BroadcastALS(max_iter=3).fit(
                  MLNumericTable(td.data, num_shards=s),
                  data_transposed=MLNumericTable(tdt.data, num_shards=s))
              for s in (1, 2, 4)]
    for m in models[1:]:
        assert torch.equal(m.U, models[0].U) and torch.equal(m.V, models[0].V)


def test_fit_raises_without_the_transpose_and_on_bad_partitions():
    _, (td, tdt), _ = _tables(shards=4)
    with pytest.raises(ValueError, match="transposed"):
        BroadcastALS().fit(td)
    with pytest.raises(ValueError, match="init_factors"):
        BroadcastALS(rank=3).fit(td, data_transposed=tdt,
                                 init_factors=(np.zeros((64, 4)), np.zeros((48, 3))))
    # both halves use the first table's partition count, as in the reference
    users = pack_csr_table([0, 1, 2, 3], [0, 1, 2, 0], [1.0, 2.0, 3.0, 4.0], 4, 2,
                           num_shards=4, device="cpu")
    items = pack_csr_table([0, 1, 2, 0], [0, 1, 2, 3], [1.0, 2.0, 3.0, 4.0], 3, 2,
                           num_shards=1, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        BroadcastALS(max_iter=1).fit(users, data_transposed=items)


def test_train_shim_warns_and_is_bitwise_fit():
    _, (td, tdt), _ = _tables()
    p = ALSParameters(rank=4, lam=0.05, max_iter=2)
    with pytest.warns(DeprecationWarning, match="BroadcastALS.train"):
        legacy = BroadcastALS.train(td, p, data_transposed=tdt)
    new = BroadcastALS(p).fit(td, data_transposed=tdt)
    assert torch.equal(legacy.U, new.U) and torch.equal(legacy.V, new.V)
    with pytest.warns(DeprecationWarning, match="defaultParameters"):
        assert BroadcastALS.defaultParameters() == ALSParameters()


def test_model_predict_partial_rebuild_and_from_reference():
    (jd, jdt), _, (r, c, v) = _tables()
    jm = JALS(JParams(rank=10, max_iter=3)).fit(jd, data_transposed=jdt)
    partial = {k: np.asarray(a) for k, a in jm.partial.items()}
    tm = from_reference("als", partial, device="cpu")
    assert set(tm.partial) == {"U", "V"}
    pairs = np.stack([r, c], 1)
    np.testing.assert_allclose(tm.predict(torch.from_numpy(pairs)).numpy(),
                               np.asarray(jm.predict(jnp.asarray(pairs))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tm.rmse(r, c, v).item(), float(jm.rmse(r, c, v)),
                               rtol=1e-5)
    back = BroadcastALS(rank=10).rebuild(tm.partial)
    assert torch.equal(back.predict(pairs), tm.predict(pairs))
    with pytest.raises(ValueError, match="partial holds"):
        from_reference("als", {"U": partial["U"]}, device="cpu")


def test_served_pairs_are_bitwise_the_offline_prediction():
    """Requests of 1..9 (user, item) pairs in microbatches of 8 (zero pad
    rows are the valid pair (0, 0)) against one predict of every pair."""
    _, (td, tdt), (r, c, v) = _tables()
    model = BroadcastALS(max_iter=2).fit(td, data_transposed=tdt)
    rng = np.random.default_rng(4)
    pool = np.stack([rng.integers(0, td.num_rows, 200),
                     rng.integers(0, tdt.num_rows, 200)], 1)
    offline = model.predict(torch.from_numpy(pool)).numpy()
    svc = ModelPredictor(model, max_batch=8, device="cpu")
    starts = np.cumsum([0] + [int(k) for k in rng.integers(1, 10, 30)])
    blocks = [pool[a:b] for a, b in zip(starts[:-1], starts[1:]) if b <= len(pool)]
    served = svc.predict_many(blocks)
    assert svc.report()["rows_padded"] > 0
    for block, a, out in zip(blocks, starts, served):
        np.testing.assert_array_equal(out, offline[a:a + len(block)])


def test_als_recommender_example_twin():
    """``examples/als_recommender.py`` on its own table: both packages fit
    the paper's hyperparameters (the port from JAX's init), reach RMSE <
    0.5 within FIT_TOL of each other, and recommend the same top 5 unseen
    items for user 0."""
    M = synth_netflix_tiled(users=128, items=96, rank=6, tiles=2, density=0.15)
    m, n = M.shape
    r, c, v = _coo(M)
    max_nnz = int(max((M != 0).sum(1).max(), (M != 0).sum(0).max()))
    jm = JALS(JParams(rank=10, lam=0.01, max_iter=10, seed=0)).fit(
        j_pack(r, c, v, m, max_nnz, num_shards=4),
        data_transposed=j_pack(c, r, v, n, max_nnz, num_shards=4))
    U0, V0 = _jax_init(m, n, 10, 0)
    tm = BroadcastALS(ALSParameters(rank=10, lam=0.01, max_iter=10, seed=0)).fit(
        pack_csr_table(r, c, v, m, max_nnz, num_shards=4, device="cpu"),
        data_transposed=pack_csr_table(c, r, v, n, max_nnz, num_shards=4, device="cpu"),
        init_factors=(U0, V0))
    rj, rt = float(jm.rmse(r, c, v)), tm.rmse(r, c, v).item()
    assert rt < 0.5 and abs(rt - rj) <= FIT_TOL * rj
    assert _rel(tm.U.numpy(), jm.U) <= FIT_TOL and _rel(tm.V.numpy(), jm.V) <= FIT_TOL
    seen = set(c[r == 0].tolist())

    def top5(scores):
        return [j for j in np.argsort(-scores) if j not in seen][:5]

    assert top5((tm.U[0] @ tm.V.T).numpy()) == top5(np.asarray(jm.U[0] @ jm.V.T))


def test_entry_points_take_the_device():
    """With ``device="cpu"`` everything lies on the CPU; the fit follows
    its table."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t = pack_csr_table([0, 1], [1, 0], [3.0, 4.0], 2, 1, device="cpu")
    assert t.device.type == "cpu"
    m = BroadcastALS(rank=2, max_iter=1).fit(t, data_transposed=t)
    assert m.U.device.type == m.V.device.type == "cpu"
