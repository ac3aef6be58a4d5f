"""The port's KMeans against the JAX reference.

The reference draws its initial rows with ``jax.random.permutation``, which
the port cannot reproduce without JAX; the parity tests compute those rows
with JAX and hand them to the port as ``init_centroids``.  Both assignment
forms are compared like with like: the direct difference form (default)
and the expanded form (``use_kernel``; the port's plain version on the CPU,
the reference's Pallas kernel in interpret mode).  Tolerance: fp32
rtol = atol = 2e-4 (``tests/test_kernels.py``'s); assignments exact.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.numeric_table import MLNumericTable as JTable
from repro_torch.core.algorithms.kmeans import KMeans as TKMeans
from repro_torch.core.algorithms.kmeans import KMeansParameters
from repro_torch.core.algorithms.kmeans import _centroid_update
from repro_torch.core.numeric_table import MLNumericTable as TTable
from repro_torch.data.synthetic import synth_imagenet_features
from repro_torch.weights import from_reference

TOL = dict(rtol=2e-4, atol=2e-4)
SCHEDULES = ["allreduce", "gather_broadcast", "reduce_scatter"]


def _blobs(n=96, d=10, k=4, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 4.0
    X = centers[np.arange(n) % k] + rng.normal(size=(n, d))
    return X.astype(np.float32)


def _jax_init_rows(n, k, seed):
    return np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n)[:k])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("data,k,seed", [
    ("blobs", 4, 0),
    ("blobs", 7, 3),
    ("imagenet", 5, 1),
])
def test_fit_centroids_match_reference_from_jax_init(data, k, seed, use_kernel):
    X = _blobs(seed=seed) if data == "blobs" \
        else synth_imagenet_features(96, 24, seed=seed)[0]
    init = X[_jax_init_rows(X.shape[0], k, seed)]
    jm = JKMeans(k=k, max_iter=5, seed=seed, use_kernel=use_kernel).fit(
        JTable.from_numpy(X, num_shards=4))
    tm = TKMeans(k=k, max_iter=5, seed=seed, use_kernel=use_kernel).fit(
        TTable.from_numpy(X, num_shards=4, device="cpu"), init_centroids=init)
    np.testing.assert_allclose(tm.centroids.numpy(), np.asarray(jm.centroids),
                               **TOL)
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(tm.predict(Xt).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(X))))
    np.testing.assert_allclose(tm.inertia(Xt).item(),
                               float(jm.inertia(jnp.asarray(X))), **TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_agree(schedule):
    X = _blobs(seed=2)
    init = X[_jax_init_rows(96, 4, 0)]
    jm = JKMeans(k=4, max_iter=3, schedule=schedule).fit(
        JTable.from_numpy(X, num_shards=4))
    tm = TKMeans(k=4, max_iter=3, schedule=schedule).fit(
        TTable.from_numpy(X, num_shards=4, device="cpu"), init_centroids=init)
    np.testing.assert_allclose(tm.centroids.numpy(), np.asarray(jm.centroids),
                               **TOL)


def test_empty_cluster_keeps_its_centroid_like_the_reference():
    X = _blobs(seed=4)
    far = np.full((1, X.shape[1]), 1e3, np.float32)
    init = np.concatenate([X[:3], far])
    tm = TKMeans(k=4, max_iter=3).fit(
        TTable.from_numpy(X, num_shards=4, device="cpu"), init_centroids=init)
    np.testing.assert_array_equal(tm.centroids[3].numpy(), far[0])
    tot = np.concatenate([np.ones((2, 3), np.float32),
                          np.array([[2.0], [0.0]], np.float32)], axis=1)
    from repro.core.algorithms.kmeans import _centroid_update as j_update
    prev = np.full((2, 3), 7.0, np.float32)
    np.testing.assert_array_equal(
        _centroid_update(torch.from_numpy(prev), torch.from_numpy(tot)).numpy(),
        np.asarray(j_update(jnp.asarray(prev), jnp.asarray(tot))))


def test_seeded_init_draws_distinct_rows_deterministically():
    X = _blobs(n=64, seed=5)
    table = TTable.from_numpy(X, num_shards=2, device="cpu")
    a = TKMeans(k=6, max_iter=0, seed=3).fit(table).centroids.numpy()
    b = TKMeans(k=6, max_iter=0, seed=3).fit(table).centroids.numpy()
    c = TKMeans(k=6, max_iter=0, seed=4).fit(table).centroids.numpy()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    rows = {tuple(r) for r in X}
    assert len({tuple(r) for r in a}) == 6 and all(tuple(r) in rows for r in a)


def test_fit_rejects_bad_k_and_init_shape():
    table = TTable.from_numpy(_blobs(n=8), num_shards=2, device="cpu")
    with pytest.raises(ValueError, match="k exceeds number of rows"):
        TKMeans(k=9).fit(table)
    with pytest.raises(ValueError, match="init_centroids"):
        TKMeans(k=3).fit(table, init_centroids=np.zeros((2, 10), np.float32))


def test_from_reference_round_trips_a_jax_fit():
    X = _blobs(seed=6)
    jm = JKMeans(k=4, max_iter=3).fit(JTable.from_numpy(X, num_shards=4))
    partial = {k: np.asarray(v) for k, v in jm.partial.items()}
    tm = from_reference("kmeans", partial,
                        params=KMeansParameters(k=4, use_kernel=True),
                        device="cpu")
    np.testing.assert_array_equal(tm.centroids.numpy(), partial["centroids"])
    np.testing.assert_array_equal(tm.predict(torch.from_numpy(X)).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(X))))
    assert set(tm.partial) == {"centroids"}
