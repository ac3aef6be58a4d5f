"""The port's LogisticRegression, optimizers and weights carry-over against
the JAX reference.

Same seeded table (label in column 0) through ``repro`` (JAX, CPU; its
kernel path runs the Pallas kernels in interpret mode) and ``repro_torch``
(``device="cpu"``; its kernel path runs the kernels' plain versions).
Tolerance: fp32 rtol = atol = 2e-4 (``tests/test_kernels.py``'s).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.algorithms.logistic_regression import LogisticRegression as JLR
from repro.core.numeric_table import MLNumericTable as JTable
from repro.core.optimizer import soft_threshold as j_soft_threshold
from repro_torch.core.algorithms.logistic_regression import (
    LogisticRegression as TLR,
    LogisticRegressionParameters,
)
from repro_torch.core.numeric_table import MLNumericTable as TTable
from repro_torch.core.optimizer import soft_threshold as t_soft_threshold
from repro_torch.data.synthetic import synth_classification
from repro_torch.weights import from_reference

TOL = dict(rtol=2e-4, atol=2e-4)
SCHEDULES = ["allreduce", "gather_broadcast", "reduce_scatter"]


def _table(n=64, d=12, seed=0):
    X, y, _ = synth_classification(n, d, seed=seed)
    return np.concatenate([y[:, None], X], axis=1)


def _fit_both(data, num_shards=4, **kw):
    jm = JLR(**kw).fit(JTable.from_numpy(data, num_shards=num_shards))
    tm = TLR(**kw).fit(TTable.from_numpy(data, num_shards=num_shards,
                                         device="cpu"))
    return jm, tm


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("solver,extra", [
    ("sgd", dict(learning_rate=0.5)),
    ("sgd", dict(learning_rate=0.3, local_batch_size=4, lr_decay=0.8)),
    ("sgd", dict(learning_rate=0.3, local_batch_size=2, l1=0.01, l2=0.05)),
    ("gd", dict(learning_rate=0.02)),
    ("gd", dict(learning_rate=0.02, l1=0.001, l2=0.1)),
])
def test_fit_weights_match_reference(solver, extra, use_kernel):
    data = _table()
    jm, tm = _fit_both(data, max_iter=3, solver=solver, use_kernel=use_kernel,
                       **extra)
    assert tm.weights.dtype == torch.float32 and tm.weights.shape == (12,)
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights),
                               **TOL)


@pytest.mark.parametrize("solver,lr", [("sgd", 0.3), ("gd", 0.02)])
def test_kernel_path_drops_l2_like_the_reference(solver, lr):
    """The reference's kernel gradient ignores l2; the port keeps that."""
    data = _table(seed=1)
    common = dict(max_iter=2, solver=solver, learning_rate=lr,
                  local_batch_size=2, use_kernel=True)
    _, with_l2 = _fit_both(data, l2=0.5, **common)
    _, without = _fit_both(data, **common)
    np.testing.assert_array_equal(with_l2.weights.numpy(),
                                  without.weights.numpy())
    _, plain = _fit_both(data, max_iter=2, solver=solver, learning_rate=lr,
                         local_batch_size=2, l2=0.5)
    assert not np.allclose(plain.weights.numpy(), without.weights.numpy())


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_schedules_agree(schedule):
    data = _table(seed=2)
    jm, tm = _fit_both(data, max_iter=2, local_batch_size=4, schedule=schedule)
    np.testing.assert_allclose(tm.weights.numpy(), np.asarray(jm.weights), **TOL)
    base = TLR(max_iter=2, local_batch_size=4).fit(
        TTable.from_numpy(data, num_shards=4, device="cpu"))
    np.testing.assert_allclose(tm.weights.numpy(), base.weights.numpy(), **TOL)


def test_model_outputs_match_reference():
    data = _table(seed=3)
    jm, tm = _fit_both(data, max_iter=3, local_batch_size=2)
    X, y = data[:, 1:], data[:, 0]
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    np.testing.assert_allclose(tm.predict_proba(Xt).numpy(),
                               np.asarray(jm.predict_proba(jnp.asarray(X))), **TOL)
    np.testing.assert_array_equal(tm.predict(Xt).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(X))))
    np.testing.assert_allclose(tm.loss(Xt, yt).item(),
                               float(jm.loss(jnp.asarray(X), jnp.asarray(y))),
                               **TOL)
    assert set(tm.partial) == {"weights"}


def test_kernel_model_predicts_like_the_plain_model():
    data = _table(seed=4)
    w = TLR(max_iter=2).fit(TTable.from_numpy(data, num_shards=4,
                                              device="cpu")).weights
    plain = TLR(use_kernel=False).rebuild({"weights": w})
    fused = TLR(use_kernel=True).rebuild({"weights": w})
    X = torch.from_numpy(data[:, 1:])
    np.testing.assert_allclose(fused.predict_proba(X).numpy(),
                               plain.predict_proba(X).numpy(), **TOL)
    np.testing.assert_allclose(fused.predict_proba(X[0]).numpy(),
                               plain.predict_proba(X[0]).numpy(), **TOL)
    np.testing.assert_array_equal(fused.predict(X).numpy(),
                                  plain.predict(X).numpy())


def test_bad_local_batch_size_raises_reference_text():
    data = _table(n=48)
    with pytest.raises(ValueError) as t_err:
        TLR(local_batch_size=5).fit(TTable.from_numpy(data, num_shards=4,
                                                      device="cpu"))
    with pytest.raises(ValueError) as j_err:
        JLR(local_batch_size=5).fit(JTable.from_numpy(data, num_shards=4))
    assert str(t_err.value) == str(j_err.value)


def test_soft_threshold_matches_reference():
    w = np.linspace(-1, 1, 11).astype(np.float32)
    np.testing.assert_allclose(
        t_soft_threshold(0.3)(torch.from_numpy(w), 0.5).numpy(),
        np.asarray(j_soft_threshold(0.3)(jnp.asarray(w), 0.5)), **TOL)


def test_parameters_overrides_and_defaults():
    est = TLR(learning_rate=0.3, use_kernel=True)
    assert est.overrides() == {"learning_rate": 0.3, "use_kernel": True}
    assert TLR.default_parameters() == LogisticRegressionParameters()
    assert TLR(LogisticRegressionParameters(), max_iter=4).params.max_iter == 4
    assert JLR(learning_rate=0.3).overrides() == {"learning_rate": 0.3}


def test_from_reference_round_trips_a_jax_fit():
    data = _table(seed=5)
    jm = JLR(max_iter=3).fit(JTable.from_numpy(data, num_shards=4))
    partial = {k: np.asarray(v) for k, v in jm.partial.items()}
    tm = from_reference("logistic_regression", partial, device="cpu")
    X = data[:, 1:]
    np.testing.assert_array_equal(tm.weights.numpy(), partial["weights"])
    np.testing.assert_allclose(tm.predict_proba(torch.from_numpy(X)).numpy(),
                               np.asarray(jm.predict_proba(jnp.asarray(X))), **TOL)
    back = {k: v.numpy() for k, v in tm.partial.items()}
    np.testing.assert_array_equal(back["weights"], partial["weights"])
    with pytest.raises(ValueError, match="unknown model kind"):
        from_reference("random_forest", partial, device="cpu")
    with pytest.raises(ValueError, match="holds exactly"):
        from_reference("logistic_regression", {"w": 1}, device="cpu")
