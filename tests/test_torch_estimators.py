"""The port's other estimators — linear regression and the linear SVM
(with L2, L1 and elastic-net regularization), PCA and Gaussian naive
Bayes — against the JAX reference on the CPU, with the ``train`` shims,
``partial`` / ``rebuild``, ``weights.from_reference``, the pipeline's stage
names and serving.

Tolerances: GLM weights within ``GLM_TOL`` of max |w| (SGD over a few
rounds; the reference's per-row gradients and the port's chunk sums add in
other orders and read ~1e-7 apart); PCA's explained variance and
components, each component up to its sign (LAPACK may return either),
within ``PCA_TOL``; naive Bayes' statistics within ``NB_TOL`` (sums of
whole fp32 rows) and its picks exactly; ``fixed_sum`` within fp32 rounding
of an fp64 sum.
"""
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.algorithms import linear_models as jlm
from repro.core.algorithms.naive_bayes import GaussianNaiveBayes as JNB
from repro.core.algorithms.pca import PCA as JPCA
from repro.core.mltable import MLTable as JTable
from repro.core.numeric_table import MLNumericTable as JNum
from repro.features import Standardizer as JStandardizer
from repro.pipeline import Pipeline as JPipeline
from repro.pipeline import pipeline as jpipeline_module
from repro_torch.core import algorithms as talg
from repro_torch.core.algorithms import linear_models as tlm
from repro_torch.core.algorithms.naive_bayes import GaussianNaiveBayes, NaiveBayesParameters
from repro_torch.core.algorithms.pca import PCA, PCAParameters
from repro_torch.core.fixed_sum import fixed_dot, fixed_sum
from repro_torch.core.mltable import MLTable
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.features import Standardizer
from repro_torch.pipeline import Pipeline
from repro_torch.pipeline import pipeline as tpipeline_module
from repro_torch.serve.predictor import ModelPredictor
from repro_torch.weights import from_reference, pipeline_from_reference

GLM_TOL = 1e-5
PCA_TOL = 1e-4
NB_TOL = 1e-5
SCHEDULES = ["allreduce", "gather_broadcast", "reduce_scatter"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _regression_table(n=128, d=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    y = (X @ w + 0.1 * rng.normal(size=n)).astype(np.float32)
    return np.concatenate([y[:, None], X], 1)


def _svm_table(n=128, d=12, seed=1):
    tab = _regression_table(n, d, seed)
    tab[:, 0] = np.where(tab[:, 0] >= 0, 1.0, -1.0)
    return tab


def _blobs(C=3, n_per=64, d=8, seed=0, scale=3.0):
    """``examples/pca_naive_bayes.py``'s data at a chosen size."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, d)) * scale
    X = np.concatenate([rng.normal(size=(n_per, d)) + centers[c]
                        for c in range(C)]).astype(np.float32)
    y = np.repeat(np.arange(C), n_per).astype(np.float32)
    return X, y


def _tables(tab, shards=4):
    return JNum.from_numpy(tab, num_shards=shards), \
        MLNumericTable.from_numpy(tab, num_shards=shards, device="cpu")


def _regs(mod):
    return {"none": mod.Regularization(),
            "l2": mod.Regularization(l2=0.1),
            "l1": mod.Regularization(l1=6.0),
            "elastic_net": mod.Regularization.elastic_net(12.0, 0.5)}


# --------------------------------------------------------------------------- #
# generalized linear models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("reg", ["none", "l2", "l1", "elastic_net"])
@pytest.mark.parametrize("batch", [1, 4])
def test_linear_regression_matches_the_reference(reg, batch):
    tab = _regression_table()
    jt, tt = _tables(tab)
    kw = dict(learning_rate=0.05, max_iter=5, local_batch_size=batch)
    jm = jlm.LinearRegression(reg=_regs(jlm)[reg], **kw).fit(jt)
    tm = tlm.LinearRegression(reg=_regs(tlm)[reg], **kw).fit(tt)
    w_j, w_t = np.asarray(jm.weights), tm.weights.numpy()
    assert tm.weights.dtype == torch.float32 and _rel(w_t, w_j) <= GLM_TOL
    if reg in ("l1", "elastic_net"):             # the prox zeroes weights
        assert (w_j == 0).sum() > 0
        np.testing.assert_array_equal(w_t == 0, w_j == 0)
    X = tab[:, 1:]
    np.testing.assert_allclose(tm.predict(torch.from_numpy(X)).numpy(),
                               np.asarray(jm.predict(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("reg", ["default", "l1"])
def test_linear_svm_matches_the_reference(schedule, reg):
    tab = _svm_table()
    jt, tt = _tables(tab)
    kw = dict(learning_rate=0.05, max_iter=5, local_batch_size=2, schedule=schedule)
    if reg == "l1":
        kw_j, kw_t = dict(reg=jlm.Regularization(l1=0.5)), dict(reg=tlm.Regularization(l1=0.5))
    else:
        kw_j = kw_t = {}
    jm = jlm.LinearSVM(**kw, **kw_j).fit(jt)
    tm = tlm.LinearSVM(**kw, **kw_t).fit(tt)
    assert _rel(tm.weights.numpy(), jm.weights) <= GLM_TOL
    X = tab[:, 1:]
    pred = tm.predict(torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(pred, np.asarray(jm.predict(jnp.asarray(X))))
    assert set(np.unique(pred)) <= {-1.0, 0.0, 1.0}
    assert (pred == tab[:, 0]).mean() > 0.8


def test_glm_chunk_gradient_adds_l2_once_per_row():
    """The chunk sum adds m·l2·W: one SGD step on one chunk of m rows is
    the reference's mean of per-row (gradient + l2·w)."""
    tab = _regression_table(n=8, d=5)
    one_step = dict(learning_rate=0.1, max_iter=1, local_batch_size=8,
                    reg=tlm.Regularization(l2=0.7))
    w = tlm.LinearRegression(**one_step).fit(
        MLNumericTable.from_numpy(tab, device="cpu")).weights.numpy()
    X, y = tab[:, 1:].astype(np.float64), tab[:, 0].astype(np.float64)
    g = np.mean([x * (x @ np.zeros(5) - t) + 0.7 * np.zeros(5) for x, t in zip(X, y)], 0)
    np.testing.assert_allclose(w, -0.1 * g, rtol=1e-6, atol=1e-7)
    # a second step sees w ≠ 0, so l2 matters: compare two steps with numpy
    two = tlm.LinearRegression(**dict(one_step, local_batch_size=4)).fit(
        MLNumericTable.from_numpy(tab, device="cpu")).weights.numpy()
    w64 = np.zeros(5)
    for rows in (slice(0, 4), slice(4, 8)):
        g = np.mean([x * (x @ w64 - t) + 0.7 * w64
                     for x, t in zip(X[rows], y[rows])], 0)
        w64 = w64 - 0.1 * g
    np.testing.assert_allclose(two, w64, rtol=1e-5, atol=1e-6)


def test_elastic_net_splits_alpha():
    r = tlm.Regularization.elastic_net(0.4, 0.25)
    assert (r.l1, r.l2) == (jlm.Regularization.elastic_net(0.4, 0.25).l1,
                            jlm.Regularization.elastic_net(0.4, 0.25).l2)


# --------------------------------------------------------------------------- #
# PCA
# --------------------------------------------------------------------------- #
def _signs(t, j):
    """+1/−1 per row of ``t`` that best aligns it with ``j``'s row."""
    return np.where((np.asarray(t) * np.asarray(j)).sum(-1) >= 0, 1.0, -1.0)


@pytest.mark.parametrize("shards", [1, 4])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_pca_matches_the_reference_up_to_sign(shards, k):
    X, _ = _blobs(C=4, n_per=32, d=10, seed=2)
    jt, tt = _tables(X, shards)
    jm = JPCA(n_components=k).fit(jt)
    tm = PCA(PCAParameters(n_components=k)).fit(tt)
    assert tm.components.shape == (k, 10) and tm.explained_variance.shape == (k,)
    ev_j = np.asarray(jm.explained_variance)
    assert _rel(tm.explained_variance.numpy(), ev_j) <= PCA_TOL
    assert np.all(np.diff(tm.explained_variance.numpy()) <= 0)     # descending
    np.testing.assert_allclose(tm.mean.numpy(), np.asarray(jm.mean), rtol=1e-6, atol=1e-6)
    s = _signs(tm.components.numpy(), jm.components)
    assert _rel(tm.components.numpy() * s[:, None], jm.components) <= PCA_TOL
    Z_t = tm.transform(torch.from_numpy(X)).numpy()
    Z_j = np.asarray(jm.transform(jnp.asarray(X)))
    assert _rel(Z_t * s, Z_j) <= PCA_TOL
    back = tm.inverse_transform(torch.from_numpy(Z_t)).numpy()
    np.testing.assert_allclose(back, np.asarray(jm.inverse_transform(jnp.asarray(Z_j))),
                               rtol=1e-4, atol=1e-4)


def test_pca_keeps_the_references_cancelling_covariance():
    """cov = total/n − mean·meanᵀ in fp32, as the reference: a large common
    offset cancels in both packages alike."""
    X, _ = _blobs(C=2, n_per=64, d=6, seed=3)
    X = X + 300.0
    jm, tm = JPCA(n_components=2).fit(_tables(X)[0]), PCA(n_components=2).fit(_tables(X)[1])
    assert _rel(tm.explained_variance.numpy(), jm.explained_variance) <= 1e-3


# --------------------------------------------------------------------------- #
# Gaussian naive Bayes
# --------------------------------------------------------------------------- #
def _nb_table(seed=0):
    X, y = _blobs(C=3, n_per=40, d=6, seed=seed)
    y = y.copy()
    y[0], y[1], y[2], y[3] = 5.0, 1.7, -0.5, 2.99   # out of range; truncated
    return np.concatenate([y[:, None], X], 1)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("num_classes", [3, 4])
def test_naive_bayes_matches_the_reference(schedule, num_classes):
    """A label outside 0..C−1 counts in no class (a zero one-hot row);
    float labels truncate toward zero; with C = 4, class 3 is empty and
    its count is clamped to 1."""
    tab = _nb_table()
    jt, tt = _tables(tab)
    jm = JNB(num_classes=num_classes, schedule=schedule).fit(jt)
    tm = GaussianNaiveBayes(NaiveBayesParameters(num_classes=num_classes,
                                                 schedule=schedule)).fit(tt)
    for key in ("priors", "means", "variances"):
        got, want = tm.partial[key].numpy(), np.asarray(jm.partial[key])
        assert got.shape == want.shape and _rel(got, want) <= NB_TOL, key
    X = tab[:, 1:]
    np.testing.assert_array_equal(tm.predict(torch.from_numpy(X)).numpy(),
                                  np.asarray(jm.predict(jnp.asarray(X))))
    np.testing.assert_allclose(tm.predict_log_proba(torch.from_numpy(X)).numpy(),
                               np.asarray(jm.predict_log_proba(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-4)


def test_naive_bayes_ties_go_to_the_first_class():
    m = GaussianNaiveBayes(num_classes=3).rebuild(
        {"priors": torch.full((3,), 1 / 3), "means": torch.zeros(3, 2),
         "variances": torch.ones(3, 2)})
    assert m.predict(torch.zeros(4, 2)).tolist() == [0, 0, 0, 0]


# --------------------------------------------------------------------------- #
# examples/pca_naive_bayes.py
# --------------------------------------------------------------------------- #
def test_pca_naive_bayes_example_twin():
    """The example's program on its own data (3 classes of 256 rows, d =
    16, PCA to 4, GaussianNB, 4 partitions): the same explained variance,
    picks and accuracy as the reference, accuracy > 0.9."""
    rng = np.random.default_rng(0)
    C, n_per, d = 3, 256, 16
    centers = rng.normal(size=(C, d)) * 3
    X = np.concatenate([rng.normal(size=(n_per, d)) + centers[c]
                        for c in range(C)]).astype(np.float32)
    y = np.repeat(np.arange(C), n_per).astype(np.float32)

    jp = JPCA(n_components=4).fit(JNum.from_numpy(X, num_shards=4))
    Zj = np.asarray(jp.transform(jnp.asarray(X)))
    jnb = JNB(num_classes=C).fit(JNum.from_numpy(
        np.concatenate([y[:, None], Zj], 1).astype(np.float32), num_shards=4))
    pred_j = np.asarray(jnb.predict(jnp.asarray(Zj)))

    tp = PCA(n_components=4).fit(MLNumericTable.from_numpy(X, num_shards=4, device="cpu"))
    Zt = tp.transform(torch.from_numpy(X))
    tnb = GaussianNaiveBayes(num_classes=C).fit(MLNumericTable.from_numpy(
        torch.cat([torch.from_numpy(y)[:, None], Zt], 1).numpy(), num_shards=4,
        device="cpu"))
    pred_t = tnb.predict(Zt).numpy()

    assert _rel(tp.explained_variance.numpy(), jp.explained_variance) <= PCA_TOL
    np.testing.assert_array_equal(pred_t, pred_j)
    acc = float((pred_t == y).mean())
    assert acc > 0.9 and acc == float((pred_j == y).mean())


# --------------------------------------------------------------------------- #
# shims, state and carrying the reference's models across
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", ["linreg", "svm", "pca", "nb"])
def test_train_shims_warn_and_equal_fit(name):
    est, tab = {"linreg": (tlm.LinearRegressionAlgorithm, _regression_table()),
                "svm": (tlm.LinearSVMAlgorithm, _svm_table()),
                "pca": (PCA, _blobs()[0]),
                "nb": (GaussianNaiveBayes, _nb_table())}[name]
    table = MLNumericTable.from_numpy(tab, num_shards=4, device="cpu")
    params = est.default_parameters()
    with pytest.warns(DeprecationWarning, match=f"{est.__name__}.train"):
        legacy = est.train(table, params)
    new = est(params).fit(table)
    for key, value in new.partial.items():
        assert torch.equal(legacy.partial[key], value)
    with pytest.warns(DeprecationWarning, match="defaultParameters"):
        assert est.defaultParameters() == est.default_parameters()
    rebuilt = est(params).rebuild(new.partial)
    x = torch.from_numpy(np.ascontiguousarray(tab[:, 1:] if est.supervised else tab))
    assert torch.equal(rebuilt.predict(x), new.predict(x))


@pytest.mark.parametrize("kind", ["linear_regression", "linear_svm", "pca", "naive_bayes"])
def test_from_reference_carries_each_kind(kind):
    tab = {"linear_regression": _regression_table(), "linear_svm": _svm_table(),
           "pca": _blobs()[0], "naive_bayes": _nb_table()}[kind]
    j_est = {"linear_regression": jlm.LinearRegression(max_iter=3, learning_rate=0.05),
             "linear_svm": jlm.LinearSVM(max_iter=3, learning_rate=0.05),
             "pca": JPCA(n_components=3), "naive_bayes": JNB(num_classes=3)}[kind]
    jm = j_est.fit(JNum.from_numpy(tab, num_shards=4))
    partial = {k: np.asarray(v) for k, v in jm.partial.items()}
    tm = from_reference(kind, partial, device="cpu")
    for key, value in tm.partial.items():
        np.testing.assert_array_equal(value.numpy(), partial[key])
    x = np.ascontiguousarray(tab[:, 1:] if kind != "pca" else tab)
    got, want = tm.predict(torch.from_numpy(x)).numpy(), np.asarray(jm.predict(jnp.asarray(x)))
    if kind in ("linear_svm", "naive_bayes"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="partial holds"):
        from_reference(kind, {**partial, "extra": partial[next(iter(partial))]}, device="cpu")


def test_algorithms_package_exports_the_references_names():
    from repro.core import algorithms as jalg

    assert talg.__all__ == jalg.__all__
    for name in jalg.__all__ + ["PCA", "PCAModel", "PCAParameters", "GaussianNaiveBayes",
                                "NaiveBayesModel", "NaiveBayesParameters"]:
        assert hasattr(talg, name), name


def test_pipeline_stage_names_match_the_reference():
    assert tpipeline_module._DEFAULT_NAMES == jpipeline_module._DEFAULT_NAMES
    names = {type(e).__name__: e for e in (
        tlm.LinearRegression(), tlm.LinearSVM(), PCA(), GaussianNaiveBayes(),
        talg.BroadcastALS())}
    assert [Pipeline([e], device="cpu").estimator_name for e in names.values()] == \
        ["linreg", "svm", "pca", "naive_bayes", "als"]


@pytest.mark.parametrize("terminal", ["linreg", "nb"])
def test_pipeline_with_a_new_terminal_matches_the_reference(terminal):
    """Standardizer → LinearRegression / GaussianNaiveBayes as one
    pipeline in both packages, and the reference's fitted pipeline carried
    across with ``pipeline_from_reference``."""
    tab = _regression_table() if terminal == "linreg" else _nb_table()
    if terminal == "linreg":
        t_est = tlm.LinearRegression(learning_rate=0.05, max_iter=4, local_batch_size=4)
        j_est = jlm.LinearRegression(learning_rate=0.05, max_iter=4, local_batch_size=4)
    else:
        t_est, j_est = GaussianNaiveBayes(num_classes=3), JNB(num_classes=3)
    tpipe = Pipeline([Standardizer(), t_est], num_shards=4, device="cpu")
    jpipe = JPipeline([JStandardizer(), j_est], num_shards=4)
    tfit = tpipe.fit(MLTable.from_numpy(tab))
    jfit = jpipe.fit(JTable.from_numpy(tab))
    for key, value in tfit.model.partial.items():
        assert _rel(value.numpy(), jfit.model.partial[key]) <= GLM_TOL
    x = tab[:, 1:]
    carried = pipeline_from_reference(
        tpipe, jfit.host_state(),
        {"stages": {n: {k: np.asarray(v) for k, v in s.items()}
                    for n, s in jfit.partial["stages"].items()},
         "model": {k: np.asarray(v) for k, v in jfit.partial["model"].items()}},
        device="cpu")
    assert type(carried.model) is type(tfit.model)
    got, want = carried.predict(x).numpy(), np.asarray(jfit.predict(x))
    if terminal == "nb":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------- #
# serving and the fixed-order sums
# --------------------------------------------------------------------------- #
def _served(model, rows, max_batch, seed=0):
    rng = np.random.default_rng(seed)
    starts = np.cumsum([0] + [int(k) for k in rng.integers(1, 7, 40)])
    starts = starts[starts <= len(rows)]
    if starts[-1] % max_batch == 0:          # leave the last microbatch short
        starts = starts[:-1]
    blocks = [rows[a:b] for a, b in zip(starts[:-1], starts[1:])]
    svc = ModelPredictor(model, max_batch=max_batch, device="cpu")
    return blocks, starts, svc.predict_many(blocks), svc.report()


@pytest.mark.parametrize("kind", ["linreg", "svm", "nb", "pca"])
def test_served_predictions_equal_the_offline_ones(kind):
    """GLMs and naive Bayes sum in fixed orders: served rows are bitwise
    the offline prediction of the whole table.  PCA's projection is a
    matmul; it is held within fp32 rounding."""
    if kind in ("linreg", "svm"):
        tab = _regression_table() if kind == "linreg" else _svm_table()
        est = tlm.LinearRegression(max_iter=2, learning_rate=0.05) if kind == "linreg" \
            else tlm.LinearSVM(max_iter=2, learning_rate=0.05)
        rows = tab[:, 1:].copy()
    elif kind == "nb":
        tab = _nb_table()
        est, rows = GaussianNaiveBayes(num_classes=3), tab[:, 1:].copy()
    else:
        tab = _blobs()[0]
        est, rows = PCA(n_components=3), tab.copy()
    model = est.fit(MLNumericTable.from_numpy(tab, num_shards=4, device="cpu"))
    offline = model.predict(torch.from_numpy(rows)).numpy()
    blocks, starts, served, report = _served(model, rows, max_batch=8)
    assert report["rows_padded"] > 0
    for block, a, out in zip(blocks, starts, served):
        if kind == "pca":
            np.testing.assert_allclose(out, offline[a:a + len(block)], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(out, offline[a:a + len(block)])


@pytest.mark.parametrize("d", [1, 2, 7, 10, 64, 1000, 4097])
def test_fixed_sum_is_a_sum_whose_order_ignores_the_rows(d):
    rng = np.random.default_rng(d)
    x = torch.from_numpy(rng.normal(size=(33, d)).astype(np.float32))
    got = fixed_sum(x)
    want = x.double().sum(-1)
    scale = x.abs().double().sum(-1) * d * 2.0 ** -24
    assert bool(((got.double() - want).abs() <= scale + 1e-30).all())
    for i in (0, 5, 32):
        assert torch.equal(fixed_sum(x[i:i + 1])[0], got[i])
        assert torch.equal(fixed_sum(x[i]), got[i])
    w = torch.from_numpy(rng.normal(size=d).astype(np.float32))
    assert torch.equal(fixed_dot(x, w), fixed_sum(x * w))
    assert fixed_sum(torch.zeros(3, 0)).tolist() == [0.0, 0.0, 0.0]


def test_fixed_dot_chunks_rows_without_changing_a_bit(monkeypatch):
    from repro_torch.core import fixed_sum as fs

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(50, 9)).astype(np.float32))
    w = torch.linspace(-1, 1, 9)
    whole = fixed_dot(x, w)
    monkeypatch.setattr(fs, "_CHUNK_ELEMENTS", 20)
    assert torch.equal(fs.fixed_dot(x, w), whole)


def test_no_warnings_on_the_cpu_paths():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tab = _regression_table(n=16, d=3)
        tlm.LinearRegression(max_iter=1).fit(MLNumericTable.from_numpy(tab, device="cpu"))
        GaussianNaiveBayes().fit(MLNumericTable.from_numpy(_nb_table(), device="cpu"))
