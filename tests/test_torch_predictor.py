"""The port's ModelPredictor against the JAX reference's.

Both services serve the same fitted model (the port's carried over from the
JAX fit with ``weights.from_reference``) and the same seeded requests of
mixed sizes; results must match (fp32 rtol = atol = 2e-4, assignments and
labels exact) and ``report()`` must agree on every key the port keeps.
"""
import numpy as np
import pytest

from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.algorithms.logistic_regression import LogisticRegression as JLR
from repro.core.numeric_table import MLNumericTable as JTable
from repro.serve.predictor import ModelPredictor as JPredictor
from repro.serve.predictor import PredictRequest as JRequest
from repro_torch.core.algorithms.kmeans import KMeansParameters
from repro_torch.core.algorithms.logistic_regression import (
    LogisticRegressionParameters,
)
from repro_torch.serve.predictor import ModelPredictor as TPredictor
from repro_torch.serve.predictor import PredictRequest as TRequest
from repro_torch.weights import from_reference

TOL = dict(rtol=2e-4, atol=2e-4)
SIZES = [3, 1, 9, 16, 2, 5]            # mixed: spans, fills and a padded tail


def _requests(d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, d)).astype(np.float32) for n in SIZES]


def _models(use_kernel):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    data = np.concatenate([(X[:, :1] > 0).astype(np.float32), X], axis=1)
    jl = JLR(max_iter=3, local_batch_size=4).fit(JTable.from_numpy(data, num_shards=4))
    jk = JKMeans(k=5, max_iter=3).fit(JTable.from_numpy(X, num_shards=4))
    tl = from_reference("logistic_regression",
                        {"weights": np.asarray(jl.weights)},
                        params=LogisticRegressionParameters(use_kernel=use_kernel),
                        device="cpu")
    tkm = from_reference("kmeans", {"centroids": np.asarray(jk.centroids)},
                         params=KMeansParameters(k=5, use_kernel=use_kernel),
                         device="cpu")
    return [(jl.predict_proba, tl.predict_proba), (jl.predict, tl.predict),
            (jk.predict, tkm.predict)]


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("max_batch", [4, 8, 64])
def test_results_and_report_match_reference(max_batch, use_kernel):
    blocks = _requests(8)
    for j_fn, t_fn in _models(use_kernel):
        js = JPredictor(model=None, max_batch=max_batch, predict_fn=j_fn)
        ts = TPredictor(model=None, max_batch=max_batch, predict_fn=t_fn,
                        device="cpu")
        want = js.predict_many(blocks)
        got = ts.predict_many(blocks)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, np.asarray(w), **TOL)
        t_rep, j_rep = ts.report(), js.report()
        assert t_rep == {k: j_rep[k] for k in t_rep}


def test_single_row_requests_and_request_fields():
    j_req, t_req = JRequest(features=np.ones(3)), TRequest(features=np.ones(3))
    assert t_req.features.shape == j_req.features.shape == (1, 3)
    with pytest.raises(ValueError, match=r"\(n, d\) rows"):
        TRequest(features=np.ones((2, 2, 2)))
    with pytest.raises(ValueError, match="featurizer"):
        TRequest(features="raw text")
    with pytest.raises(ValueError, match="max_batch must be positive"):
        TPredictor(model=None, max_batch=0, device="cpu")


def test_flush_is_timestamped_and_empty_flush_is_a_no_op():
    svc = TPredictor(model=None, max_batch=4, device="cpu",
                     predict_fn=lambda X: X.sum(dim=1))
    assert svc.flush() == []
    req = svc.submit(TRequest(features=np.ones((2, 3), np.float32)))
    assert svc.flush(now=2.5) == [req]
    assert req.done and req.finished_at == 2.5
    np.testing.assert_array_equal(req.result, [3.0, 3.0])


def test_flush_failure_keeps_queue():
    """As the reference, and held against it step by step: a predict
    failure mid-flush leaves every queued request intact and the stats
    rolled back; a retry serves the same requests."""
    def bad_predict(X):
        raise RuntimeError("boom")

    svc = TPredictor(model=None, max_batch=4, predict_fn=bad_predict,
                     device="cpu")
    ref = JPredictor(model=None, max_batch=4, predict_fn=bad_predict)
    blocks = [np.ones((2, 3), np.float32) * i for i in range(3)]
    reqs = [svc.submit(TRequest(features=b)) for b in blocks]
    ref_reqs = [ref.submit(JRequest(features=b)) for b in blocks]
    for s in (svc, ref):
        with pytest.raises(RuntimeError, match="boom"):
            s.flush()
    assert svc.queued == ref.queued == 3
    assert all(not r.done and r.result is None for r in reqs)
    assert svc.batches == 0 and svc.rows_padded == 0
    t_rep, j_rep = svc.report(), ref.report()
    assert t_rep == {k: j_rep[k] for k in t_rep}

    svc._predict = lambda X: X.sum(dim=1)
    ref._predict, ref._compiled = (lambda X: X.sum(axis=1)), None
    done = svc.flush()
    ref.flush()
    assert [r is q for r, q in zip(done, reqs)] == [True] * 3
    assert all(r.done and r.result.shape == (2,) for r in reqs)
    for r, q in zip(reqs, ref_reqs):
        np.testing.assert_array_equal(r.result, np.asarray(q.result))
    assert svc.queued == 0 and svc.rows_served == 6
    t_rep, j_rep = svc.report(), ref.report()
    assert t_rep == {k: j_rep[k] for k in t_rep}
