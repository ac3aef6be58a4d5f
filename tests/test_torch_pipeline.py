"""The paper's Fig. A2 program end to end in the port, against the JAX
reference on the same rows, and against the port's own hand-composed chain.

Two flows, at the examples' sizes:

  * the k-means program of ``examples/quickstart.py`` (demos 1 and 2):
    ``NGrams(2, top=64) → TfIdf → KMeans(k=4)`` on 64 synthetic docs;
  * the classifier of ``examples/text_pipeline.py``: ``NGrams(1, top=64,
    column="text") → TfIdf → Standardizer → LogisticRegression`` on 128
    labeled docs, served as raw text through ``ModelPredictor``.

The reference runs in emulated mode (``num_shards``), its kernels in
Pallas interpret mode; the port runs on the CPU (``device="cpu"``), its
kernels' plain versions.  Tolerances: featurized tables at rtol = atol =
1e-6 (fp32 elementwise maps; a log may round differently by an ulp);
centroids and weights at ``tests/test_kernels.py``'s fp32 2e-4; labels,
vocabularies, served results and memo counts exactly; the pipeline against
its hand-composed chain bitwise.  The port's k-means draws its initial rows
with ``torch.randperm`` where the reference uses ``jax.random.permutation``,
so the k-means half is held in two steps: the featurized tables, then the
port's chain fed JAX's initial rows through ``init_centroids=`` against
the reference's fitted model.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.algorithms.logistic_regression import LogisticRegression as JLR
from repro.core.mltable import MLTable as JTable
from repro.features import NGrams as JNGrams
from repro.features import Standardizer as JStandardizer
from repro.features import TfIdf as JTfIdf
from repro.pipeline import Pipeline as JPipeline
from repro.serve import ModelPredictor as JPredictor
from repro.serve import PredictRequest as JRequest
from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.mltable import MLTable
from repro_torch.data.synthetic import synth_labeled_text, synth_text_corpus
from repro_torch.features import BiasAdder, NGrams, Standardizer, TfIdf
from repro_torch.pipeline import Pipeline
from repro_torch.serve.predictor import ModelPredictor, PredictRequest
from repro_torch.weights import pipeline_from_reference

FEAT_TOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=2e-4, atol=2e-4)
SCHEDULES = ["allreduce", "gather_broadcast", "reduce_scatter"]
LOGREG = dict(learning_rate=0.5, max_iter=8, local_batch_size=4)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _host_tree(tree):
    return {k: _host_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


# --------------------------------------------------------------------------- #
# the k-means program (examples/quickstart.py, demos 1-2)
# --------------------------------------------------------------------------- #
DOCS = synth_text_corpus(n_docs=64, words_per_doc=40)


def _kmeans_pipes(use_kernel=False, schedule="allreduce"):
    t = Pipeline([NGrams(n=2, top=64), TfIdf(),
                  KMeans(k=4, max_iter=10, seed=0, schedule=schedule,
                         use_kernel=use_kernel)], num_shards=4, device="cpu")
    j = JPipeline([JNGrams(n=2, top=64), JTfIdf(),
                   JKMeans(k=4, max_iter=10, seed=0, schedule=schedule,
                           use_kernel=use_kernel)], num_shards=4)
    return t, j


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_program_matches_reference_from_jax_init(use_kernel):
    traw, jraw = MLTable.from_text(DOCS, 4), JTable.from_text(DOCS, 4)
    tpipe, jpipe = _kmeans_pipes(use_kernel)
    tfit, jfit = tpipe.fit(traw), jpipe.fit(jraw)
    assert tfit["ngrams"].vocab == jfit["ngrams"].vocab
    np.testing.assert_allclose(_np(tfit["tfidf"].idf), _np(jfit["tfidf"].idf), **FEAT_TOL)
    ttab, jtab = tfit.transform(traw), jfit.transform(jraw)
    assert ttab.names == jtab.names and ttab.num_shards == jtab.num_shards == 4
    np.testing.assert_allclose(_np(ttab.data), _np(jtab.data), **FEAT_TOL)
    # the port's chain on its own table, from the rows JAX draws
    rows = np.array(jax.random.permutation(jax.random.PRNGKey(0), ttab.num_rows)[:4])
    init = ttab.data[torch.from_numpy(rows)]
    model = KMeans(k=4, max_iter=10, seed=0, use_kernel=use_kernel).fit(
        ttab, init_centroids=init)
    np.testing.assert_allclose(_np(model.centroids), _np(jfit.model.centroids), **TOL)
    np.testing.assert_array_equal(_np(model.predict(ttab.data)),
                                  _np(jfit.model.predict(jtab.data)))
    np.testing.assert_array_equal(_np(model.predict(ttab.data)),
                                  _np(jfit.predict(DOCS)))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_kmeans_pipeline_equals_its_hand_composed_chain(use_kernel):
    raw = MLTable.from_text(DOCS, 4)
    fitted = _kmeans_pipes(use_kernel)[0].fit(raw)
    ngrams = NGrams(n=2, top=64).fit(raw)
    counts = ngrams.transform(raw).to_numeric(num_shards=4, device="cpu")
    tfidf = TfIdf().fit(counts)
    table = tfidf.transform(counts)
    model = KMeans(k=4, max_iter=10, seed=0, use_kernel=use_kernel).fit(table)
    assert ngrams.vocab == fitted["ngrams"].vocab
    assert torch.equal(tfidf.idf, fitted["tfidf"].idf)
    assert torch.equal(table.data, fitted.transform(raw).data)
    assert torch.equal(model.centroids, fitted.model.centroids)


def test_kmeans_schedules_agree():
    raw = MLTable.from_text(DOCS, 4)
    inertia, centroids = {}, []
    for sched in SCHEDULES:
        fitted = _kmeans_pipes(schedule=sched)[0].fit(raw)
        table = fitted.transform(raw)
        inertia[sched] = fitted.model.inertia(table.data).item()
        centroids.append(fitted.model.centroids)
    spread = max(inertia.values()) - min(inertia.values())
    assert spread < 1e-3 * max(1.0, max(inertia.values())), inertia
    assert all(torch.equal(c, centroids[0]) for c in centroids)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_row_by_row_replay_equals_the_whole_table(use_kernel):
    raw = MLTable.from_text(DOCS, 4)
    fitted = _kmeans_pipes(use_kernel)[0].fit(raw)
    table = fitted.transform(raw)
    whole = fitted.model.predict(table.data)
    assert torch.equal(fitted.predict(DOCS), whole)
    assert torch.equal(torch.cat([fitted.predict(d) for d in DOCS[:12]]), whole[:12])
    # count rows (the host tier's output) take the device chain directly
    counts = fitted["ngrams"].transform_rows(DOCS)
    assert torch.equal(fitted.predict(counts), whole)
    # a fold view replayed with its own layout: no refit
    view = fitted.transform(MLTable.from_text(DOCS[:6], 2), num_shards=2)
    assert view.num_shards == 2 and torch.equal(view.data, table.data[:6])


# --------------------------------------------------------------------------- #
# the classifier (examples/text_pipeline.py), served as raw text
# --------------------------------------------------------------------------- #
ROWS = synth_labeled_text(n_docs=128, words_per_doc=20, seed=0)


def _text_pipes(use_kernel=False):
    t = Pipeline([NGrams(n=1, top=64, column="text"), TfIdf(), Standardizer(),
                  LogisticRegression(**LOGREG, use_kernel=use_kernel)],
                 num_shards=8, device="cpu")
    j = JPipeline([JNGrams(n=1, top=64, column="text"), JTfIdf(), JStandardizer(),
                   JLR(**LOGREG, use_kernel=use_kernel)], num_shards=8)
    return t, j


def _raw(rows=ROWS):
    return (MLTable.from_rows(rows, names=["label", "text"], num_partitions=4),
            JTable.from_rows(rows, names=["label", "text"], num_partitions=4))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_text_program_matches_reference(use_kernel):
    traw, jraw = _raw()
    tpipe, jpipe = _text_pipes(use_kernel)
    assert tpipe.supervised and jpipe.supervised
    tfit, jfit = tpipe.fit(traw), jpipe.fit(jraw)
    assert tfit["ngrams"].vocab == jfit["ngrams"].vocab
    for stage in ("tfidf", "standardizer"):
        assert tfit[stage].host_state() == jfit[stage].host_state()
    np.testing.assert_allclose(_np(tfit["standardizer"].shift),
                               _np(jfit["standardizer"].shift), **FEAT_TOL)
    np.testing.assert_allclose(_np(tfit["standardizer"].scale),
                               _np(jfit["standardizer"].scale), rtol=1e-6)
    ttab, jtab = tfit.transform(traw), jfit.transform(jraw)
    np.testing.assert_allclose(_np(ttab.data), _np(jtab.data), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(ttab.data[:, 0]), [r[0] for r in ROWS])
    np.testing.assert_allclose(_np(tfit.model.weights), _np(jfit.model.weights), **TOL)
    tpred = tfit.model.predict(ttab.data[:, 1:])
    np.testing.assert_array_equal(_np(tpred), _np(jfit.model.predict(jtab.data[:, 1:])))
    np.testing.assert_array_equal(_np(tfit.predict([t for _, t in ROWS])), _np(tpred))
    assert (_np(tpred) == _np(ttab.data[:, 0])).mean() > 0.9
    assert tpipe.describe() == jpipe.describe()
    assert tpipe.stage_names() == jpipe.stage_names() == ["ngrams", "tfidf", "standardizer"]
    assert tpipe.estimator_name == jpipe.estimator_name == "logreg"


@pytest.mark.parametrize("use_kernel", [False, True])
def test_text_pipeline_equals_its_hand_composed_chain(use_kernel):
    raw, _ = _raw()
    fitted = _text_pipes(use_kernel)[0].fit(raw)
    table = fitted.transform(raw)
    ngrams = NGrams(n=1, top=64, column="text").fit(raw)
    counts = ngrams.transform(raw).to_numeric(num_shards=8, device="cpu")
    tfidf = TfIdf().fit(counts, default_skip=(0,))
    scaled_in = tfidf.transform(counts)
    standardizer = Standardizer().fit(scaled_in, default_skip=(0,))
    final = standardizer.transform(scaled_in)
    hand = LogisticRegression(**LOGREG, use_kernel=use_kernel).fit(final)
    assert torch.equal(final.data, table.data)
    assert torch.equal(hand.weights, fitted.model.weights)
    assert torch.equal(hand.predict(final.data[:, 1:]), fitted.model.predict(table.data[:, 1:]))


def _requests(n=40, seed=0):
    rng = np.random.default_rng(seed)
    texts = [t for _, t in ROWS]
    return [texts[int(i)] if k % 3 else [texts[int(j)] for j in rng.integers(0, 24, 1 + k % 5)]
            for k, i in enumerate(rng.integers(0, 24, n))]


@pytest.mark.parametrize("max_batch,cache", [(16, 512), (5, 512), (16, 8), (16, 0)])
def test_raw_text_serving_equals_offline_and_reference(max_batch, cache):
    traw, jraw = _raw()
    tpipe, jpipe = _text_pipes()
    tfit, jfit = tpipe.fit(traw), jpipe.fit(jraw)
    offline = _np(tfit.predict([t for _, t in ROWS]))
    index = {t: i for i, (_, t) in enumerate(ROWS)}
    tsvc = ModelPredictor(tfit, max_batch=max_batch, featurize_cache=cache, device="cpu")
    jsvc = JPredictor(jfit, max_batch=max_batch, featurize_cache=cache)
    reqs = _requests()
    treqs = [tsvc.submit(PredictRequest(features=r)) for r in reqs]
    jreqs = [jsvc.submit(JRequest(features=r)) for r in reqs]
    assert all(r.raw for r in treqs) and tsvc.queued == len(reqs)
    tsvc.flush(now=2.0)
    jsvc.flush(now=2.0)
    for req, tr, jr in zip(reqs, treqs, jreqs):
        docs = [req] if isinstance(req, str) else req
        assert tr.done and not tr.raw and tr.finished_at == 2.0
        np.testing.assert_array_equal(tr.result, offline[[index[d] for d in docs]])
        np.testing.assert_array_equal(tr.result, np.asarray(jr.result))
    trep, jrep = tsvc.report(), jsvc.report()
    for key in ("batches", "rows_served", "rows_padded", "featurize_hits",
                "featurize_misses", "featurize_cache"):
        assert trep[key] == jrep[key], key


def test_raw_requests_fail_fast_and_a_failed_flush_keeps_the_queue():
    raw, _ = _raw()
    fitted = _text_pipes()[0].fit(raw)
    numeric = ModelPredictor(fitted.model, max_batch=4, device="cpu")
    with pytest.raises(ValueError, match="no featurizer"):
        numeric.submit(PredictRequest(features="some text"))
    calls = []

    def flaky(rows):
        calls.append(len(rows))
        if len(calls) == 1:
            raise RuntimeError("featurizer down")
        return fitted.featurize_rows(rows)

    svc = ModelPredictor(fitted, max_batch=4, featurize=flaky, device="cpu")
    reqs = [svc.submit(PredictRequest(features=[t for _, t in ROWS[i:i + 3]]))
            for i in (0, 3)]
    with pytest.raises(RuntimeError):
        svc.flush()
    assert svc.queued == 2 and all(r.raw and not r.done for r in reqs)
    assert svc.report()["batches"] == 0
    svc.flush()
    assert svc.queued == 0 and all(r.done for r in reqs)
    np.testing.assert_array_equal(np.concatenate([r.result for r in reqs]),
                                  _np(fitted.predict([t for _, t in ROWS[:6]])))


# --------------------------------------------------------------------------- #
# carrying the reference's fitted pipeline across
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("flow", ["kmeans", "text"])
def test_pipeline_from_reference_round_trips(flow):
    if flow == "kmeans":
        tpipe, jpipe = _kmeans_pipes()
        traw, jraw = MLTable.from_text(DOCS, 4), JTable.from_text(DOCS, 4)
        raw_rows = DOCS
    else:
        tpipe, jpipe = _text_pipes()
        traw, jraw = _raw()
        raw_rows = [t for _, t in ROWS]
    jfit = jpipe.fit(jraw)
    carried = pipeline_from_reference(tpipe, jfit.host_state(), _host_tree(jfit.partial),
                                      device="cpu")
    assert carried.host_state() == jfit.host_state()
    assert carried.device.type == "cpu" and carried.num_cols == jfit.num_cols
    np.testing.assert_allclose(_np(carried.transform(traw).data),
                               _np(jfit.transform(jraw).data), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(carried.predict(raw_rows)), _np(jfit.predict(raw_rows)))
    for name, f in carried.stages:
        for key, value in f.partial.items():
            np.testing.assert_array_equal(value.numpy(), _np(jfit[name].partial[key]))
    with pytest.raises(ValueError, match="stages"):
        pipeline_from_reference(Pipeline([TfIdf(), KMeans(k=4)], device="cpu"),
                                jfit.host_state(), _host_tree(jfit.partial), device="cpu")


# --------------------------------------------------------------------------- #
# the Pipeline object
# --------------------------------------------------------------------------- #
def test_pipeline_construction_matches_reference():
    from repro.features import BiasAdder as JBias

    t = Pipeline([NGrams(n=1), TfIdf(), ("scale", Standardizer()), TfIdf(), BiasAdder()],
                 device="cpu")
    j = JPipeline([JNGrams(n=1), JTfIdf(), ("scale", JStandardizer()), JTfIdf(), JBias()])
    assert t.stage_names() == j.stage_names() == ["ngrams", "tfidf", "scale", "tfidf2", "bias"]
    assert t.estimator is None and not t.supervised
    assert t.describe() == j.describe()
    for bad, err in (([], ValueError), ([NGrams, KMeans(k=2)], TypeError),
                     ([KMeans(k=2), TfIdf()], TypeError), ([TfIdf(), object()], TypeError)):
        with pytest.raises(err):
            Pipeline(bad, device="cpu")
    raw = MLTable.from_text(DOCS, 4)
    feats = t.fit(raw)
    assert feats.model is None and feats.num_cols == feats.transform(raw).num_cols
    with pytest.raises(KeyError):
        feats["nope"]
    with pytest.raises(TypeError, match="host-tier"):
        Pipeline([TfIdf(), NGrams(n=1)], device="cpu").fit(
            MLTable.from_rows([(1.0, 2.0)], names=["x", "y"]))
    np.testing.assert_allclose(
        feats.predict(DOCS[:5]).numpy(),
        feats.transform(MLTable.from_text(DOCS[:5], 1), num_shards=1).data.numpy(), **FEAT_TOL)
