"""The port's featurizers and metrics against the JAX reference.

``NGrams`` (vocabulary, with planted ties in gram frequency, and counts)
and ``HashingVectorizer`` are compared exactly: same grams, same order,
same float values in every row the tables give, on the host tier and after
``to_numeric``.  ``TfIdf``, ``Standardizer`` and ``BiasAdder`` run in fp32
on both sides (jnp and torch): IDF weights, shifts, scales and transformed
tables at rtol = atol = 1e-6 (a log or a sum may round differently by an
ulp), pass-through columns bitwise.  The metrics at rtol = atol = 1e-5
(one fp32 sum order either side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.mltable import MLTable as JTable
from repro.core.numeric_table import MLNumericTable as JNumeric
from repro.eval import metrics as jm
from repro.features import scaling as jsc
from repro.features import text as jtx
from repro_torch.core.mltable import MLTable as TTable
from repro_torch.core.numeric_table import MLNumericTable as TNumeric
from repro_torch.data.synthetic import synth_labeled_text, synth_text_corpus
from repro_torch.eval import metrics as tm
from repro_torch.features import scaling as tsc
from repro_torch.features import text as ttx

TOL = dict(rtol=1e-6, atol=1e-6)
METRIC_TOL = dict(rtol=1e-5, atol=1e-5)


def _rows(table):
    return [tuple(r) for r in table.rows()]


def _tied_corpus(seed):
    """Docs over 6 words: many bigrams tie in corpus frequency, and the
    tied grams first occur in different partitions."""
    rng = np.random.default_rng(seed)
    words = np.array(["ka", "lo", "mi", "nu", "po", "ri"])
    docs = [" ".join(rng.choice(words, size=int(rng.integers(1, 7)))) for _ in range(23)]
    # planted ties: these bigrams occur exactly twice each, in reverse order
    # of first occurrence across the partitions
    docs += ["zz yy", "xx ww", "vv uu", "vv uu", "xx ww", "zz yy", "Zz, YY!", ""]
    return docs


# --------------------------------------------------------------------------- #
# NGrams and HashingVectorizer
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("parts", [1, 3, 5])
@pytest.mark.parametrize("top", [3, 12, 1000])
def test_ngram_vocabulary_equals_reference_with_ties(seed, parts, top):
    docs = _tied_corpus(seed)
    j = JTable.from_text(docs, num_partitions=parts)
    t = TTable.from_text(docs, num_partitions=parts)
    for n in (1, 2):
        jf = jtx.NGrams(n=n, top=top).fit(j)
        tf = ttx.NGrams(n=n, top=top).fit(t)
        assert tf.vocab == jf.vocab


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("parts", [1, 4])
def test_ngram_counts_equal_reference_exactly(keep, parts):
    rows = synth_labeled_text(n_docs=40, words_per_doc=12, seed=3) + [(1.0, "")]
    j = JTable.from_rows(rows, names=["label", "text"], num_partitions=parts)
    t = TTable.from_rows(rows, names=["label", "text"], num_partitions=parts)
    jf = jtx.NGrams(n=2, top=50, column="text", keep_columns=keep).fit(j)
    tf = ttx.NGrams(n=2, top=50, column="text", keep_columns=keep).fit(t)
    jt, tt = jf.transform(j), tf.transform(t)
    assert tt.schema.names == jt.schema.names
    assert [len(p) for p in tt.partitions] == [len(p) for p in jt.partitions]
    assert _rows(tt) == _rows(jt)
    assert tuple(tt.partitions[-1][-1]) == tuple(jt.partitions[-1][-1])
    assert [tuple(r) for r in tt.partitions[0][1:3]] == [tuple(r) for r in jt.partitions[0][1:3]]
    np.testing.assert_array_equal(tt.to_numeric(num_shards=1, device="cpu").to_numpy(),
                                  np.asarray(jt.to_numeric(num_shards=1).data))
    texts = [r[1] for r in rows[:9]]
    np.testing.assert_array_equal(tf.transform_rows(texts), jf.transform_rows(texts))
    np.testing.assert_array_equal(tf.transform_rows(texts[0]), jf.transform_rows(texts[0]))
    assert tf.host_state() == jf.host_state()


def test_count_table_ops_read_the_reference_rows():
    """Relational ops on a count table read the same rows (built from the
    count pairs) as the reference's dense rows."""
    rows = synth_labeled_text(n_docs=16, words_per_doc=8, seed=5)
    j = JTable.from_rows(rows, names=["label", "text"], num_partitions=3)
    t = TTable.from_rows(rows, names=["label", "text"], num_partitions=3)
    jt = jtx.NGrams(n=1, top=10, column="text").fit(j).transform(j)
    tt = ttx.NGrams(n=1, top=10, column="text").fit(t).transform(t)
    assert _rows(tt.filter(lambda r: r[0] > 0)) == _rows(jt.filter(lambda r: r[0] > 0))
    assert _rows(tt.project([0, 3])) == _rows(jt.project([0, 3]))
    assert tuple(tt.reduce(lambda a, b: [x + y for x, y in zip(a, b)])) == \
        tuple(jt.reduce(lambda a, b: [x + y for x, y in zip(a, b)]))
    u_t, u_j = tt.union(tt), jt.union(jt)
    np.testing.assert_array_equal(u_t.to_numeric(num_shards=2, device="cpu").to_numpy(),
                                  np.asarray(u_j.to_numeric(num_shards=2).data))
    with pytest.raises(IndexError):
        tt.partitions[0][99]


@pytest.mark.parametrize("num_features,n", [(7, 1), (64, 2), (1024, 1)])
def test_hashing_vectorizer_equals_reference_exactly(num_features, n):
    docs = synth_text_corpus(n_docs=20, words_per_doc=15, seed=num_features)
    j, t = JTable.from_text(docs, 3), TTable.from_text(docs, 3)
    jt = jtx.hashing_vectorizer(j, num_features=num_features, n=n)
    tt = ttx.hashing_vectorizer(t, num_features=num_features, n=n)
    assert tt.schema.names == jt.schema.names and _rows(tt) == _rows(jt)
    jf = jtx.HashingVectorizer(num_features=num_features, n=n).fit(j)
    tf = ttx.HashingVectorizer(num_features=num_features, n=n).fit(t)
    np.testing.assert_array_equal(tf.transform_rows(docs), jf.transform_rows(docs))
    assert tf.host_state() == jf.host_state()


def test_n_grams_shim_and_text_column_errors_match_reference():
    docs = synth_text_corpus(n_docs=12, words_per_doc=10, seed=1)
    j, t = JTable.from_text(docs, 2), TTable.from_text(docs, 2)
    assert _rows(ttx.n_grams(t, n=2, top=20)) == _rows(jtx.n_grams(j, n=2, top=20))
    for NG, table in ((ttx.NGrams, t), (jtx.NGrams, j)):
        with pytest.raises(KeyError):
            NG(column="nope").fit(table)
    # a count table keeps its text column out only when asked to
    with pytest.raises(TypeError):
        ttx.NGrams(n=1, top=5).fit(t).transform(t).union(t)


# --------------------------------------------------------------------------- #
# TfIdf
# --------------------------------------------------------------------------- #
def _count_tables(parts=3, shards=4, keep=True):
    rows = synth_labeled_text(n_docs=48, words_per_doc=14, seed=11)
    j = JTable.from_rows(rows, names=["label", "text"], num_partitions=parts)
    t = TTable.from_rows(rows, names=["label", "text"], num_partitions=parts)
    jc = jtx.NGrams(n=2, top=40, column="text", keep_columns=keep).fit(j).transform(j)
    tc = ttx.NGrams(n=2, top=40, column="text", keep_columns=keep).fit(t).transform(t)
    return jc, tc, jc.to_numeric(num_shards=shards), tc.to_numeric(num_shards=shards, device="cpu")


@pytest.mark.parametrize("skip,default_skip", [("auto", ()), ("auto", (0,)), (None, ()),
                                               (["label"], ()), ([0, 3], ())])
def test_tfidf_matches_reference(skip, default_skip):
    jc, tc, jn, tn = _count_tables()
    jf = jtx.TfIdf(skip=skip).fit(jn, default_skip=default_skip)
    tf = ttx.TfIdf(skip=skip).fit(tn, default_skip=default_skip)
    assert tf.skip_idx == jf.skip_idx and tf.label_idx == jf.label_idx
    assert tf.host_state() == jf.host_state()
    np.testing.assert_allclose(tf.idf.numpy(), np.asarray(jf.idf), **TOL)
    jo, to = jf.transform(jn), tf.transform(tn)
    assert to.names == jo.names and to.num_shards == jo.num_shards
    np.testing.assert_allclose(to.to_numpy(), np.asarray(jo.data), **TOL)
    feats = np.asarray(jn.data)[:, [i for i in range(jn.num_cols) if i not in jf.label_idx]]
    np.testing.assert_allclose(tf.apply(torch.from_numpy(feats)).numpy(),
                               np.asarray(jf.apply(jnp.asarray(feats))), **TOL)
    with pytest.raises(ValueError):
        tf.transform(TNumeric.from_numpy(feats[:, :5], device="cpu"))


def test_tfidf_on_the_host_tier_matches_reference():
    jc, tc, _, _ = _count_tables(keep=False)
    jf, tf = jtx.TfIdf().fit(jc), ttx.TfIdf(device="cpu").fit(tc)
    np.testing.assert_allclose(tf.idf.numpy(), np.asarray(jf.idf), **TOL)
    jo, to = jf.transform(jc), tf.transform(tc)
    assert to.num_partitions == jo.num_partitions and to.schema.names == jo.schema.names
    np.testing.assert_allclose(np.asarray(_rows(to)), np.asarray(_rows(jo)), **TOL)
    np.testing.assert_allclose(np.asarray(_rows(ttx.tf_idf(tc, device="cpu"))),
                               np.asarray(_rows(jtx.tf_idf(jc))), **TOL)


def test_tfidf_apply_is_the_table_transform_bitwise():
    """A served row's tf-idf is its table row's, bitwise: the row total adds
    integer counts (exact), the rest is elementwise."""
    _, tc, _, tn = _count_tables()
    tf = ttx.TfIdf().fit(tn, default_skip=(0,))
    table = tf.transform(tn).data
    rows = tc.partitions[1]
    served = tf.apply(torch.from_numpy(np.asarray([r.to_floats()[1:] for r in rows],
                                                  np.float32)))
    start = len(tc.partitions[0])
    assert torch.equal(served, table[start:start + len(rows), 1:])


# --------------------------------------------------------------------------- #
# Standardizer, BiasAdder, resolve_skip
# --------------------------------------------------------------------------- #
def _scaled_tables(shards=4, names=("label", "x1", "bias", "flat", "x4", "x5")):
    rng = np.random.default_rng(2)
    n = 32
    x = np.stack([rng.integers(0, 2, n).astype(np.float32),
                  rng.normal(3.0, 2.0, n), np.ones(n), np.full(n, 3.0),
                  rng.normal(size=n) * 1e3, rng.exponential(size=n)], 1).astype(np.float32)
    names = list(names) if names is not None else None
    return (JNumeric.from_numpy(x, num_shards=shards, names=names),
            TNumeric.from_numpy(x, num_shards=shards, device="cpu", names=names), x)


@pytest.mark.parametrize("skip", ["auto", None, ["x1", 0], [5]])
@pytest.mark.parametrize("default_skip", [(), (0,)])
def test_standardizer_matches_reference(skip, default_skip):
    jt, tt, x = _scaled_tables()
    jf = jsc.Standardizer(skip=skip).fit(jt, default_skip=default_skip)
    tf = tsc.Standardizer(skip=skip).fit(tt, default_skip=default_skip)
    assert tf.skip_idx == jf.skip_idx and tf.label_idx == jf.label_idx
    assert tf.host_state() == jf.host_state()
    np.testing.assert_allclose(tf.shift.numpy(), np.asarray(jf.shift), **TOL)
    np.testing.assert_allclose(tf.scale.numpy(), np.asarray(jf.scale), rtol=1e-6)
    np.testing.assert_allclose(tf.transform(tt).to_numpy(), np.asarray(jf.transform(jt).data),
                               **TOL)
    feats = x[:, [i for i in range(6) if i not in jf.label_idx]]
    np.testing.assert_allclose(tf.apply(torch.from_numpy(feats)).numpy(),
                               np.asarray(jf.apply(jnp.asarray(feats))), **TOL)
    assert torch.equal(tf.apply(torch.from_numpy(feats)),
                       tf.transform(tt).data[:, [i for i in range(6) if i not in tf.label_idx]])


@pytest.mark.parametrize("at", [None, 0, 2])
def test_bias_adder_matches_reference(at):
    jt, tt, x = _scaled_tables()
    jf = jsc.BiasAdder(at=at).fit(jt, default_skip=(0,))
    tf = tsc.BiasAdder(at=at).fit(tt, default_skip=(0,))
    assert tf.host_state() == jf.host_state()
    jo, to = jf.transform(jt), tf.transform(tt)
    assert to.names == jo.names
    np.testing.assert_array_equal(to.to_numpy(), np.asarray(jo.data))
    np.testing.assert_array_equal(tf.apply(torch.from_numpy(x[:, 1:])).numpy(),
                                  np.asarray(jf.apply(jnp.asarray(x[:, 1:]))))
    np.testing.assert_array_equal(tsc.add_bias(tt).to_numpy(), np.asarray(jsc.add_bias(jt).data))
    np.testing.assert_allclose(tsc.standardize(tt).to_numpy(),
                               np.asarray(jsc.standardize(jt).data), **TOL)


@pytest.mark.parametrize("names", [("label", "x1", "bias", "flat", "x4", "x5"),
                                   ("a", "LABEL", "b", "Bias", "c", "d"), None])
@pytest.mark.parametrize("skip", ["auto", None, (), [1, "x"], [9]])
def test_resolve_skip_and_labels_match_reference(names, skip):
    jt, tt, _ = _scaled_tables(names=names)
    for default_skip in ((), (0,), (0, 7)):
        calls = [(tsc.resolve_skip, jsc.resolve_skip, (skip, default_skip)),
                 (tsc.resolve_labels, jsc.resolve_labels, (default_skip,))]
        for t_fn, j_fn, args in calls:
            try:
                want = j_fn(jt, *args)
            except KeyError:
                with pytest.raises(KeyError):
                    t_fn(tt, *args)
                continue
            assert t_fn(tt, *args) == want
    with pytest.raises(ValueError):
        tsc.resolve_skip(tt, "label")


# --------------------------------------------------------------------------- #
# metrics
# --------------------------------------------------------------------------- #
def _clf_tables(shards=4, n=64, d=5):
    rng = np.random.default_rng(9)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (X @ w + 0.3 * rng.normal(size=n) > 0).astype(np.float32)
    data = np.concatenate([y[:, None], X], 1)
    return (JNumeric.from_numpy(data, num_shards=shards),
            TNumeric.from_numpy(data, num_shards=shards, device="cpu"), w)


@pytest.mark.parametrize("schedule", ["allreduce", "gather_broadcast", "reduce_scatter"])
@pytest.mark.parametrize("shards", [1, 4])
def test_classification_metrics_match_reference(schedule, shards):
    jt, tt, w = _clf_tables(shards)
    tw, W = torch.from_numpy(w), np.stack([w, -w, 0.5 * w])
    cases = [
        (tm.accuracy, jm.accuracy, lambda X: (X @ tw > 0).float(),
         lambda X: (X @ jnp.asarray(w) > 0).astype(jnp.float32)),
        (tm.log_loss, jm.log_loss, lambda X: torch.sigmoid(X @ tw),
         lambda X: 1 / (1 + jnp.exp(-(X @ jnp.asarray(w))))),
        (tm.rmse, jm.rmse, lambda X: X @ tw, lambda X: X @ jnp.asarray(w)),
        # stacked: (K, rows) predictions give (K,) scores from one pass
        (tm.accuracy, jm.accuracy, lambda X: (torch.from_numpy(W) @ X.T > 0).float(),
         lambda X: (jnp.asarray(W) @ X.T > 0).astype(jnp.float32)),
    ]
    for t_fn, j_fn, t_pred, j_pred in cases:
        np.testing.assert_allclose(t_fn(tt, t_pred, schedule=schedule).numpy(),
                                   np.asarray(j_fn(jt, j_pred, schedule=schedule)),
                                   **METRIC_TOL)
    np.testing.assert_array_equal(tm.predictions(tt, lambda X: X[:, 0] * 2).numpy(),
                                  np.asarray(jm.predictions(jt, lambda X: X[:, 0] * 2)))


@pytest.mark.parametrize("stacked", [False, True])
def test_silhouette_lite_matches_reference(stacked):
    rng = np.random.default_rng(4)
    X = np.concatenate([rng.normal(c, 0.5, size=(16, 3)) for c in (-3, 0, 3)]).astype(np.float32)
    C = JKMeans(k=3, max_iter=5).fit(JNumeric.from_numpy(X, num_shards=4)).centroids
    C = np.asarray(C)
    if stacked:
        C = np.stack([C, C[::-1] + 0.1, rng.normal(size=C.shape).astype(np.float32)])
    got = tm.silhouette_lite(TNumeric.from_numpy(X, num_shards=4, device="cpu"), C)
    want = jm.silhouette_lite(JNumeric.from_numpy(X, num_shards=4), jnp.asarray(C))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **METRIC_TOL)


def test_metric_history_matches_reference():
    th, jh = tm.MetricHistory(), jm.MetricHistory()
    for h in (th, jh):
        for trial, metric, epoch, value in [(1, "acc", 2, 0.5), (0, "acc", 1, 0.25),
                                            (1, "acc", 0, 0.1), (1, "loss", 0, 3),
                                            (1, "acc", 2, 0.75)]:
            h.record(trial, metric, epoch, value)
    assert th.to_dict() == jh.to_dict() and len(th) == len(jh) == 4
    assert th.series(1, "acc") == jh.series(1, "acc") == [(0, 0.1), (2, 0.75)]
    assert th.trials() == jh.trials() and th.metrics(1) == jh.metrics(1)
    assert th.last(1, "acc") == jh.last(1, "acc") and th.last(5, "x") is None
