"""Model search in the port (`repro_torch.tune`) against the reference.

The same seeded numpy tables go through the reference's ``repro.tune``
(emulated partitions, JAX on the CPU: its mesh path fails on the installed
jax) and the port's (``device="cpu"``).  Tolerances: 1e-5 on weights and
scores, the reference's own (``tests/test_tune.py``); the splits, config
enumerations, fingerprints, groupings and stopping decisions are equal;
the port's stacked and sequential executions, and a trial against its
estimator's ``fit`` on the same train view, are equal bit for bit (a lane
runs its trial's launches alone).  ``train_stacked`` iterates normal-
equation solves, as ``tests/test_torch_als.py``'s fits do: its factors are
held at that file's 1e-3 of max |factor| (the reference's own stacked test
allows 1e-3 too).  The k-means trials start from the rows JAX picks,
handed in through a builder that wraps the port's ``trial_spec``.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.numeric_table import MLNumericTable as RefTable
from repro.tune import MedianStoppingRule as RefMedian
from repro.tune import ModelSearch as RefSearch
from repro.tune import cv as rcv
from repro.tune import grid as ref_grid
from repro.tune import sample as ref_sample
from repro.tune import trials as rtrials
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.tune import (KFold, MedianStoppingRule, ModelSearch, fold_view,
                              grid, holdout_split, record_evaluation, sample)
from repro_torch.tune import cv as pcv
from repro_torch.tune import trials as ptrials

TOL = 1e-5
FIT_TOL = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clf(rows=96, d=6, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    y = (X @ np.linspace(-1, 1, d).astype(np.float32) > 0).astype(np.float32)
    return np.concatenate([y[:, None], X], 1)


@pytest.fixture(scope="module")
def clf():
    return _clf()


def _tables(data, shards=4):
    return (MLNumericTable.from_numpy(data, num_shards=shards, device="cpu"),
            RefTable.from_numpy(data, num_shards=shards))


def _same(got, want, tol=TOL):
    assert [t.config for t in got.trials] == [t.config for t in want.trials]
    assert [t.stopped for t in got.trials] == [t.stopped for t in want.trials]
    for a, b in zip(got.trials, want.trials):
        np.testing.assert_allclose(a.rung_scores, b.rung_scores, atol=tol)
        np.testing.assert_allclose(a.state.numpy(), np.asarray(b.state), atol=tol)
    assert got.best.config == want.best.config


def _bitwise(a, b):
    assert [t.config for t in a.trials] == [t.config for t in b.trials]
    for x, y in zip(a.trials, b.trials):
        assert x.rung_scores == y.rung_scores and x.stopped == y.stopped
        assert torch.equal(x.state, y.state)


# --------------------------------------------------------------------------- #
# splits
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("n,k,seed", [(10, 2, 0), (97, 5, 3), (128, 8, 1),
                                      (33, 33, 7), (1000, 3, 42)])
def test_kfold_indices_equal_the_reference(n, k, seed):
    ours, ref = KFold(n, k, seed), rcv.KFold(n, k, seed)
    for f in range(k):
        for a, b in zip(ours.split(f), ref.split(f)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.val_indices(f), ref.val_indices(f))
        np.testing.assert_array_equal(ours.train_indices(f), ref.train_indices(f))
    for (a, b), (c, d) in zip(ours.splits(), ref.splits()):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError):
        ours.split(k)


@pytest.mark.parametrize("n,frac,seed", [(96, 0.25, 0), (10, 0.5, 3), (7, 0.1, 1),
                                         (1000, 0.33, 9), (5, 0.75, 2)])
def test_holdout_indices_equal_the_reference(n, frac, seed):
    for a, b in zip(holdout_split(n, frac, seed), rcv.holdout_split(n, frac, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,frac", [(4, 0.875), (2, 0.6), (3, 0.9), (1, 0.5),
                                    (10, 0.0), (10, 1.0)])
def test_holdout_raises_where_the_reference_raises(n, frac):
    """Kept as the reference has it: ceil(frac·n) = n (or 0) raises even
    for a fraction < 1 (ROADMAP Queue 3)."""
    with pytest.raises(ValueError):
        rcv.holdout_split(n, frac)
    with pytest.raises(ValueError):
        holdout_split(n, frac)


@pytest.mark.parametrize("kw", [dict(num_rows=5, k=1), dict(num_rows=3, k=4)])
def test_kfold_validates_like_the_reference(kw):
    with pytest.raises(ValueError):
        rcv.KFold(**kw)
    with pytest.raises(ValueError):
        KFold(**kw)


@pytest.mark.parametrize("idx_n,shards", [(48, 4), (30, 4), (96, 8)])
def test_fold_view_equals_the_reference(clf, idx_n, shards):
    idx = np.sort(np.random.default_rng(idx_n).permutation(96)[:idx_n])
    ours, ref = _tables(clf, shards)
    got, want = fold_view(ours, idx), rcv.fold_view(ref, idx)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.num_shards == want.num_shards
    assert got.device == torch.device("cpu")


def test_take_rows_of_an_mltable_equals_the_reference():
    from repro.core.mltable import MLTable as RefMLTable
    from repro_torch.core.mltable import MLTable

    rows = [(float(i % 2), f"doc {i}") for i in range(12)]
    idx = np.asarray([1, 4, 5, 9])
    got = pcv.take_rows(MLTable.from_rows(rows, names=["label", "text"]), idx)
    want = rcv.take_rows(RefMLTable.from_rows(rows, names=["label", "text"]), idx)
    assert [tuple(r) for r in got.collect()] == [tuple(r) for r in want.collect()]
    assert got.num_partitions == want.num_partitions


# --------------------------------------------------------------------------- #
# enumeration, fingerprint, grouping
# --------------------------------------------------------------------------- #
SPACES = [{"learning_rate": [0.05, 0.3], "l2": [0.0, 0.01]},
          {"k": [2, 3, 4], "seed": [0, 1]},
          {"a": [1], "b": ["x", "y"], "c": [0.5, 1.5, 2.5]}]


@pytest.mark.parametrize("space", SPACES)
def test_grid_equals_the_reference(space):
    assert grid(space) == ref_grid(space)


@pytest.mark.parametrize("n,seed", [(8, 0), (32, 0), (5, 3)])
@pytest.mark.parametrize("space", [
    {"learning_rate": ("loguniform", 0.01, 1.0), "l2": [0.0, 0.01]},
    {"lr": ("uniform", 0.1, 0.2), "bs": [1, 2, 4], "decay": ("loguniform", 0.5, 1.0)}])
def test_sample_equals_the_reference(space, n, seed):
    assert sample(space, n, seed) == ref_sample(space, n, seed)


def test_enumeration_refusals_match_the_reference():
    for fn in (grid, ref_grid):
        with pytest.raises(ValueError, match="sample"):
            fn({"lr": ("loguniform", 0.01, 0.5)})
    for fn in (sample, ref_sample):
        with pytest.raises(ValueError, match="positive"):
            fn({"lr": ("loguniform", 0.0, 0.5)}, 2)
        with pytest.raises(ValueError, match="exceeds"):
            fn({"lr": ("uniform", 1.0, 0.5)}, 2)


@pytest.mark.parametrize("kw", [
    dict(algorithm="logreg", num_epochs=3),
    dict(algorithm="logreg", num_epochs=4, folds=3, chunks_per_epoch=2,
         schedule="gather_broadcast", execution="sequential"),
    dict(algorithm="kmeans", num_epochs=5, metric="silhouette", seed=2),
    dict(algorithm="logreg", num_epochs=4, rung_epochs=1, early_stop="median")])
def test_fingerprint_equals_the_reference(clf, kw):
    kw = dict(kw)
    rule = kw.pop("early_stop", None)
    configs = grid(SPACES[0])
    ours = ModelSearch(configs=configs, early_stop=rule and MedianStoppingRule(), **kw)
    ref = RefSearch(configs=configs, early_stop=rule and RefMedian(), **kw)
    pt, rt = _tables(clf)
    assert ours._fingerprint(pt) == ref._fingerprint(rt)
    assert ours._rungs() == ref._rungs()
    assert ptrials.fingerprint({"a": [1, 2], "b": "x"}) == \
        rtrials.fingerprint({"a": [1, 2], "b": "x"})


def test_group_trials_equals_the_reference():
    from repro.core.algorithms.logistic_regression import \
        LogisticRegressionAlgorithm as RefLR
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression

    configs = [{"learning_rate": 0.1}, {"learning_rate": 0.3, "local_batch_size": 8},
               {"learning_rate": 0.2}, {"l2": 0.01}, {"l1": 0.05}]
    ours = [LogisticRegression.trial_spec(c) for c in configs]
    ref = [RefLR.trial_spec(c) for c in configs]
    for mode in ("auto", "stacked", "sequential"):
        assert ptrials.group_trials(ours, mode) == rtrials.group_trials(ref, mode)
    assert [s.stack_key for s in ours] == [s.stack_key for s in ref]
    with pytest.raises(ValueError):
        ptrials.group_trials(ours, "bogus")


def test_tree_stack_roundtrip():
    trees = [{"w": torch.arange(3.0) * i, "b": torch.tensor(float(i))} for i in range(4)]
    stacked = ptrials.tree_stack(trees)
    assert stacked["w"].shape == (4, 3) and stacked["b"].shape == (4,)
    for orig, back in zip(trees, ptrials.tree_unstack(stacked)):
        assert torch.equal(orig["w"], back["w"]) and torch.equal(orig["b"], back["b"])


def test_trial_specs_refuse_what_the_reference_refuses():
    from repro_torch.core.algorithms.kmeans import KMeans
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.core.interfaces import Searchable

    assert issubclass(LogisticRegression, Searchable) and issubclass(KMeans, Searchable)
    with pytest.raises(ValueError, match="kernel"):
        LogisticRegression.trial_spec({"use_kernel": True})
    with pytest.raises(ValueError, match="sgd"):
        LogisticRegression.trial_spec({"solver": "gd"})
    with pytest.raises(ValueError, match="metric"):
        LogisticRegression.trial_spec({}, metric="auc")
    with pytest.raises(ValueError, match="kernel"):
        KMeans.trial_spec({"use_kernel": True})
    with pytest.raises(ValueError, match="metric"):
        KMeans.trial_spec({}, metric="inertia")
    spec = LogisticRegression.trial_spec({"learning_rate": 0.3})
    assert all(v.dtype == torch.float32 and v.ndim == 0 for v in spec.hyper.values())


# --------------------------------------------------------------------------- #
# logistic regression searches
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("folds,chunks,shards,metric", [
    (None, 1, 4, None), (None, 2, 2, "log_loss"), (3, 1, 4, None), (2, 2, 4, "log_loss")])
def test_grid_search_matches_the_reference(clf, folds, chunks, shards, metric):
    configs = grid({"learning_rate": [0.05, 0.1, 0.2, 0.3], "l2": [0.0, 0.01]})
    kw = dict(num_epochs=3, chunks_per_epoch=chunks, folds=folds, metric=metric, seed=0)
    pt, rt = _tables(clf, shards)
    want = RefSearch("logreg", configs, execution="stacked", **kw).run(rt)
    stacked = ModelSearch("logreg", configs, execution="stacked", **kw).run(pt)
    seq = ModelSearch("logreg", configs, execution="sequential", **kw).run(pt)
    _same(stacked, want)
    _bitwise(stacked, seq)


@pytest.mark.parametrize("bs", [1, 2, 3])
def test_a_trial_is_its_fit_on_the_train_view_bit_for_bit(clf, bs):
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression

    configs = grid({"learning_rate": [0.05, 0.3], "l2": [0.0, 0.01],
                    "local_batch_size": [bs]})
    pt, _ = _tables(clf)
    res = ModelSearch("logreg", configs, num_epochs=3, seed=0).run(pt)
    tr, _ = holdout_split(pt.num_rows, 0.25, seed=0)
    view = fold_view(pt, tr)
    for t in res.trials:
        solo = LogisticRegression(max_iter=3, schedule="allreduce", **t.config).fit(view)
        assert torch.equal(t.state, solo.weights)
        assert torch.equal(t.model.weights, t.state)


def test_l1_stacks_with_unregularized_and_matches_the_reference(clf):
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression

    configs = [{"learning_rate": 0.3}, {"learning_rate": 0.3, "l1": 0.05}]
    assert ptrials.group_trials([LogisticRegression.trial_spec(c) for c in configs]) == [[0, 1]]
    pt, rt = _tables(clf)
    got = ModelSearch("logreg", configs, num_epochs=3, seed=0).run(pt)
    _same(got, RefSearch("logreg", configs, num_epochs=3, seed=0).run(rt))
    w_plain, w_l1 = (t.state for t in got.trials)
    assert w_l1.abs().sum() < w_plain.abs().sum()


# --------------------------------------------------------------------------- #
# k-means (ragged k), from the rows JAX picks
# --------------------------------------------------------------------------- #
def _jax_rows_builder(metric=None):
    from repro_torch.core.algorithms.kmeans import KMeans

    def build(cfg):
        spec = KMeans.trial_spec(cfg, **({"metric": metric} if metric else {}))
        k, seed = cfg.get("k", 8), cfg.get("seed", 0)

        def init(table):
            rows = np.array(jax.random.permutation(jax.random.PRNGKey(seed),
                                                   table.num_rows)[:k])
            return table.data[torch.as_tensor(rows)]
        return dataclasses.replace(spec, init=init)
    return build


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(5)
    return np.concatenate([rng.normal(size=(48, 4)),
                           4 + rng.normal(size=(48, 4))]).astype(np.float32)


@pytest.mark.parametrize("folds", [None, 2])
def test_kmeans_ragged_k_search_matches_the_reference(blobs, folds):
    configs = [{"k": 2, "seed": 0}, {"k": 2, "seed": 1}, {"k": 4, "seed": 0},
               {"k": 3, "seed": 2}, {"k": 4, "seed": 1}]
    kw = dict(num_epochs=5, folds=folds, seed=0)
    pt, rt = _tables(blobs)
    want = RefSearch("kmeans", configs, **kw).run(rt)
    got = ModelSearch(_jax_rows_builder(), configs, **kw).run(pt)
    _same(got, want)
    assert got.best.config["k"] == 2
    assert [tuple(t.state.shape) for t in got.trials] == [(2, 4), (2, 4), (4, 4), (3, 4), (4, 4)]
    _bitwise(got, ModelSearch(_jax_rows_builder(), configs, execution="sequential",
                              **kw).run(pt))
    # the port's own seeded init is a valid start too (its logged deviation)
    own = ModelSearch("kmeans", configs, **kw).run(pt)
    assert all(np.isfinite(t.score) for t in own.trials)


# --------------------------------------------------------------------------- #
# median rule and callbacks in a search
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("execution", ["stacked", "sequential"])
def test_median_rule_search_matches_the_reference(clf, execution):
    from repro.eval.metrics import MetricHistory as RefHistory
    from repro.tune import record_evaluation as ref_record
    from repro_torch.eval.metrics import MetricHistory

    configs = grid({"learning_rate": [1e-4, 1e-3, 0.05, 0.3, 0.5]})
    kw = dict(num_epochs=4, folds=None, execution=execution, seed=0, rung_epochs=1)
    pt, rt = _tables(clf)
    h, rh = MetricHistory(), RefHistory()
    got = ModelSearch("logreg", configs, early_stop=MedianStoppingRule(1, 2),
                      callbacks=(record_evaluation(h),), **kw).run(pt)
    want = RefSearch("logreg", configs, early_stop=RefMedian(1, 2),
                     callbacks=(ref_record(rh),), **kw).run(rt)
    _same(got, want)
    assert not all(t.stopped for t in got.trials)
    assert any(t.stopped for t in got.trials) or execution == "sequential"
    for t in got.trials:
        assert [v for _, v in h.series(t.index, "score")] == t.rung_scores
        assert [e for e, _ in h.series(t.index, "score")] == \
            [e for e, _ in rh.series(t.index, "score")]
    # a frozen lane keeps its bits: a stopped trial's state is its state
    # after the epochs it ran (the median rule is synchronous in a stack and
    # asynchronous across sequential units, in both packages, so the two
    # executions may stop different trials)
    for t in got.trials:
        alone = ModelSearch("logreg", [t.config], num_epochs=len(t.rung_scores),
                            seed=0).run(pt)
        assert torch.equal(alone.trials[0].state, t.state)


def test_search_level_callbacks_steer_only_hyper(clf):
    from repro_torch.tune import early_stopping

    pt, _ = _tables(clf)
    configs = grid({"learning_rate": [0.1, 0.3]})
    with pytest.raises(ValueError, match="only swap 'hyper'"):
        ModelSearch("logreg", configs, num_epochs=2, rung_epochs=1,
                    callbacks=(lambda env: {"active": env.active},)).run(pt)
    halted = ModelSearch("logreg", configs, num_epochs=4, rung_epochs=1,
                         execution="sequential",
                         callbacks=(early_stopping(1),)).run(pt)
    assert 0 < len(halted.trials) <= 2


# --------------------------------------------------------------------------- #
# checkpoint and resume
# --------------------------------------------------------------------------- #
class Interrupt(Exception):
    pass


def _bomb(at):
    def cb(units_done, trial_indices):
        if units_done == at:
            raise Interrupt
    return cb


@pytest.mark.parametrize("execution,at", [("sequential", 2), ("sequential", 5),
                                          ("stacked", 1)])
def test_search_resumes_trial_for_trial(clf, tmp_path, execution, at):
    configs = grid({"learning_rate": [0.05, 0.1, 0.3], "l2": [0.0, 0.01],
                    "local_batch_size": [1]}) + [{"learning_rate": 0.1, "local_batch_size": 2}]
    kw = dict(num_epochs=3, folds=2, execution=execution, seed=0)
    pt, _ = _tables(clf)
    full = ModelSearch("logreg", configs, **kw).run(pt)
    with pytest.raises(Interrupt):
        ModelSearch("logreg", configs, ckpt_dir=str(tmp_path), unit_callback=_bomb(at),
                    **kw).run(pt)
    resumed = ModelSearch("logreg", configs, ckpt_dir=str(tmp_path), **kw).run(
        pt, resume=True)
    _bitwise(full, resumed)


def test_resume_refuses_a_mismatched_search(clf, tmp_path):
    kw = dict(num_epochs=2, folds=None, execution="sequential", seed=0)
    pt, _ = _tables(clf)
    ModelSearch("logreg", grid({"learning_rate": [0.1, 0.3]}), ckpt_dir=str(tmp_path),
                **kw).run(pt)
    with pytest.raises(ValueError, match="fingerprint"):
        ModelSearch("logreg", grid({"learning_rate": [0.1, 0.5]}),
                    ckpt_dir=str(tmp_path), **kw).run(pt, resume=True)
    bigger = MLNumericTable.from_numpy(np.concatenate([clf] * 2), num_shards=4, device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        ModelSearch("logreg", grid({"learning_rate": [0.1, 0.3]}),
                    ckpt_dir=str(tmp_path), **kw).run(bigger, resume=True)
    with pytest.raises(ValueError, match="ckpt_dir"):
        ModelSearch("logreg", grid({"learning_rate": [0.1]}), **kw).run(pt, resume=True)


def test_checkpointer_snapshots_cross_packages(tmp_path):
    info = {0: {"score": 0.5, "rung_scores": [0.5], "stopped": False},
            2: {"score": 0.7, "rung_scores": [0.6, 0.7], "stopped": True}}
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    ptrials.SearchCheckpointer(pd, "fp").save(
        {0: torch.arange(3.0), 2: torch.ones(3)}, info, units_done=2,
        live={5: [torch.full((3,), 5.0), torch.full((3,), 6.0)]}, extra={"asha": {"x": 1}})
    rtrials.SearchCheckpointer(rd, "fp").save(
        {0: jnp.arange(3.0), 2: jnp.ones(3)}, info, units_done=2,
        live={5: [jnp.full((3,), 5.0), jnp.full((3,), 6.0)]}, extra={"asha": {"x": 1}})
    for src in (pd, rd):
        s1, i1, u1, l1, e1 = rtrials.SearchCheckpointer(src, "fp").resume(
            lambda i: jnp.zeros(3), with_live=True)
        s2, i2, u2, l2, e2 = ptrials.SearchCheckpointer(src, "fp").resume(
            lambda i: torch.zeros(3), with_live=True)
        assert i1 == i2 == info and u1 == u2 == 2 and e1 == e2 == {"asha": {"x": 1}}
        for k in (0, 2):
            np.testing.assert_array_equal(np.asarray(s1[k]), s2[k].numpy())
        np.testing.assert_array_equal(np.asarray(l1[5][1]), l2[5][1].numpy())
        assert s2[0].device == torch.device("cpu")
        with pytest.raises(ValueError, match="fingerprint"):
            ptrials.SearchCheckpointer(src, "other").resume(lambda i: torch.zeros(3))


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_search_interrupted_in_one_package_resumes_in_the_other(clf, tmp_path, writer):
    configs = grid({"learning_rate": [0.05, 0.1, 0.3], "l2": [0.0, 0.01]})
    kw = dict(num_epochs=3, folds=None, execution="sequential", seed=0)
    pt, rt = _tables(clf)
    want = RefSearch("logreg", configs, **kw).run(rt)
    first, second = ((ModelSearch, pt), (RefSearch, rt))[::1 if writer == "port" else -1]
    with pytest.raises(Interrupt):
        first[0]("logreg", configs, ckpt_dir=str(tmp_path), unit_callback=_bomb(3),
                 **kw).run(first[1])
    got = second[0]("logreg", configs, ckpt_dir=str(tmp_path), **kw).run(
        second[1], resume=True)
    for a, b in zip(got.trials, want.trials):
        np.testing.assert_allclose(np.asarray(a.state), np.asarray(b.state), atol=TOL)
        assert a.score == pytest.approx(b.score, abs=TOL)


# --------------------------------------------------------------------------- #
# pipeline search
# --------------------------------------------------------------------------- #
def _pipelines(top=16):
    from repro.core.algorithms.logistic_regression import \
        LogisticRegressionAlgorithm as RefLR
    from repro.features import NGrams as RN, Standardizer as RS, TfIdf as RT
    from repro.pipeline import Pipeline as RefPipeline
    from repro_torch.core.algorithms.logistic_regression import LogisticRegression
    from repro_torch.features import NGrams, Standardizer, TfIdf
    from repro_torch.pipeline import Pipeline

    return (Pipeline([NGrams(n=1, top=top, column="text"), TfIdf(), Standardizer(),
                      LogisticRegression(local_batch_size=2)], num_shards=4, device="cpu"),
            RefPipeline([RN(n=1, top=top, column="text"), RT(), RS(),
                         RefLR(local_batch_size=2)], num_shards=4))


def _raw(n=96):
    from repro.core.mltable import MLTable as RefMLTable
    from repro_torch.core.mltable import MLTable
    from repro_torch.data import synth_labeled_text

    rows = synth_labeled_text(n_docs=n, seed=0)
    return (MLTable.from_rows(rows, names=["label", "text"], num_partitions=4),
            RefMLTable.from_rows(rows, names=["label", "text"], num_partitions=4), rows)


def test_pipeline_plumbing_equals_the_reference():
    ours, ref = _pipelines()
    assert ours.describe() == ref.describe()
    cfg = {"ngrams.top": 8, "logreg.learning_rate": 0.3, "l2": 0.01}
    assert ours.split_config(cfg) == ref.split_config(cfg)
    clone = ours.with_stage_config({"ngrams": {"top": 8}})
    assert clone.describe() == ref.with_stage_config({"ngrams": {"top": 8}}).describe()
    assert clone.estimator is ours.estimator and clone.device == "cpu"
    assert clone.num_shards == ours.num_shards
    with pytest.raises(KeyError):
        ours.split_config({"bogus.top": 1})


@pytest.mark.parametrize("folds", [None, 2])
def test_pipeline_search_matches_the_reference(folds):
    from repro_torch.serve.predictor import ModelPredictor, PredictRequest

    ours, ref = _pipelines()
    raw, ref_raw, rows = _raw()
    configs = grid({"ngrams.top": [8, 16], "logreg.learning_rate": [0.1, 0.5]})
    kw = dict(num_epochs=2, folds=folds, seed=0)
    fits = []
    orig = type(ours._stages[0][1]).fit

    def counted(self, *a, **k):
        fits.append(self.top)
        return orig(self, *a, **k)
    type(ours._stages[0][1]).fit = counted
    try:
        got = ModelSearch(ours, configs, **kw).run(raw)
    finally:
        type(ours._stages[0][1]).fit = orig
    want = RefSearch(ref, configs, **kw).run(ref_raw)
    _same(got, want)
    assert sorted(fits) == sorted([8, 16] * (folds or 1))   # one featurization per top
    # the winner serves raw text, bitwise its offline predictions
    best = got.best.pipeline
    offline = best.predict([r[1] for r in rows[:10]])
    served = ModelPredictor(best, max_batch=4, device="cpu")
    reqs = [served.submit(PredictRequest(features=r[1])) for r in rows[:10]]
    served.flush()
    assert torch.equal(torch.stack([torch.as_tensor(q.result).reshape(-1)[0] for q in reqs]),
                       offline.reshape(-1))


def test_pipeline_featurizers_fit_on_the_train_fold_only():
    ours, _ = _pipelines()
    raw, _, rows = _raw()
    res = ModelSearch(ours, [{"ngrams.top": 16}], num_epochs=1, seed=0).run(raw)
    tr, _ = holdout_split(len(rows), 0.25, seed=0)
    train_only = ours.with_stage_config({})._fit_stages(pcv.take_rows(raw, tr))[0]
    got = dict(res.trials[0].pipeline.stages)["ngrams"].host_state()
    assert got == dict(train_only)["ngrams"].host_state()


# --------------------------------------------------------------------------- #
# BroadcastALS.train_stacked
# --------------------------------------------------------------------------- #
def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("cfg", [[(0.01, 0), (0.1, 0), (0.01, 1)],
                                 [(0.03, 3), (0.3, 4)]])
def test_train_stacked_matches_the_reference_from_jax_inits(cfg):
    from repro.core.algorithms.als import ALSParameters as RP, BroadcastALS as RA
    from repro.core.algorithms.als import pack_csr_table as rpack
    from repro_torch.core.algorithms.als import ALSParameters, BroadcastALS, pack_csr_table

    rng = np.random.default_rng(0)
    m, n, nnz, rank = 24, 16, 120, 4
    rows, cols = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz).astype(np.float32)
    R, RT = rpack(rows, cols, vals, m, 12, num_shards=4), rpack(cols, rows, vals, n, 16, num_shards=4)
    P = pack_csr_table(rows, cols, vals, m, 12, num_shards=4, device="cpu")
    PT = pack_csr_table(cols, rows, vals, n, 16, num_shards=4, device="cpu")
    rps = [RP(rank=rank, lam=lam, max_iter=3, seed=s) for lam, s in cfg]
    pps = [ALSParameters(rank=rank, lam=lam, max_iter=3, seed=s) for lam, s in cfg]
    inits = []
    for p in rps:
        ku, kv = jax.random.split(jax.random.PRNGKey(p.seed))
        inits.append((np.asarray(jax.random.uniform(ku, (m, rank), jnp.float32)),
                      np.asarray(jax.random.uniform(kv, (n, rank), jnp.float32))))
    want = RA.train_stacked(R, rps, RT)
    got = BroadcastALS.train_stacked(P, pps, PT, init_factors=inits)
    assert len(got) == len(cfg)
    for g, w, p, init in zip(got, want, pps, inits):
        assert _rel(g.U.numpy(), w.U) <= FIT_TOL and _rel(g.V.numpy(), w.V) <= FIT_TOL
        solo = BroadcastALS(p).fit(P, data_transposed=PT, init_factors=init)
        assert _rel(g.U.numpy(), solo.U.numpy()) <= FIT_TOL
        assert g.params is p
    assert not np.allclose(got[0].U.numpy(), got[1].U.numpy())


def test_train_stacked_refuses_ragged_configs():
    from repro_torch.core.algorithms.als import ALSParameters, BroadcastALS, pack_csr_table

    packed = pack_csr_table(np.asarray([0]), np.asarray([0]), np.asarray([1.0], np.float32),
                            4, 2, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        BroadcastALS.train_stacked(packed, [ALSParameters(rank=2), ALSParameters(rank=3)],
                                   packed)
    with pytest.raises(ValueError, match="init_factors"):
        BroadcastALS.train_stacked(packed, [ALSParameters(rank=2)], packed,
                                   init_factors=[])


# --------------------------------------------------------------------------- #
# the launcher
# --------------------------------------------------------------------------- #
_GRID = "learning_rate=0.05,0.1,0.3;l2=0.0,0.01"
_COMMON = (f"--algorithm logreg --grid {_GRID} --rows 64 --features 6 "
           "--epochs 3 --chunks-per-epoch 2 --folds 2 --exec sequential --seed 0 --json")


def _cli(args, check=True):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.tune"] + args.split(),
                         capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    if check:
        assert out.returncode == 0, out.stderr[-2000:]
    return out


def _result(stdout):
    return json.loads([ln for ln in stdout.splitlines() if ln.startswith("RESULT::")][-1][8:])


def test_tune_cli_killed_and_resumed_equals_uninterrupted_and_the_reference(tmp_path, capsys):
    import repro.launch.tune as ref_cli

    straight = _result(_cli(f"{_COMMON} --device cpu").stdout)
    ckpt = tmp_path / "ck"
    killed = _cli(f"{_COMMON} --device cpu --ckpt-dir {ckpt} --kill-after-trial 3",
                  check=False)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert (ckpt / "step_3.npz").exists()
    resumed_proc = _cli(f"{_COMMON} --device cpu --ckpt-dir {ckpt} --resume")
    assert "resuming from unit 3" in resumed_proc.stdout
    assert _result(resumed_proc.stdout) == straight
    # the reference's launcher, in this process (one JAX device: emulated)
    capsys.readouterr()
    ref_cli.main(_COMMON.split())
    want = _result(capsys.readouterr().out)
    assert [t["config"] for t in straight["trials"]] == [t["config"] for t in want["trials"]]
    for a, b in zip(straight["trials"], want["trials"]):
        assert a["score"] == pytest.approx(b["score"], abs=TOL)
        np.testing.assert_allclose(a["state"], b["state"], atol=TOL)
    assert straight["best"] == {**want["best"], "score": straight["best"]["score"]}


@pytest.mark.parametrize("algorithm,extra", [
    ("kmeans", "--grid k=2,4;seed=0,1 --epochs 3"),
    ("logreg", "--samples 4 --space learning_rate=loguniform:0.01:1.0;l2=0.0,0.01 "
               "--asha --epochs 3 --slots 2 --record-eval"),
    ("pipeline", "--grid ngrams.top=8,16;logreg.learning_rate=0.1,0.5 --rows 64 "
                 "--features 16 --epochs 2 --early-stop")])
def test_tune_cli_lanes_run_on_the_cpu(algorithm, extra, capsys):
    from repro_torch.launch import tune

    res = tune.main(f"--algorithm {algorithm} {extra} --device cpu --json".split())
    out = capsys.readouterr().out
    assert "on cpu" in out and "BEST trial=" in out
    assert len(_result(out)["trials"]) == len(res.trials)


def test_entry_points_need_a_device_or_the_card(clf):
    from repro_torch.launch import tune

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.make_table("logreg", 16, 4, 0, None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tune.main(["--algorithm", "logreg", "--grid", "learning_rate=0.1"])
