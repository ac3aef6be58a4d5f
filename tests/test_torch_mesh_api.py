"""The rest of mesh mode: what a user composes on the runner, on gloo hosts.

One host program runs every scenario below on 2 hosts x 4 partitions and
on 4 hosts x 2 (spawned once each through
``repro_torch.launch.elastic.ElasticController``, a ``file://`` rendezvous
under ``tmp_path``), and the same program runs here in emulated mode
(``mesh=None``, 8 partitions).  The reference runs in emulated mode too
(``num_shards=8``; its mesh path calls ``jax.core.trace_state_clean``,
which the installed jax lacks).

Pinned, each against the port's 8-partition emulated run:

  * ``fold_view`` of a mesh table holds the view's rows (it once
    ``index_select``-ed global indices into a host's rows), keeps the mesh
    when the view's rows divide the partitions and is one partition held
    whole otherwise; every layout counts the same rows moved;
  * ``TfIdf``, ``Standardizer`` and ``BiasAdder`` fit and transform on a
    mesh table bitwise (``TfIdf`` once read a host-local IDF), and the
    transforms keep the mesh;
  * the row-wise operations (``map_rows``, ``filter_mask``, ``reduce``,
    ``sum_rows``, ``mean_rows``, ``matrix_batch_map``) and the gathers
    (``to_numpy``, ``to_local_matrix``) bitwise;
  * the twin of ``tests/test_pipeline_api.py``'s acceptance program on the
    mesh: ``Pipeline(mesh=)`` fit bitwise its hand-composed chain and the
    emulated fit, the 4-trial nested search, ``fit_stream`` resumed bitwise,
    save / load, raw text served through the mesh predictor bitwise offline;
  * ``ModelSearch`` on a mesh table: stacked == sequential bitwise, every
    trial bitwise the emulated search under ``gather_broadcast`` and within
    1e-5 of max |w| under ``allreduce`` / ``reduce_scatter``; ASHA, k-means
    and a layout that falls back to one partition, bitwise;
  * the shard-aware ``ModelPredictor`` (``mesh=`` and ``num_shards=8``)
    bitwise the plain service.

Against the reference's emulated runs: the table statistics and the
featurizers' statistics at rtol = atol = 1e-6 (the port sums each partition
in a fixed pairwise order, the reference in one ``jnp.sum``), the
pipeline's weights at 2e-4 (``tests/test_kernels.py``'s fp32 tolerance),
the searches at ``tests/test_torch_tune.py``'s 1e-5, and
``ModelPredictor(num_shards=4)`` on fitted k-means and logistic models
exactly (labels).  ``launch/tune.py --hosts 2`` prints the one-process
run's ``RESULT::`` line character for character.
"""
import json
import os
import sys

import numpy as np
import pytest
import torch

from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.algorithms.logistic_regression import LogisticRegression as JLR
from repro.core.mltable import MLTable as JTable
from repro.core.numeric_table import MLNumericTable as JNumeric
from repro.features import NGrams as JNGrams
from repro.features import Standardizer as JStandardizer
from repro.features import TfIdf as JTfIdf
from repro.pipeline import Pipeline as JPipeline
from repro.serve import ModelPredictor as JPredictor
from repro.tune import ModelSearch as JSearch
from repro.tune import grid as jgrid
from repro_torch.launch import tune as ttune
from repro_torch.launch.elastic import ElasticController
from repro_torch.serve.predictor import ModelPredictor
from repro_torch.weights import from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
LAYOUTS = {"2x4": (2, 4), "4x2": (4, 2)}
FEAT_TOL = dict(rtol=1e-6, atol=1e-6)
FIT_TOL = dict(rtol=2e-4, atol=2e-4)
SEARCH_TOL = 1e-5
MESH_TOL = 1e-5

# every scenario, run by each host of a mesh (mesh=HostMesh) and here in
# emulated mode (mesh=None, 8 partitions); results as {name: nested lists}.
# A scenario that raises records its error, so the others still report.
_SCENARIOS = r'''
import os
import numpy as np
import torch

from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.mltable import MLTable
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import CheckpointPolicy
from repro_torch.data.synthetic import synth_labeled_text
from repro_torch.features import BiasAdder, NGrams, Standardizer, TfIdf
from repro_torch.pipeline import Pipeline
from repro_torch.serve.predictor import ModelPredictor, PredictRequest
from repro_torch.tune import AsyncSuccessiveHalving, KFold, ModelSearch, grid
from repro_torch.tune import cv

P = 8
SCHEDULES = ("gather_broadcast", "allreduce", "reduce_scatter")
LOGREG = dict(learning_rate=0.5, max_iter=6, local_batch_size=4)


def tolist(x):
    if isinstance(x, torch.Tensor):
        return x.tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (list, tuple)):
        return [tolist(v) for v in x]
    return x


def numeric(data, mesh, names=None):
    if mesh is None:
        return MLNumericTable.from_numpy(data, num_shards=P, device="cpu", names=names)
    return MLNumericTable.from_numpy(data, mesh=mesh, names=names)


def clf_data(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    y = (X @ np.linspace(-1, 1, d).astype(np.float32) > 0).astype(np.float32)
    return np.concatenate([y[:, None], X], 1)


def counts_data():
    rng = np.random.default_rng(5)
    X = rng.poisson(0.7, size=(64, 5)).astype(np.float32)
    y = (rng.random(64) > 0.5).astype(np.float32)
    return np.concatenate([y[:, None], X], 1)


def blobs(rows=128, d=4):
    rng = np.random.default_rng(9)
    centers = np.stack([np.full(d, 2.5 * (i - 1)) for i in range(3)]).astype(np.float32)
    return (centers[rng.integers(0, 3, size=rows)]
            + 0.3 * rng.normal(size=(rows, d))).astype(np.float32)


def views(mesh, out):
    t = numeric(clf_data(64, 2), mesh)
    cases = {"first8": np.arange(8), "even": np.arange(0, 64, 2),
             "seven": np.arange(1, 64, 9),
             "train0": KFold(64, 2, seed=0).train_indices(0),
             "val1": KFold(64, 3, seed=0).val_indices(1)}
    cv.fold_view.rows_moved = cv.fold_view.bytes_moved = 0
    for name, idx in cases.items():
        v = cv.fold_view(t, idx)
        out["view/" + name] = v.to_numpy()
        out["layout/" + name] = [v.num_rows, v.num_shards, v.mesh is not None]
    out["moved"] = [cv.fold_view.rows_moved, cv.fold_view.bytes_moved]


def featurizers(mesh, out):
    names = ["label", "a", "b", "c", "d", "e"]
    t = numeric(counts_data(), mesh, names)
    tf = TfIdf().fit(t, default_skip=(0,))
    out["tfidf/idf"] = tf.idf
    scaled = tf.transform(t)
    out["tfidf/rows"] = scaled.to_numpy()
    sc = Standardizer().fit(scaled, default_skip=(0,))
    out["standardizer/shift"], out["standardizer/scale"] = sc.shift, sc.scale
    final = BiasAdder().fit(sc.transform(scaled), default_skip=(0,)).transform(
        sc.transform(scaled))
    out["bias/rows"] = final.to_numpy()
    out["features/keep_mesh"] = [x.mesh is mesh for x in (scaled, sc.transform(scaled), final)]


def row_ops(mesh, out):
    t = numeric(clf_data(64, 3, seed=3), mesh)
    mapped = t.map_rows(lambda r: r * 2.0 + 1.0)
    out["ops/map_rows"] = mapped.to_numpy()
    out["ops/filter_mask"] = t.filter_mask(lambda r: r[1] > 0)
    out["ops/reduce_add"] = t.reduce(torch.add)
    out["ops/reduce_max"] = t.reduce(torch.maximum, torch.full((4,), -1e30))
    out["ops/sum_rows"] = t.sum_rows()
    out["ops/mean_rows"] = t.mean_rows()
    batched = t.matrix_batch_map(lambda m: m.data[:, 1:3] * 3.0 - m.data[:, :1])
    out["ops/matrix_batch_map"] = batched.to_numpy()
    out["ops/to_local_matrix"] = t.to_local_matrix().data
    out["ops/to_numpy"] = t.to_numpy()
    out["ops/keep_mesh"] = [x.mesh is mesh for x in (mapped, batched)]


def make_pipe(mesh, **lr):
    return Pipeline([NGrams(n=1, top=32, column="text"), TfIdf(), Standardizer(),
                     LogisticRegression(**(lr or LOGREG))],
                    mesh=mesh, num_shards=None if mesh is not None else P, device="cpu")


def acceptance(mesh, out, ckpt_root):
    rows = synth_labeled_text(n_docs=128, seed=0)
    raw = MLTable.from_rows(rows, names=["label", "text"], num_partitions=4)
    # 1. fit, against the hand-composed chain
    fitted = make_pipe(mesh).fit(raw)
    table = fitted.transform(raw)
    out["pipe/layout"] = [table.num_shards, table.mesh is mesh, table.num_rows]
    out["pipe/weights"] = fitted.model.weights
    out["pipe/idf"] = fitted["tfidf"].idf
    out["pipe/shift"] = fitted["standardizer"].shift
    out["pipe/scale"] = fitted["standardizer"].scale
    ng = NGrams(n=1, top=32, column="text").fit(raw)
    counts = ng.transform(raw).to_numeric(num_shards=P, device="cpu", mesh=mesh)
    tf = TfIdf().fit(counts, default_skip=(0,))
    sc_in = tf.transform(counts)
    sc = Standardizer().fit(sc_in, default_skip=(0,))
    out["pipe/hand_weights"] = LogisticRegression(**LOGREG).fit(sc.transform(sc_in)).weights
    # 2. the nested search
    res = ModelSearch(make_pipe(mesh, learning_rate=0.5, max_iter=6),
                      grid({"logreg.learning_rate": [0.1, 0.5], "ngrams.top": [16, 32]}),
                      num_epochs=2, chunks_per_epoch=2, folds=3, seed=0,
                      schedule="gather_broadcast").run(raw)
    out["pipe/search"] = [[t.config["ngrams.top"], t.score, t.rung_scores, t.state]
                          for t in res.trials]
    # 3. fit_stream killed after 3 epochs and resumed, against 6 straight
    straight = make_pipe(mesh).fit_stream(raw, num_epochs=6, chunks_per_epoch=2)
    d = os.path.join(ckpt_root, "stream")
    make_pipe(mesh).fit_stream(raw, num_epochs=3, chunks_per_epoch=2,
                               checkpoint=CheckpointPolicy(d, every_epochs=1))
    resumed = make_pipe(mesh).fit_stream(raw, num_epochs=6, chunks_per_epoch=2,
                                         checkpoint=CheckpointPolicy(d, every_epochs=1),
                                         resume=True)
    out["pipe/stream"] = [straight.model.weights, resumed.model.weights]
    # save / load: host 0 writes, every host reads
    path = fitted.save(os.path.join(ckpt_root, "artifact"))
    loaded = make_pipe(mesh).load(os.path.join(ckpt_root, "artifact"))
    out["pipe/loaded"] = [os.path.basename(path), loaded.model.weights]
    # 4. raw text served through the shard-aware predictor
    texts = [t for _, t in rows[:32]]
    svc = (ModelPredictor(fitted, mesh=mesh, max_batch=16) if mesh is not None
           else ModelPredictor(fitted, num_shards=P, max_batch=16, device="cpu"))
    reqs = [svc.submit(PredictRequest(features=t)) for t in texts]
    svc.flush()
    out["pipe/served"] = [float(r.result[0]) for r in reqs]
    out["pipe/offline"] = fitted.predict(texts)
    out["pipe/report"] = [svc.report()["shards"], svc.report()["batches"]]


def searches(mesh, out):
    t = numeric(clf_data(128, 6), mesh)
    configs = grid({"learning_rate": [0.05, 0.3], "l2": [0.0, 0.01]})
    kw = dict(num_epochs=2, chunks_per_epoch=2, folds=2, seed=0)
    runs = [(s, "stacked") for s in SCHEDULES] + [("gather_broadcast", "sequential")]
    for s, e in runs:
        res = ModelSearch("logreg", configs, schedule=s, execution=e, **kw).run(t)
        out[f"search/{s}/{e}"] = [[r.score, r.rung_scores, r.stopped, r.state]
                                  for r in res.trials]
    asha = ModelSearch("logreg", grid({"learning_rate": [0.01, 0.05, 0.1, 0.3, 0.5, 1.0]}),
                       num_epochs=4, seed=0, schedule="gather_broadcast",
                       early_stop=AsyncSuccessiveHalving(reduction_factor=2, slots=3)
                       ).run(t)
    out["search/asha"] = [[r.score, r.rung_scores, r.stopped, r.state] for r in asha.trials]
    km = ModelSearch("kmeans", grid({"k": [2, 3], "seed": [0, 1]}), num_epochs=2,
                     folds=2, seed=0, schedule="gather_broadcast").run(numeric(blobs(), mesh))
    out["search/kmeans"] = [[r.score, r.state] for r in km.trials]
    # train views of 96 rows cannot fill 8 partitions x 16 chunks: every host
    # holds them whole
    fb = ModelSearch("logreg", configs[:2], num_epochs=1, chunks_per_epoch=16, seed=0,
                     schedule="gather_broadcast").run(t)
    out["search/fallback"] = [[r.score, r.state] for r in fb.trials]


def predictors(mesh, out):
    data = blobs()
    km = KMeans(k=3, seed=0, max_iter=4).fit(
        MLNumericTable.from_numpy(data, num_shards=4, device="cpu"))
    clf = clf_data(128, 6)
    lr = LogisticRegression(**LOGREG).fit(MLNumericTable.from_numpy(clf, num_shards=4,
                                                                    device="cpu"))
    for name, model, pool in (("kmeans", km, data), ("logreg", lr, clf[:, 1:])):
        svc = (ModelPredictor(model, mesh=mesh, max_batch=16) if mesh is not None
               else ModelPredictor(model, num_shards=P, max_batch=16, device="cpu"))
        plain = ModelPredictor(model, max_batch=16, device="cpu")
        blocks = [pool[i:i + n] for i, n in ((0, 5), (5, 16), (21, 30), (51, 1))]
        out[f"serve/{name}"] = svc.predict_many(blocks)
        out[f"serve/{name}/plain"] = plain.predict_many(blocks)


def run_all(mesh, ckpt_root):
    out = {}
    for name, fn in (("views", views), ("featurizers", featurizers), ("row_ops", row_ops),
                     ("acceptance", lambda m, o: acceptance(m, o, ckpt_root)),
                     ("searches", searches), ("predictors", predictors)):
        try:
            fn(mesh, out)
        except Exception as e:  # recorded; the cases that read it fail
            out["error/" + name] = repr(e)
    return {k: tolist(v) for k, v in out.items()}
'''

_HOST = _SCENARIOS + r'''
import json
from repro_torch.core import hostmesh

info = hostmesh.initialize_from_env("cpu", timeout=60)
mesh = hostmesh.make_mesh(int(os.environ["LOCAL"]), "cpu")
res = run_all(mesh, os.environ["CKPT_ROOT"])
print("RESULT::" + json.dumps(res))
hostmesh.shutdown()
'''

_NS: dict = {}
exec(compile(_SCENARIOS, "<mesh api scenarios>", "exec"), _NS)


def _result(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT::")]
    assert lines, stdout[-2000:]
    return json.loads(lines[-1][len("RESULT::"):])


def _run_hosts(program: str, hosts: int, tmp_path, env: dict) -> list:
    ctl = ElasticController(
        [sys.executable, "-c", program], hosts,
        env=dict({"PYTHONPATH": SRC}, **env), max_restarts=0,
        timeout=240.0, rendezvous_dir=str(tmp_path / "rendezvous"))
    exits = sorted(ctl.run().final.exits, key=lambda e: e.host_id)
    for e in exits:
        assert e.returncode == 0, e.stderr[-3000:]
    return [_result(e.stdout) for e in exits]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario: each host's results on both layouts, and this
    process's emulated run."""
    out = {}
    for name, (hosts, local) in LAYOUTS.items():
        tmp = tmp_path_factory.mktemp(f"meshapi{name}")
        out[name] = _run_hosts(_HOST, hosts, tmp,
                               {"LOCAL": str(local), "CKPT_ROOT": str(tmp / "ck")})
    tmp = tmp_path_factory.mktemp("meshapi_emulated")
    out["emulated"] = [_NS["run_all"](None, str(tmp / "ck"))]
    return out


def _bits(x) -> bytes:
    return np.asarray(x, dtype=np.float32).tobytes()


def _get(r: dict, key: str):
    errors = {k: v for k, v in r.items() if k.startswith("error/")}
    assert key in r, (key, errors)
    return r[key]


def _same_everywhere(runs, layout, key):
    """``key`` on every host of ``layout`` (all alike) and emulated."""
    hosts = [_get(r, key) for r in runs[layout]]
    for h in hosts[1:]:
        assert h == hosts[0], (layout, key)
    return hosts[0], _get(runs["emulated"][0], key)


# --------------------------------------------------------------------------- #
# fault 1: fold_view of a mesh table
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("view", ["first8", "even", "seven", "train0", "val1"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fold_view_of_a_mesh_table_is_the_emulated_views_rows(runs, layout, view):
    """Bitwise; the layout follows the reference's rule: the mesh kept when
    the view's rows divide the 8 partitions, else one partition."""
    got, want = _same_everywhere(runs, layout, "view/" + view)
    idx = {"first8": np.arange(8), "even": np.arange(0, 64, 2),
           "seven": np.arange(1, 64, 9)}.get(view)
    if idx is not None:
        assert _bits(want) == _bits(_NS["clf_data"](64, 2)[idx])
    assert _bits(got) == _bits(want)
    rows, shards, meshed = _same_everywhere(runs, layout, "layout/" + view)[0]
    assert shards == (8 if rows % 8 == 0 else 1) and meshed == (rows % 8 == 0)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fold_views_count_the_rows_they_move_across_hosts(runs, layout):
    """Every host counts every host's receipts; a row moves where its view
    position's host is not its table row's host, each to every host for a
    one-partition view."""
    hosts, _ = LAYOUTS[layout]
    moved, nbytes = _same_everywhere(runs, layout, "moved")[0]
    kfold = _NS["KFold"]
    want = 0
    for idx in (np.arange(8), np.arange(0, 64, 2), np.arange(1, 64, 9),
                kfold(64, 2, seed=0).train_indices(0), kfold(64, 3, seed=0).val_indices(1)):
        owner = idx // (64 // hosts)
        if len(idx) % 8 == 0:
            want += int(np.sum(owner != np.arange(len(idx)) // (len(idx) // hosts)))
        else:
            want += len(idx) * (hosts - 1)
    assert moved == want and nbytes == want * 3 * 4


# --------------------------------------------------------------------------- #
# fault 2: the featurizers on a mesh table
# --------------------------------------------------------------------------- #
FEATURE_KEYS = ["tfidf/idf", "tfidf/rows", "standardizer/shift", "standardizer/scale",
                "bias/rows"]


@pytest.mark.parametrize("key", FEATURE_KEYS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_featurizers_on_a_mesh_table_are_bitwise_the_emulated_fit(runs, layout, key):
    got, want = _same_everywhere(runs, layout, key)
    assert _bits(got) == _bits(want), key
    assert _same_everywhere(runs, layout, "features/keep_mesh")[0] == [True] * 3


@pytest.fixture(scope="module")
def reference_features():
    data = _NS["counts_data"]()
    t = JNumeric.from_numpy(data, num_shards=8, names=["label", "a", "b", "c", "d", "e"])
    tf = JTfIdf().fit(t, default_skip=(0,))
    scaled = tf.transform(t)
    sc = JStandardizer().fit(scaled, default_skip=(0,))
    return {"tfidf/idf": tf.idf, "tfidf/rows": scaled.to_numpy(),
            "standardizer/shift": sc.shift, "standardizer/scale": sc.scale}


@pytest.mark.parametrize("key", FEATURE_KEYS[:4])
def test_featurizers_on_a_mesh_table_agree_with_the_reference(runs, reference_features, key):
    got = np.asarray(_get(runs["2x4"][0], key), np.float32)
    np.testing.assert_allclose(got, np.asarray(reference_features[key]), **FEAT_TOL)


# --------------------------------------------------------------------------- #
# the row-wise operations and the gathers
# --------------------------------------------------------------------------- #
OPS = ["map_rows", "reduce_add", "reduce_max", "sum_rows", "mean_rows",
       "matrix_batch_map", "to_local_matrix", "to_numpy"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_row_wise_operations_on_a_mesh_are_bitwise_emulated(runs, layout, op):
    got, want = _same_everywhere(runs, layout, "ops/" + op)
    assert _bits(got) == _bits(want), op
    assert _same_everywhere(runs, layout, "ops/keep_mesh")[0] == [True, True]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_filter_mask_on_a_mesh_is_the_hosts_rows_of_the_mask(runs, layout):
    hosts, _ = LAYOUTS[layout]
    want = _get(runs["emulated"][0], "ops/filter_mask")
    per = 64 // hosts
    for h, r in enumerate(runs[layout]):
        assert _get(r, "ops/filter_mask") == want[h * per:(h + 1) * per]


@pytest.mark.parametrize("op", ["sum_rows", "mean_rows", "reduce_add"])
def test_table_statistics_agree_with_the_reference(runs, op):
    data = _NS["clf_data"](64, 3, seed=3)
    t = JNumeric.from_numpy(data, num_shards=8)
    want = {"sum_rows": t.sum_rows, "mean_rows": t.mean_rows,
            "reduce_add": lambda: t.reduce(lambda a, b: a + b)}[op]()
    got = np.asarray(_get(runs["2x4"][0], "ops/" + op), np.float32)
    np.testing.assert_allclose(got, np.asarray(want), **FEAT_TOL)


# --------------------------------------------------------------------------- #
# the acceptance program's twin: Pipeline(mesh=) fit, search, resume, serve
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("key", ["pipe/weights", "pipe/idf", "pipe/shift", "pipe/scale"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipeline_on_a_mesh_is_bitwise_the_emulated_fit(runs, layout, key):
    got, want = _same_everywhere(runs, layout, key)
    assert _bits(got) == _bits(want), key
    assert _same_everywhere(runs, layout, "pipe/layout")[0] == [8, True, 128]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipeline_on_a_mesh_is_bitwise_its_hand_composed_chain(runs, layout):
    got, _ = _same_everywhere(runs, layout, "pipe/weights")
    hand, _ = _same_everywhere(runs, layout, "pipe/hand_weights")
    assert _bits(got) == _bits(hand)


def test_pipeline_on_a_mesh_agrees_with_the_reference_emulated_fit(runs):
    from repro.core.algorithms.logistic_regression import LogisticRegressionAlgorithm as JLRA
    from repro.data import synth_labeled_text as jsynth

    raw = JTable.from_rows(jsynth(n_docs=128, seed=0), names=["label", "text"],
                           num_partitions=4)
    fitted = JPipeline([JNGrams(n=1, top=32, column="text"), JTfIdf(), JStandardizer(),
                        JLRA(**_NS["LOGREG"])], num_shards=8).fit(raw)
    got = runs["2x4"][0]
    np.testing.assert_allclose(np.asarray(_get(got, "pipe/idf"), np.float32),
                               np.asarray(fitted["tfidf"].idf), **FEAT_TOL)
    np.testing.assert_allclose(np.asarray(_get(got, "pipe/weights"), np.float32),
                               np.asarray(fitted.model.weights), **FIT_TOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_nested_pipeline_search_on_a_mesh_is_bitwise_emulated(runs, layout):
    got, want = _same_everywhere(runs, layout, "pipe/search")
    assert len(got) == 4 and all(np.isfinite(t[1]) for t in got)
    assert [t[0] for t in got] == [16, 32, 16, 32]
    for a, b in zip(got, want):
        assert a[1:3] == b[1:3] and _bits(a[3]) == _bits(b[3])


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_pipeline_fit_stream_on_a_mesh_resumes_bitwise(runs, layout):
    (straight, resumed), (e_straight, _) = _same_everywhere(runs, layout, "pipe/stream")
    assert _bits(straight) == _bits(resumed)
    assert _bits(straight) == _bits(e_straight)
    (name, loaded), _ = _same_everywhere(runs, layout, "pipe/loaded")
    weights, _ = _same_everywhere(runs, layout, "pipe/weights")
    assert name.endswith(".npz") and _bits(loaded) == _bits(weights)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_raw_text_served_through_the_mesh_predictor_is_bitwise_offline(runs, layout):
    served, e_served = _same_everywhere(runs, layout, "pipe/served")
    offline, _ = _same_everywhere(runs, layout, "pipe/offline")
    assert _bits(served) == _bits(offline) == _bits(e_served)
    assert _same_everywhere(runs, layout, "pipe/report")[0] == ["mesh", 2]
    assert _get(runs["emulated"][0], "pipe/report") == [8, 2]


# --------------------------------------------------------------------------- #
# ModelSearch on a mesh table
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("run", ["gather_broadcast/stacked", "gather_broadcast/sequential",
                                 "asha", "kmeans", "fallback"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_search_on_a_mesh_is_bitwise_the_emulated_search(runs, layout, run):
    got, want = _same_everywhere(runs, layout, "search/" + run)
    assert got == want, run


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_stacked_search_on_a_mesh_is_bitwise_sequential(runs, layout):
    got, _ = _same_everywhere(runs, layout, "search/gather_broadcast/stacked")
    seq, _ = _same_everywhere(runs, layout, "search/gather_broadcast/sequential")
    assert got == seq


@pytest.mark.parametrize("schedule", ["allreduce", "reduce_scatter"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_search_on_a_mesh_under_the_reduction_schedules(runs, layout, schedule):
    got, want = _same_everywhere(runs, layout, f"search/{schedule}/stacked")
    for a, b in zip(got, want):
        w = np.asarray(b[3], np.float32)
        assert np.abs(np.asarray(a[3], np.float32) - w).max() <= MESH_TOL * np.abs(w).max()
        np.testing.assert_allclose(a[1], b[1], atol=SEARCH_TOL)


def test_search_on_a_mesh_agrees_with_the_reference_emulated_search(runs):
    data = _NS["clf_data"](128, 6)
    want = JSearch("logreg", jgrid({"learning_rate": [0.05, 0.3], "l2": [0.0, 0.01]}),
                   num_epochs=2, chunks_per_epoch=2, folds=2, seed=0,
                   schedule="gather_broadcast").run(JNumeric.from_numpy(data, num_shards=8))
    got = _get(runs["2x4"][0], "search/gather_broadcast/stacked")
    for a, b in zip(got, want.trials):
        np.testing.assert_allclose(a[1], b.rung_scores, atol=SEARCH_TOL)
        np.testing.assert_allclose(np.asarray(a[3], np.float32), np.asarray(b.state),
                                   atol=SEARCH_TOL)


# --------------------------------------------------------------------------- #
# the shard-aware predictor
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("model", ["kmeans", "logreg"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_mesh_predictor_is_bitwise_the_plain_service(runs, layout, model):
    got, want = _same_everywhere(runs, layout, f"serve/{model}")
    plain, _ = _same_everywhere(runs, layout, f"serve/{model}/plain")
    assert got == want == plain


@pytest.mark.parametrize("model", ["kmeans", "logreg"])
def test_shard_aware_predictor_agrees_with_the_reference(model):
    """``ModelPredictor(num_shards=4)`` in both packages on the reference's
    fitted model (carried across with ``from_reference``): the same labels."""
    rng = np.random.default_rng(11)
    if model == "kmeans":
        data = _NS["blobs"]()
        fitted = JKMeans(k=3, seed=0, max_iter=4).fit(JNumeric.from_numpy(data, num_shards=4))
        ours = from_reference("kmeans", {"centroids": np.asarray(fitted.centroids)},
                              device="cpu")
        pool = data
    else:
        data = _NS["clf_data"](128, 6)
        fitted = JLR(**_NS["LOGREG"]).fit(JNumeric.from_numpy(data, num_shards=4))
        ours = from_reference("logistic_regression",
                              {"weights": np.asarray(fitted.weights)}, device="cpu")
        pool = data[:, 1:]
    blocks = [pool[i:i + int(n)] for i, n in zip(range(0, 96, 24), rng.integers(1, 24, 4))]
    got = ModelPredictor(ours, num_shards=4, max_batch=16, device="cpu").predict_many(blocks)
    jsvc = JPredictor(fitted, num_shards=4, max_batch=16)
    want = jsvc.predict_many(blocks)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64))
    with pytest.raises(ValueError, match="must divide over 4 shards"):
        ModelPredictor(ours, num_shards=4, max_batch=10, device="cpu")


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #
def test_launch_tune_two_hosts_is_bitwise_the_one_process_run(monkeypatch, capsys):
    monkeypatch.setenv("PYTHONPATH", SRC)
    monkeypatch.setattr(ttune, "GENERATION_TIMEOUT", 180.0)
    args = ["--algorithm", "logreg", "--device", "cpu", "--grid",
            "learning_rate=0.05,0.3;l2=0.0,0.01", "--rows", "64", "--features", "6",
            "--epochs", "2", "--chunks-per-epoch", "2", "--folds", "2",
            "--schedule", "gather_broadcast", "--json"]
    report = ttune.main(args + ["--hosts", "2", "--devices-per-host", "2"])
    hosts = capsys.readouterr().out
    ttune.main(args)
    single = capsys.readouterr().out
    line = [ln for ln in hosts.splitlines() if ln.startswith("RESULT::")]
    assert len(line) == 1
    assert line == [ln for ln in single.splitlines() if ln.startswith("RESULT::")]
    assert "2 hosts x 2 partitions (gloo)" in hosts
    assert len(report.final.exits) == 2
    for e in report.final.exits:
        assert line[0] in e.stdout.splitlines()
