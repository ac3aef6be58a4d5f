"""The port's streaming epochs, checkpoints and resume against the reference.

Same seeded numpy windows go through ``repro`` (JAX, CPU, emulated mode:
``num_shards`` partitions and no mesh — the reference's mesh path calls
``jax.core.trace_state_clean``, which the installed jax lacks; its kernel
paths run the Pallas kernels in interpret mode) and ``repro_torch``
(``device="cpu"``; its kernel paths run the kernels' plain versions).

Pinned: ``BatchIterator.seek`` replays the windows and ``restrict`` gathers
fold rows, with both leakage guards; the streamed fits (logistic regression
with and without the kernels under the three schedules, k-means, minibatch
SGD resident and streamed) within 1e-5 of the reference's; ``lr_decay``
reads the global round index; a run killed by SIGKILL in a subprocess and
resumed equals the uninterrupted run bitwise (logreg, linreg, k-means, the
Fig. A2 pipeline); every cross-check of ``resume`` raises as the
reference's does, and ``init_state`` is never changed; a snapshot written
by either package resumes in the other; a pipeline snapshot is one file
with the featurizers, the model and the stream position; ``save`` /
``load`` are exact; the ``launch/fit.py`` CLI resumes to the straight
run's result.
"""
import os
import signal
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.algorithms.logistic_regression import LogisticRegression as JLR
from repro.core.mltable import MLTable as JMLTable
from repro.core.optimizer import MinibatchSGD as JMinibatchSGD
from repro.core.optimizer import MinibatchSGDParameters as JMinibatchSGDParameters
from repro.core.numeric_table import MLNumericTable as JTable
from repro.core.runner import CheckpointPolicy as JPolicy
from repro.core.runner import DistributedRunner as JRunner
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro.features import NGrams as JNGrams
from repro.features import Standardizer as JStandardizer
from repro.features import TfIdf as JTfIdf
from repro.pipeline import Pipeline as JPipeline
from repro_torch.checkpoint import latest_step, save_checkpoint
from repro_torch.core.algorithms.kmeans import KMeans as TKMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression as TLR
from repro_torch.core.mltable import MLTable as TMLTable
from repro_torch.core.numeric_table import MLNumericTable as TTable
from repro_torch.core.optimizer import MinibatchSGD as TMinibatchSGD
from repro_torch.core.optimizer import MinibatchSGDParameters as TMinibatchSGDParameters
from repro_torch.core.runner import CheckpointPolicy as TPolicy
from repro_torch.core.runner import DistributedRunner as TRunner
from repro_torch.data import BatchIterator as TBatchIterator
from repro_torch.data import synth_labeled_text
from repro_torch.features import NGrams as TNGrams
from repro_torch.features import Standardizer as TStandardizer
from repro_torch.features import TfIdf as TTfIdf
from repro_torch.launch import fit as tfit
from repro_torch.pipeline import Pipeline as TPipeline
from repro_torch.weights import pipeline_from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
SCHEDULES = ["allreduce", "gather_broadcast", "reduce_scatter"]

# the port's side of every run: executed here and, for the SIGKILL leg, in a
# child process (which imports no JAX), so both run the same code
_COMMON = r'''
import os, signal
import numpy as np
import torch

from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.optimizer import MinibatchSGD, MinibatchSGDParameters
from repro_torch.core.runner import CheckpointPolicy
from repro_torch.data import BatchIterator
from repro_torch.launch.fit import linreg_grad

ROWS, D, SHARDS, CHUNKS, E, HALF = 64, 8, 4, 2, 4, 2


def clf_source(step):
    rng = np.random.default_rng(1000 + step)
    w = np.linspace(-1, 1, D).astype(np.float32)
    X = rng.normal(size=(ROWS, D)).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    return {"data": np.concatenate([y[:, None], X], 1)}


def reg_source(step):
    rng = np.random.default_rng(2000 + step)
    w = np.arange(1, D + 1, dtype=np.float32) / D
    X = rng.normal(size=(ROWS, D)).astype(np.float32)
    return {"data": np.concatenate([(X @ w)[:, None], X], 1)}


def km_source(step):
    rng = np.random.default_rng(3000 + step)
    centers = np.stack([np.full(D, -2.0), np.zeros(D), np.full(D, 2.0),
                        np.linspace(-3, 3, D)]).astype(np.float32)
    idx = rng.integers(0, 4, size=ROWS)
    return {"data": (centers[idx] + 0.3 * rng.normal(size=(ROWS, D))).astype(np.float32)}


SOURCES = {"logreg": clf_source, "linreg": reg_source, "kmeans": km_source}


class KillAt:
    """The reference's ChaosInjector pattern: SIGKILL this process when the
    stream is asked for window ``step`` (the snapshot before it is on disk)."""

    def __init__(self, stream, step):
        self.stream, self.kill = stream, step

    def __getattr__(self, name):
        return getattr(self.stream, name)

    def __iter__(self):
        return self

    def __next__(self):
        if self.stream.step == self.kill:
            os.kill(os.getpid(), signal.SIGKILL)
        return next(self.stream)


def train(algo, num_epochs, ckpt=None, resume=False, kill_step=None):
    stream = BatchIterator(SOURCES[algo], device="cpu")
    run = stream if kill_step is None else KillAt(stream, kill_step)
    kw = dict(num_shards=SHARDS, chunks_per_epoch=CHUNKS, checkpoint=ckpt,
              resume=resume)
    if algo == "logreg":
        m = LogisticRegression(learning_rate=0.3, local_batch_size=4,
                               lr_decay=0.9).fit_stream(run, num_epochs=num_epochs, **kw)
        return m.weights, stream
    if algo == "linreg":
        p = MinibatchSGDParameters(w_init=torch.zeros(D), grad=linreg_grad,
                                   learning_rate=0.05)
        return MinibatchSGD(p).apply_stream(run, num_epochs, **kw), stream
    m = KMeans(k=4).fit_stream(run, num_epochs=num_epochs, **kw)
    return m.centroids, stream
'''
_NS: dict = {}
exec(compile(_COMMON, "<streaming common>", "exec"), _NS)
ROWS, D, SHARDS, CHUNKS, E, HALF = (_NS[k] for k in ("ROWS", "D", "SHARDS", "CHUNKS",
                                                     "E", "HALF"))
SOURCES, train = _NS["SOURCES"], _NS["train"]


def _j_linreg_grad(vec, w):
    x = vec[1:]
    return x * (jnp.dot(x, w) - vec[0])


def _both_streams(source):
    return JBatchIterator(source), TBatchIterator(source, device="cpu")


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


# --------------------------------------------------------------------------- #
# BatchIterator
# --------------------------------------------------------------------------- #
def test_seek_replays_the_same_windows():
    s = TBatchIterator(SOURCES["logreg"], device="cpu")
    first = [next(s)["data"] for _ in range(3)]
    assert s.step == 3
    s.seek(1)
    again = [next(s)["data"] for _ in range(2)]
    for a, b in zip(first[1:], again):
        assert torch.equal(a, b)
    assert first[0].dtype == torch.float32 and first[0].device.type == "cpu"
    np.testing.assert_array_equal(first[0].numpy(), SOURCES["logreg"](0)["data"])


def test_batches_come_as_float32_tensors_on_the_device():
    s = TBatchIterator(lambda step: {"data": np.ones((4, 2)), "t": torch.ones(3, dtype=torch.float64),
                                     "i": np.arange(3)}, device="cpu")
    b = next(s)
    assert b["data"].dtype == torch.float32 and b["t"].dtype == torch.float32
    assert b["i"].dtype == torch.int64


def test_restrict_gathers_the_fold_rows_as_the_reference():
    idx = np.array([3, 0, 7, 7, 12])

    def source(step):
        return {"data": SOURCES["logreg"](step)["data"][:16], "bias": np.float32([1.0])}

    j, t = _both_streams(source)
    j.seek(2)
    t.seek(2)
    jr, tr = j.restrict(idx), t.restrict(idx)
    assert tr.step == 2 and tr.device == t.device
    for _ in range(2):
        jb, tb = next(jr), next(tr)
        np.testing.assert_array_equal(tb["data"].numpy(), np.asarray(jb["data"]))
        np.testing.assert_array_equal(tb["bias"].numpy(), np.asarray(jb["bias"]))
    tr.seek(0)
    np.testing.assert_array_equal(next(tr)["data"].numpy(), source(0)["data"][idx])


@pytest.mark.parametrize("case", ["short data", "nothing covers", "2-d", "empty"])
def test_restrict_guards_raise_as_the_reference(case):
    sources = {
        "short data": (lambda s: {"data": np.zeros((4, 3), np.float32),
                                  "other": np.zeros((20,), np.float32)}, [5]),
        "nothing covers": (lambda s: {"extra": np.zeros((4, 3), np.float32)}, [5]),
        "2-d": (lambda s: {"data": np.zeros((8, 3), np.float32)}, [[1, 2]]),
        "empty": (lambda s: {"data": np.zeros((8, 3), np.float32)}, []),
    }
    source, idx = sources[case]
    j, t = _both_streams(source)
    errors = []
    for stream in (j, t):
        with pytest.raises(ValueError) as err:
            next(stream.restrict(idx))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# --------------------------------------------------------------------------- #
# parity of the streamed fits with the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_logreg_fit_stream_matches_reference(schedule, use_kernel):
    kw = dict(learning_rate=0.3, local_batch_size=4, lr_decay=0.8,
              schedule=schedule, use_kernel=use_kernel)
    j, t = _both_streams(SOURCES["logreg"])
    jm = JLR(**kw).fit_stream(j, num_epochs=3, num_shards=SHARDS,
                              chunks_per_epoch=CHUNKS)
    tm = TLR(**kw).fit_stream(t, num_epochs=3, num_shards=SHARDS,
                              chunks_per_epoch=CHUNKS)
    assert tm.weights.shape == (D,) and tm.weights.dtype == torch.float32
    _close(tm.weights, jm.weights)
    assert t.step == j.step == 3


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("init", ["peeked", "given"])
def test_kmeans_fit_stream_matches_reference(use_kernel, init):
    j, t = _both_streams(SOURCES["kmeans"])
    given = SOURCES["kmeans"](9)["data"][:4] if init == "given" else None
    jm = JKMeans(k=4, use_kernel=use_kernel).fit_stream(
        j, num_epochs=3, num_shards=SHARDS, chunks_per_epoch=CHUNKS,
        init_centroids=None if given is None else jnp.asarray(given))
    tm = TKMeans(k=4, use_kernel=use_kernel).fit_stream(
        t, num_epochs=3, num_shards=SHARDS, chunks_per_epoch=CHUNKS,
        init_centroids=given)
    _close(tm.centroids, jm.centroids)


def test_minibatch_sgd_resident_matches_reference():
    data = SOURCES["linreg"](0)["data"]
    jp = JMinibatchSGDParameters(w_init=jnp.zeros(D), grad=_j_linreg_grad,
                                 learning_rate=0.05, max_iter=7, batch_per_shard=4)
    tp = TMinibatchSGDParameters(w_init=torch.zeros(D), grad=_NS["linreg_grad"],
                                 learning_rate=0.05, max_iter=7, batch_per_shard=4)
    jw = JMinibatchSGD(jp).apply(JTable.from_numpy(data, num_shards=SHARDS))
    tw = TMinibatchSGD(tp).apply(TTable.from_numpy(data, num_shards=SHARDS, device="cpu"))
    _close(tw, jw)
    with pytest.raises(ValueError, match="exceeds rows-per-shard"):
        TMinibatchSGD(tp).apply(TTable.from_numpy(data[:8], num_shards=SHARDS,
                                                  device="cpu"))


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_minibatch_sgd_stream_matches_reference(schedule):
    jp = JMinibatchSGDParameters(w_init=jnp.zeros(D), grad=_j_linreg_grad,
                                 learning_rate=0.05, schedule=schedule)
    tp = TMinibatchSGDParameters(w_init=torch.zeros(D), grad=_NS["linreg_grad"],
                                 learning_rate=0.05, schedule=schedule)
    j, t = _both_streams(SOURCES["linreg"])
    jw = JMinibatchSGD(jp).apply_stream(j, 3, num_shards=SHARDS, chunks_per_epoch=CHUNKS)
    tw = TMinibatchSGD(tp).apply_stream(t, 3, num_shards=SHARDS, chunks_per_epoch=CHUNKS)
    _close(tw, jw)


def test_lr_decay_reads_the_global_round_index():
    """Round r of epoch e is global round e·chunks + r, also after a
    resume (start_epoch): the local step sees 0, 1, ..., and a decaying
    fit equals the reference's, whose rounds count the same way."""
    seen = []

    def local_step(blocks, state, r):
        seen.append(r)
        return state.expand(blocks.shape[0], -1)

    runner = TRunner(num_shards=SHARDS)
    stream = TBatchIterator(SOURCES["logreg"], device="cpu")
    runner.run_epochs(stream, torch.zeros(2), local_step, 2, chunks_per_epoch=4)
    runner.run_epochs(stream, torch.zeros(2), local_step, 4, chunks_per_epoch=4,
                      start_epoch=2)
    assert seen == list(range(16))
    kw = dict(learning_rate=0.5, local_batch_size=8, lr_decay=0.5)
    j, t = _both_streams(SOURCES["logreg"])
    jm = JLR(**kw).fit_stream(j, num_epochs=4, num_shards=SHARDS, chunks_per_epoch=CHUNKS)
    tm = TLR(**kw).fit_stream(t, num_epochs=4, num_shards=SHARDS, chunks_per_epoch=CHUNKS)
    _close(tm.weights, jm.weights)
    # with no decay the last rounds would move the weights further
    t.seek(0)
    flat = TLR(**{**kw, "lr_decay": 1.0}).fit_stream(
        t, num_epochs=4, num_shards=SHARDS, chunks_per_epoch=CHUNKS)
    assert not torch.equal(flat.weights, tm.weights)


def test_train_stream_shim_is_fit_stream():
    t1 = TBatchIterator(SOURCES["kmeans"], device="cpu")
    t2 = TBatchIterator(SOURCES["kmeans"], device="cpu")
    a = TKMeans.train_stream(t1, TKMeans.Parameters(k=4), num_epochs=2,
                             num_shards=SHARDS, chunks_per_epoch=CHUNKS)
    b = TKMeans(k=4).fit_stream(t2, num_epochs=2, num_shards=SHARDS,
                                chunks_per_epoch=CHUNKS)
    assert torch.equal(a.centroids, b.centroids)


def test_streaming_refuses_the_gd_solver_and_a_bad_window():
    t = TBatchIterator(SOURCES["logreg"], device="cpu")
    with pytest.raises(ValueError, match="solver='sgd' only"):
        TLR(solver="gd").fit_stream(t, num_epochs=1)
    with pytest.raises(ValueError, match="must divide into"):
        TLR().fit_stream(t, num_epochs=1, num_shards=SHARDS, chunks_per_epoch=3)
    with pytest.raises(ValueError, match="must divide evenly"):
        TLR().fit_stream(t, num_epochs=1, num_shards=5)


# --------------------------------------------------------------------------- #
# exact resume
# --------------------------------------------------------------------------- #
_KILLED = _COMMON + r'''
base = os.environ["CKPT_BASE"]
for algo in ("logreg", "linreg"):
    # preempted later (process-wide): each run leaves snapshots 1..HALF
    train(algo, HALF, ckpt=CheckpointPolicy(os.path.join(base, algo)))
# the preemption itself: SIGKILL when the stream is asked for window HALF
train("kmeans", E, ckpt=CheckpointPolicy(os.path.join(base, "kmeans")), kill_step=HALF)
raise SystemExit("unreachable: the SIGKILL above must fire")
'''


def test_sigkilled_run_resumes_bitwise_to_the_uninterrupted_run(tmp_path):
    env = dict(os.environ, CKPT_BASE=str(tmp_path),
               PYTHONPATH=os.path.join(REPO, "src"))
    killed = subprocess.run([sys.executable, "-c", _KILLED], env=env,
                            capture_output=True, text=True, timeout=300)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    for algo in ("logreg", "linreg", "kmeans"):
        d = str(tmp_path / algo)
        assert latest_step(d) == HALF, algo
        # debris a real preemption could leave: resume must see through it
        open(os.path.join(d, "step_99.npz.tmp"), "wb").close()
        open(os.path.join(d, "notes.txt"), "w").close()
        straight, _ = train(algo, E)
        resumed, stream = train(algo, E, ckpt=TPolicy(d), resume=True)
        assert torch.equal(resumed, straight), algo
        assert stream.step == E and latest_step(d) == E, algo


def test_run_epochs_never_changes_init_state(tmp_path):
    init = torch.from_numpy(SOURCES["kmeans"](5)["data"][:4].copy())
    keep = init.clone()
    stream = TBatchIterator(SOURCES["kmeans"], device="cpu")
    m = TKMeans(k=4).fit_stream(stream, num_epochs=3, num_shards=SHARDS,
                                chunks_per_epoch=CHUNKS, init_centroids=init,
                                checkpoint=TPolicy(str(tmp_path)))
    assert torch.equal(init, keep) and not torch.equal(m.centroids, init)
    TKMeans(k=4).fit_stream(stream.seek(0), num_epochs=5, num_shards=SHARDS,
                            init_centroids=init, checkpoint=TPolicy(str(tmp_path)),
                            resume=True)
    assert torch.equal(init, keep)


def test_snapshot_metadata_is_the_reference_s(tmp_path):
    """The same run writes the same metadata in either package, so a
    snapshot of either resumes in the other."""
    for pkg, (runner, stream) in {
            "j": (JRunner(num_shards=SHARDS), JBatchIterator(SOURCES["kmeans"])),
            "t": (TRunner(num_shards=SHARDS), TBatchIterator(SOURCES["kmeans"], device="cpu")),
    }.items():
        init = SOURCES["kmeans"](0)["data"][:4]
        init = jnp.asarray(init) if pkg == "j" else torch.from_numpy(init.copy())
        policy = (JPolicy if pkg == "j" else TPolicy)(str(tmp_path / pkg), every_epochs=2,
                                                      keep=2)
        runner.run_epochs(stream, init, lambda b, s, r: b[..., :4, :] if pkg == "t" else b[:4],
                          3, combine="mean", chunks_per_epoch=CHUNKS, checkpoint=policy,
                          rng=[5, 9] if pkg == "t" else jnp.asarray([5, 9], jnp.uint32))
    from repro.checkpoint import load_metadata as j_load_metadata
    from repro_torch.checkpoint import load_metadata as t_load_metadata
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == \
        ["step_2.npz", "step_3.npz"]
    for step in (2, 3):
        assert t_load_metadata(str(tmp_path / "t"), step) == \
            j_load_metadata(str(tmp_path / "j"), step)


def _resume_case(case, tmp_path):
    """One failing resume in each package: ``[(call, snapshot dir), ...]``
    for the reference, then the port."""
    calls = []
    for pkg in ("j", "t"):
        runner_cls = JRunner if pkg == "j" else TRunner
        policy_cls = JPolicy if pkg == "j" else TPolicy
        stream_of = ((lambda: JBatchIterator(SOURCES["kmeans"])) if pkg == "j" else
                     (lambda: TBatchIterator(SOURCES["kmeans"], device="cpu")))
        init = SOURCES["kmeans"](0)["data"][:4]
        init = jnp.asarray(init) if pkg == "j" else torch.from_numpy(init.copy())
        upd = (lambda c, tot, r: tot[:, :D] / jnp.maximum(tot[:, D:], 1.0)) if pkg == "j" \
            else (lambda c, tot, r: tot[:, :D] / tot[:, D:].clamp(min=1.0))

        def step(b, c, r, pkg=pkg):
            if pkg == "j":
                from repro.core.algorithms.kmeans import _local_stats
                return _local_stats(b, c)
            from repro_torch.core.algorithms.kmeans import _local_stats
            return _local_stats(b, c)

        pd = str(tmp_path / pkg)
        if case == "no metadata":
            (j_save_checkpoint if pkg == "j" else save_checkpoint)(pd, 1, init)
        else:
            extra = {"x": jnp.zeros(2) if pkg == "j" else torch.zeros(2)}
            runner_cls(num_shards=SHARDS).run_epochs(
                stream_of(), init, step, 2, combine="sum", update=upd,
                chunks_per_epoch=CHUNKS,
                checkpoint=policy_cls(pd, extra_state=extra if case == "wrapped" else None))
        runner = runner_cls(num_shards=2 if case == "num_shards" else SHARDS,
                            schedule="reduce_scatter" if case == "schedule" else "allreduce")
        stream = iter([]) if case == "not seekable" else stream_of()
        chunks = 1 if case == "chunks" else None
        calls.append((lambda runner=runner, stream=stream, init=init, step=step, upd=upd,
                      pd=pd, chunks=chunks: runner.resume(
                          pd, stream, init, step, 4, combine="sum", update=upd,
                          chunks_per_epoch=chunks), pd))
    return calls


@pytest.mark.parametrize("case", ["schedule", "num_shards", "chunks", "no metadata",
                                  "not seekable", "wrapped"])
def test_resume_cross_checks_raise_as_the_reference(case, tmp_path):
    errors = []
    for call, pd in _resume_case(case, tmp_path):
        with pytest.raises((ValueError, TypeError)) as err:
            call()
        errors.append((err.type, str(err.value).replace(pd, "DIR")))
    (j_type, j_msg), (t_type, t_msg) = errors
    assert t_type is j_type
    assert t_msg == j_msg


@pytest.mark.parametrize("algo", ["kmeans", "logreg"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_snapshot_resumes_in_the_other_package(algo, writer, tmp_path):
    """A snapshot at epoch 3 of 6 written by one package, resumed by the
    other, ends within 1e-5 of the reference's uninterrupted run."""
    kw = dict(num_shards=SHARDS, chunks_per_epoch=CHUNKS)

    def fit(pkg, epochs, ckpt=None, resume=False):
        stream = (JBatchIterator(SOURCES[algo]) if pkg == "j"
                  else TBatchIterator(SOURCES[algo], device="cpu"))
        policy = None if ckpt is None else (JPolicy if pkg == "j" else TPolicy)(ckpt)
        if algo == "kmeans":
            m = (JKMeans if pkg == "j" else TKMeans)(k=4).fit_stream(
                stream, num_epochs=epochs, checkpoint=policy, resume=resume, **kw)
            return m.centroids
        m = (JLR if pkg == "j" else TLR)(learning_rate=0.3, local_batch_size=4).fit_stream(
            stream, num_epochs=epochs, checkpoint=policy, resume=resume, **kw)
        return m.weights

    straight = np.asarray(fit("j", 6))
    first, second = ("j", "t") if writer == "reference" else ("t", "j")
    fit(first, 3, ckpt=str(tmp_path))
    assert (j_latest_step if first == "j" else latest_step)(str(tmp_path)) == 3
    got = fit(second, 6, ckpt=str(tmp_path), resume=True)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, straight, **TOL)


# --------------------------------------------------------------------------- #
# the pipeline
# --------------------------------------------------------------------------- #
def _docs(n=96, seed=0):
    return synth_labeled_text(n_docs=n, seed=seed)


def _t_pipe(kind):
    if kind == "kmeans":
        return TPipeline([TNGrams(n=2, top=24, column="text", keep_columns=False),
                          TTfIdf(), TKMeans(k=3)], num_shards=SHARDS, device="cpu")
    return TPipeline([TNGrams(n=1, top=16, column="text"), TTfIdf(), TStandardizer(),
                      TLR(learning_rate=0.3, local_batch_size=4)],
                     num_shards=SHARDS, device="cpu")


def _j_pipe(kind):
    if kind == "kmeans":
        return JPipeline([JNGrams(n=2, top=24, column="text", keep_columns=False),
                          JTfIdf(), JKMeans(k=3)], num_shards=SHARDS)
    return JPipeline([JNGrams(n=1, top=16, column="text"), JTfIdf(), JStandardizer(),
                      JLR(learning_rate=0.3, local_batch_size=4)], num_shards=SHARDS)


def _state(fitted):
    return fitted.model.centroids if hasattr(fitted.model, "centroids") else fitted.model.weights


_PIPE_KILLED = r'''
import os, signal
from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.mltable import MLTable
from repro_torch.core.runner import DistributedRunner
from repro_torch.data import synth_labeled_text
from repro_torch.features import NGrams, TfIdf
from repro_torch.pipeline import Pipeline

run_epochs = DistributedRunner.run_epochs


def killing_run_epochs(self, stream, *a, **kw):
    """SIGKILL when the pipeline's stream is asked for window 2."""
    class KillAt:
        def __getattr__(_, name):
            return getattr(stream, name)

        def __iter__(it):
            return it

        def __next__(_):
            if stream.step == 2:
                os.kill(os.getpid(), signal.SIGKILL)
            return next(stream)
    return run_epochs(self, KillAt(), *a, **kw)


DistributedRunner.run_epochs = killing_run_epochs
raw = MLTable.from_rows(synth_labeled_text(n_docs=96, seed=0), names=["label", "text"],
                        num_partitions=4)
pipe = Pipeline([NGrams(n=2, top=24, column="text", keep_columns=False), TfIdf(),
                 KMeans(k=3)], num_shards=4, device="cpu")
pipe.fit_stream(raw, num_epochs=4, chunks_per_epoch=2, checkpoint=os.environ["CKPT"])
raise SystemExit("unreachable: the SIGKILL above must fire")
'''


def test_pipeline_sigkilled_midway_resumes_bitwise(tmp_path):
    raw = TMLTable.from_rows(_docs(), names=["label", "text"], num_partitions=4)
    straight = _t_pipe("kmeans").fit_stream(raw, num_epochs=4, chunks_per_epoch=2)
    env = dict(os.environ, CKPT=str(tmp_path), PYTHONPATH=os.path.join(REPO, "src"))
    killed = subprocess.run([sys.executable, "-c", _PIPE_KILLED], env=env,
                            capture_output=True, text=True, timeout=300)
    assert killed.returncode == -signal.SIGKILL, killed.stderr[-2000:]
    assert latest_step(str(tmp_path)) == 2
    resumed = _t_pipe("kmeans").fit_stream(raw, num_epochs=4, chunks_per_epoch=2,
                                           checkpoint=str(tmp_path), resume=True)
    assert torch.equal(_state(resumed), _state(straight))
    assert resumed["ngrams"].vocab == straight["ngrams"].vocab
    assert torch.equal(resumed["tfidf"].idf, straight["tfidf"].idf)
    assert latest_step(str(tmp_path)) == 4


@pytest.mark.parametrize("kind", ["kmeans", "logreg"])
def test_pipeline_resume_restores_the_featurizers_and_is_bitwise(kind, tmp_path):
    raw = TMLTable.from_rows(_docs(), names=["label", "text"], num_partitions=4)
    straight = _t_pipe(kind).fit_stream(raw, num_epochs=4, chunks_per_epoch=2)
    _t_pipe(kind).fit_stream(raw, num_epochs=2, chunks_per_epoch=2,
                             checkpoint=str(tmp_path))
    # each snapshot is ONE file holding the stages, the model and the position
    with np.load(tmp_path / "step_2.npz") as f:
        keys = set(f.files)
    assert "state" in keys and "__checkpoint_meta__" in keys
    assert "extra/stages/tfidf/idf" in keys
    assert sorted(os.listdir(tmp_path)) == ["step_1.npz", "step_2.npz"]
    resumed = _t_pipe(kind).fit_stream(raw, num_epochs=4, chunks_per_epoch=2,
                                       checkpoint=str(tmp_path), resume=True)
    assert torch.equal(_state(resumed), _state(straight))
    assert resumed["ngrams"].vocab == straight["ngrams"].vocab
    # a resume restores the featurizers and never refits them: on other rows
    # a refit would give another vocabulary, the resume gives the snapshot's
    other = TMLTable.from_rows(_docs(seed=5), names=["label", "text"], num_partitions=4)
    assert _t_pipe(kind).fit(other)["ngrams"].vocab != straight["ngrams"].vocab
    again = _t_pipe(kind).fit_stream(other, num_epochs=4, chunks_per_epoch=2,
                                     checkpoint=str(tmp_path), resume=True)
    assert again["ngrams"].vocab == straight["ngrams"].vocab
    assert torch.equal(_state(again), _state(straight))


def test_pipeline_fit_stream_matches_reference():
    rows = _docs()
    for kind in ("kmeans", "logreg"):
        jf = _j_pipe(kind).fit_stream(
            JMLTable.from_rows(rows, names=["label", "text"], num_partitions=4),
            num_epochs=3, chunks_per_epoch=2)
        tf = _t_pipe(kind).fit_stream(
            TMLTable.from_rows(rows, names=["label", "text"], num_partitions=4),
            num_epochs=3, chunks_per_epoch=2)
        assert tf["ngrams"].vocab == jf["ngrams"].vocab
        _close(_state(tf), _state(jf))


def test_pipeline_resume_without_pipeline_state_refuses(tmp_path):
    raw = TMLTable.from_rows(_docs(), names=["label", "text"], num_partitions=4)
    TKMeans(k=3).fit_stream(TBatchIterator(SOURCES["kmeans"], device="cpu"), num_epochs=1,
                            num_shards=SHARDS, checkpoint=TPolicy(str(tmp_path)))
    with pytest.raises(ValueError, match="carries no pipeline state"):
        _t_pipe("kmeans").fit_stream(raw, num_epochs=2, checkpoint=str(tmp_path),
                                     resume=True)
    with pytest.raises(ValueError, match="requires a checkpoint"):
        _t_pipe("kmeans").fit_stream(raw, num_epochs=2, resume=True)


@pytest.mark.parametrize("kind", ["kmeans", "logreg"])
def test_fitted_pipeline_save_load_round_trip_is_exact(kind, tmp_path):
    raw = TMLTable.from_rows(_docs(), names=["label", "text"], num_partitions=4)
    fitted = _t_pipe(kind).fit(raw)
    fitted.save(str(tmp_path))
    assert os.listdir(tmp_path) == ["step_0.npz"]
    loaded = _t_pipe(kind).load(str(tmp_path))
    assert [n for n, _ in loaded.stages] == [n for n, _ in fitted.stages]
    assert loaded["ngrams"].vocab == fitted["ngrams"].vocab
    assert torch.equal(loaded["tfidf"].idf, fitted["tfidf"].idf)
    assert torch.equal(_state(loaded), _state(fitted))
    assert loaded.num_cols == fitted.num_cols
    texts = [t for _, t in _docs()[:20]]
    assert torch.equal(loaded.predict(texts), fitted.predict(texts))
    with pytest.raises(FileNotFoundError):
        _t_pipe(kind).load(str(tmp_path / "empty"))
    save_checkpoint(str(tmp_path / "plain"), 0, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="no pipeline artifact"):
        _t_pipe(kind).load(str(tmp_path / "plain"))


@pytest.mark.parametrize("kind", ["kmeans", "logreg"])
def test_a_reference_artifact_loads_in_the_port(kind, tmp_path):
    rows = _docs()
    jf = _j_pipe(kind).fit(JMLTable.from_rows(rows, names=["label", "text"],
                                              num_partitions=4))
    jf.save(str(tmp_path))
    loaded = _t_pipe(kind).load(str(tmp_path))
    host = {"stages": {n: {k: np.asarray(v) for k, v in p.items()}
                       for n, p in jf.partial["stages"].items()},
            "model": {k: np.asarray(v) for k, v in jf.partial["model"].items()}}
    carried = pipeline_from_reference(_t_pipe(kind), jf.host_state(), host, device="cpu")
    texts = [t for _, t in rows[:24]]
    assert torch.equal(loaded.predict(texts), carried.predict(texts))
    assert torch.equal(_state(loaded), _state(carried))
    np.testing.assert_array_equal(loaded.predict(texts).numpy(),
                                  np.asarray(jf.predict(texts)))


# --------------------------------------------------------------------------- #
# launch/fit.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("algorithm", ["kmeans", "logreg", "linreg", "pipeline"])
def test_fit_cli_resume_equals_the_straight_run(algorithm, tmp_path, capsys):
    common = (f"--algorithm {algorithm} --rows-per-epoch 32 --features 4 "
              f"--chunks-per-epoch 2 --num-shards 2 --device cpu").split()
    ck = ["--ckpt-dir", str(tmp_path / "ck")]
    straight = tfit.main(common + ["--epochs", "4"])
    tfit.main(common + ck + ["--epochs", "2"])
    assert "starting fresh" not in capsys.readouterr().out
    resumed = tfit.main(common + ck + ["--epochs", "4", "--resume"])
    out = capsys.readouterr().out
    assert "resuming from step 2" in out
    if algorithm != "pipeline":
        assert "stream position: step 4" in out
    for a, b in ((straight, resumed),) if algorithm == "linreg" else \
            ((_state_of(straight), _state_of(resumed)),):
        assert torch.equal(a, b)
    assert latest_step(str(tmp_path / "ck")) == 4
    tfit.main(common + ["--ckpt-dir", str(tmp_path / "none"), "--epochs", "1", "--resume"])
    assert "no checkpoint found; starting fresh" in capsys.readouterr().out


def _state_of(out):
    if hasattr(out, "model"):
        return _state(out)
    return out.centroids if hasattr(out, "centroids") else out.weights


def test_fit_cli_streams_the_reference_launcher_s_windows():
    """The port's launcher draws the reference launcher's windows, and its
    k-means lane ends within 1e-5 of the reference's fit on them."""
    from repro.launch import fit as jfit

    for algo in ("logreg", "linreg", "kmeans"):
        j, t = jfit.make_source(algo, 32, 4, 3), tfit.make_source(algo, 32, 4, 3)
        for step in (0, 5):
            np.testing.assert_array_equal(t(step)["data"], j(step)["data"])
    args = "--algorithm kmeans --rows-per-epoch 32 --features 4 --epochs 3".split()
    m = tfit.main(args + ["--device", "cpu"])
    jm = JKMeans(k=4).fit_stream(JBatchIterator(jfit.make_source("kmeans", 32, 4, 0)),
                                 num_epochs=3, num_shards=4, chunks_per_epoch=4)
    _close(m.centroids, jm.centroids)
