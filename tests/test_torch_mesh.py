"""The port's mesh mode: host processes joined by a gloo process group.

The same seeded numpy data go through ``repro_torch`` on a host mesh (2
hosts x 4 partitions and 4 hosts x 2, spawned through
``repro_torch.launch.elastic.ElasticController`` with a ``file://``
rendezvous under ``tmp_path``), through ``repro_torch`` in emulated mode
(``num_shards=8``, this process) and through the reference in emulated mode
(``num_shards=8``; its mesh path calls ``jax.core.trace_state_clean``,
which the installed jax lacks, and its Pallas kernels run in interpret
mode).

Pinned: logistic regression (resident fit, streamed fit, with and without
the kernels' plain versions) under ``gather_broadcast`` is bitwise the
port's 8-partition emulated run, and ``allreduce`` / ``reduce_scatter``
within 1e-5 of max |w|; every schedule within the streaming tests' 1e-5 of
the reference's emulated run; k-means on {0,1} lattice rows bitwise across
layouts and schedules (integer sums); ``combine_concat`` is the table's
rows under every schedule; a mesh table's ``fit`` draws its k-means init
rows across hosts; ``run_epochs`` + ``resume`` on the same mesh is bitwise
the straight run; a mesh snapshot of 8 partitions resumes on 4 with
``allow_resize`` bitwise an emulated 8-partition snapshot's resume and
within 1e-5 of the reference's emulated resize, and without it raises as
the reference does; a mesh table's ``sum_rows`` is bitwise the emulated
sum; stacked trials on a mesh are bitwise their sequential runs and the
emulated stack; the backend rule; a host that cannot join raises within its
timeout; ``launch/fit.py --hosts 2`` is bitwise the one-process run.
"""
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.algorithms.logistic_regression import LogisticRegression as JLR
from repro.data.pipeline import BatchIterator as JBatchIterator
from repro_torch.core import hostmesh
from repro_torch.core import partition as tpt
from repro_torch.core.hostmesh import HostMesh
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import DistributedRunner
from repro_torch.launch import fit as tfit
from repro_torch.launch.elastic import ElasticController

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
TOL = dict(rtol=1e-5, atol=1e-5)
SCHEDULES = ["gather_broadcast", "allreduce", "reduce_scatter"]
LAYOUTS = {"2x4": (2, 4), "4x2": (4, 2)}

# every scenario, run by each host of a mesh (mesh=HostMesh) and here in
# emulated mode (mesh=None, 8 partitions); results as {name: list}
_SCENARIOS = r'''
import os
import numpy as np
import torch

from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.fixed_sum import fixed_sum
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import CheckpointPolicy, DistributedRunner
from repro_torch.data import BatchIterator

ROWS, D, E, CHUNKS, P = 64, 8, 3, 2, 8
SCHEDULES = ("gather_broadcast", "allreduce", "reduce_scatter")


def clf_source(step):
    rng = np.random.default_rng(1000 + step)
    w = np.linspace(-1, 1, D).astype(np.float32)
    X = rng.normal(size=(ROWS, D)).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    return {"data": np.concatenate([y[:, None], X], 1)}


def km_source(step):
    # {0,1} lattice: cluster sums and counts are small integers, exact in
    # fp32 in any order
    rng = np.random.default_rng(3000 + step)
    return {"data": rng.integers(0, 2, size=(ROWS, D)).astype(np.float32)}


def stream(source, mesh):
    return BatchIterator(source, device="cpu", mesh=mesh)


def table(mesh):
    data = clf_source(99)["data"]
    if mesh is None:
        return MLNumericTable.from_numpy(data, num_shards=P, device="cpu")
    return MLNumericTable.from_numpy(data, mesh=mesh)


def run_all(mesh, ckpt_root):
    out = {}
    for s in SCHEDULES:
        lr = dict(learning_rate=0.3, local_batch_size=2, max_iter=3, schedule=s)
        out["fit/" + s] = LogisticRegression(**lr).fit(table(mesh)).weights
        out["fit_kernel/" + s] = LogisticRegression(use_kernel=True, **lr).fit(
            table(mesh)).weights
        out["stream/" + s] = LogisticRegression(**lr).fit_stream(
            stream(clf_source, mesh), num_epochs=E, chunks_per_epoch=CHUNKS,
            num_shards=P).weights
        out["kmeans/" + s] = KMeans(k=4, seed=0, schedule=s).fit_stream(
            stream(km_source, mesh), num_epochs=E, chunks_per_epoch=CHUNKS,
            num_shards=P).centroids
        km_table = (MLNumericTable.from_numpy(km_source(7)["data"], mesh=mesh)
                    if mesh is not None else MLNumericTable.from_numpy(
                        km_source(7)["data"], num_shards=P, device="cpu"))
        out["kmeans_fit/" + s] = KMeans(k=4, seed=3, max_iter=3, schedule=s).fit(
            km_table).centroids
        runner = DistributedRunner.for_table(table(mesh), schedule=s)
        out["concat/" + s] = runner.partition_apply(
            table(mesh).data, lambda b: 2 * b + 1, combine="concat")
    # run_epochs + resume on the same layout, gather_broadcast
    runner = DistributedRunner(num_shards=P, schedule="gather_broadcast", mesh=mesh)
    step = lambda b, w, r: b[..., 1:].mean(1) * 0.1 + w  # noqa: E731
    ck = CheckpointPolicy(os.path.join(ckpt_root, "epochs"))
    w0 = torch.zeros(D)
    out["epochs"] = runner.run_epochs(stream(clf_source, mesh), w0, step, 4,
                                      chunks_per_epoch=CHUNKS, checkpoint=ck)
    out["resumed"] = runner.resume(ck.ckpt_dir, stream(clf_source, mesh), w0,
                                   step, 4, step=2)
    lr = dict(learning_rate=0.3, local_batch_size=2, schedule="gather_broadcast")
    LogisticRegression(**lr).fit_stream(
        stream(clf_source, mesh), num_epochs=2, chunks_per_epoch=CHUNKS,
        num_shards=P, checkpoint=CheckpointPolicy(os.path.join(ckpt_root, "resize")))
    out["sum_rows"] = table(mesh).sum_rows()
    # two stacked trials (a step size each) and each lane run alone
    trial = lambda b, w, r, h: w - h["lr"] * fixed_sum(b[..., 1:], dim=1)  # noqa: E731
    lrs = torch.tensor([0.01, 0.03])
    out["stacked"] = runner.run_stacked_rounds(table(mesh), torch.zeros(2, D),
                                               {"lr": lrs}, trial, 3)
    out["stacked_seq"] = torch.cat([runner.run_stacked_rounds(
        table(mesh), torch.zeros(1, D), {"lr": lrs[j:j + 1]}, trial, 3)
        for j in range(2)])
    return {k: v.numpy().tolist() for k, v in out.items()}
'''

_HOST = _SCENARIOS + r'''
import json
from repro_torch.core import hostmesh

info = hostmesh.initialize_from_env("cpu", timeout=60)
mesh = hostmesh.make_mesh(int(os.environ["LOCAL"]), "cpu")
res = run_all(mesh, os.environ["CKPT_ROOT"])
res["__rows"] = int(table(mesh).data.shape[0])
res["__backend"] = mesh.backend
print("RESULT::" + json.dumps(res))
hostmesh.shutdown()
'''

_NS: dict = {}
exec(compile(_SCENARIOS, "<mesh scenarios>", "exec"), _NS)


def _result(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT::")]
    assert lines, stdout[-2000:]
    return json.loads(lines[-1][len("RESULT::"):])


def run_hosts(program: str, hosts: int, tmp_path, env: dict = None) -> list:
    """Run ``program`` on ``hosts`` gloo host processes (one generation, a
    file:// rendezvous under tmp_path); returns each host's HostExit."""
    ctl = ElasticController(
        [sys.executable, "-c", program], hosts,
        env=dict({"PYTHONPATH": SRC}, **(env or {})), max_restarts=0,
        timeout=120.0, rendezvous_dir=str(tmp_path / "rendezvous"))
    exits = sorted(ctl.run().final.exits, key=lambda e: e.host_id)
    for e in exits:
        assert e.returncode == 0, e.stderr[-3000:]
    return exits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scenario on both layouts (each host's results), and here in
    emulated mode."""
    out = {}
    for name, (hosts, local) in LAYOUTS.items():
        tmp = tmp_path_factory.mktemp(f"mesh{name}")
        exits = run_hosts(_HOST, hosts, tmp,
                          env={"LOCAL": str(local), "CKPT_ROOT": str(tmp / "ck")})
        out[name] = ([_result(e.stdout) for e in exits], str(tmp / "ck"))
    tmp = tmp_path_factory.mktemp("emulated")
    out["emulated"] = ([_NS["run_all"](None, str(tmp / "ck"))], str(tmp / "ck"))
    return out


def _arr(x):
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_host_holds_its_rows_and_the_same_results(runs, layout):
    hosts, local = LAYOUTS[layout]
    results, _ = runs[layout]
    assert len(results) == hosts
    for r in results:
        assert r["__rows"] == 64 // hosts and r["__backend"] == "gloo"
        for k in r:
            if not k.startswith("__"):
                assert r[k] == results[0][k], (layout, k)


@pytest.mark.parametrize("what", ["fit", "fit_kernel", "stream"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_logreg_gather_broadcast_is_bitwise_the_emulated_run(runs, layout, what):
    key = f"{what}/gather_broadcast"
    got = _arr(runs[layout][0][0][key])
    want = _arr(runs["emulated"][0][0][key])
    assert got.tobytes() == want.tobytes(), (layout, key, got, want)


@pytest.mark.parametrize("schedule", ["allreduce", "reduce_scatter"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_logreg_reduction_schedules_within_tolerance(runs, layout, schedule):
    for what in ("fit", "fit_kernel", "stream"):
        got = _arr(runs[layout][0][0][f"{what}/{schedule}"])
        want = _arr(runs["emulated"][0][0][f"{what}/{schedule}"])
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (what, got, want)


@pytest.fixture(scope="module")
def reference():
    """The reference's emulated streamed fits (num_shards=8)."""
    out = {}
    kw = dict(num_epochs=3, chunks_per_epoch=2, num_shards=8)
    for s in SCHEDULES:
        out["stream/" + s] = np.asarray(JLR(
            learning_rate=0.3, local_batch_size=2, schedule=s).fit_stream(
            JBatchIterator(_NS["clf_source"]), **kw).weights)
        out["kmeans/" + s] = np.asarray(JKMeans(k=4, seed=0, schedule=s).fit_stream(
            JBatchIterator(_NS["km_source"]), **kw).centroids)
    return out


@pytest.mark.parametrize("algo", ["stream", "kmeans"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_every_schedule_agrees_with_the_reference_emulated_run(
        runs, reference, layout, schedule, algo):
    key = f"{algo}/{schedule}"
    np.testing.assert_allclose(_arr(runs[layout][0][0][key]), reference[key], **TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kmeans_lattice_is_bitwise_across_layouts_and_schedules(runs, layout, schedule):
    want = _arr(runs["emulated"][0][0]["kmeans/gather_broadcast"])
    for key in (f"kmeans/{schedule}",):
        assert _arr(runs[layout][0][0][key]).tobytes() == want.tobytes(), key
    fit_want = _arr(runs["emulated"][0][0]["kmeans_fit/gather_broadcast"])
    assert _arr(runs[layout][0][0][f"kmeans_fit/{schedule}"]).tobytes() == \
        fit_want.tobytes()


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_concat_is_the_tables_rows_under_every_schedule(runs, layout, schedule):
    want = 2 * _NS["clf_source"](99)["data"] + 1
    got = _arr(runs[layout][0][0][f"concat/{schedule}"])
    assert got.tobytes() == want.astype(np.float32).tobytes()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_run_epochs_and_resume_on_the_same_mesh(runs, layout):
    r = runs[layout][0][0]
    assert _arr(r["resumed"]).tobytes() == _arr(r["epochs"]).tobytes()
    e = runs["emulated"][0][0]
    assert _arr(r["epochs"]).tobytes() == _arr(e["epochs"]).tobytes()


def _resize_resume(ckpt_root: str, num_shards: int, allow_resize: bool):
    ns = _NS
    p = ns["LogisticRegression"](learning_rate=0.3, local_batch_size=2,
                                 schedule="gather_broadcast")
    return p.fit_stream(
        ns["stream"](ns["clf_source"], None), num_epochs=4, num_shards=num_shards,
        checkpoint=ns["CheckpointPolicy"](os.path.join(ckpt_root, "resize")),
        resume=True, allow_resize=allow_resize).weights


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_allow_resize_from_8_partitions_to_4(runs, layout, tmp_path):
    import shutil

    for name in (layout, "emulated"):
        shutil.copytree(os.path.join(runs[name][1], "resize"),
                        str(tmp_path / name / "resize"))
    from repro_torch.checkpoint import load_metadata

    meta = load_metadata(str(tmp_path / layout / "resize"))
    assert meta["num_shards"] == 8 and meta["num_hosts"] == LAYOUTS[layout][0]
    assert meta["rows_per_epoch"] == 64
    got = _resize_resume(str(tmp_path / layout), 4, True)
    want = _resize_resume(str(tmp_path / "emulated"), 4, True)
    assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_allow_resize_agrees_with_the_reference_emulated_resize(runs, layout, tmp_path):
    """The mesh snapshot of 8 partitions resumed on 4 with allow_resize,
    against the reference's emulated run making the same snapshot and the
    same resize (its resume validates the move through plan_resize)."""
    import shutil

    from repro.core.runner import CheckpointPolicy as JCheckpointPolicy

    shutil.copytree(os.path.join(runs[layout][1], "resize"), str(tmp_path / "port" / "resize"))
    got = _resize_resume(str(tmp_path / "port"), 4, True)
    ck = JCheckpointPolicy(str(tmp_path / "ref" / "resize"))
    lr = dict(learning_rate=0.3, local_batch_size=2, schedule="gather_broadcast")
    JLR(**lr).fit_stream(JBatchIterator(_NS["clf_source"]), num_epochs=2,
                         chunks_per_epoch=_NS["CHUNKS"], num_shards=8, checkpoint=ck)
    want = JLR(**lr).fit_stream(JBatchIterator(_NS["clf_source"]), num_epochs=4,
                                num_shards=4, checkpoint=ck, resume=True,
                                allow_resize=True).weights
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_resume_on_another_world_size_needs_allow_resize(runs, tmp_path):
    import shutil

    shutil.copytree(os.path.join(runs["2x4"][1], "resize"), str(tmp_path / "resize"))
    with pytest.raises(ValueError, match="pass allow_resize=True"):
        _resize_resume(str(tmp_path), 4, False)
    with pytest.raises(ValueError, match="new partitions"):
        _resize_resume(str(tmp_path), 5, True)


# --------------------------------------------------------------------------- #
# layout, backend, joining
# --------------------------------------------------------------------------- #
def _mesh(host, hosts=2, local=4):
    return HostMesh(local_partitions=local, device=torch.device("cpu"),
                    backend="gloo", host_id=host, num_hosts=hosts)


def test_local_rows_are_process_major_blocks(runs):
    data = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    for h in range(2):
        m = _mesh(h)
        assert hostmesh.local_row_slice(64, m) == slice(32 * h, 32 * (h + 1))
        t = MLNumericTable.from_numpy(data, mesh=m)
        assert t.num_rows == 64 and t.num_shards == 8 and t.rows_per_shard == 8
        assert torch.equal(t.data, torch.from_numpy(data[32 * h:32 * (h + 1)]))
        assert torch.equal(hostmesh.place_global_rows(data[32 * h:32 * (h + 1)], 64, m),
                           t.data)
        with pytest.raises(ValueError, match="holds 16 rows"):
            hostmesh.place_global_rows(data[:16], 64, m)
    # a mesh table's sum_rows (gloo hosts) is bitwise the emulated table's
    want = _arr(runs["emulated"][0][0]["sum_rows"])
    for layout in LAYOUTS:
        for r in runs[layout][0]:
            assert _arr(r["sum_rows"]).tobytes() == want.tobytes(), layout
    with pytest.raises(ValueError, match="global row partitions"):
        hostmesh.local_row_slice(60, _mesh(0))
    assert tpt.infer_data_axes(_mesh(0)) == ("data",)
    assert tpt.num_data_shards(_mesh(0)) == 8 and tpt.num_data_shards(_mesh(0), ()) == 1
    assert hostmesh.num_hosts() == 1 and not hostmesh.is_multihost()
    np.testing.assert_array_equal(hostmesh.fetch(torch.ones(2)), np.ones(2))


def test_runner_on_a_mesh_takes_its_partitions_and_refuses_stacked_trials(runs):
    r = DistributedRunner(num_shards=3, mesh=_mesh(1))
    assert r.num_shards == 8 and r.local_shards == 4 and r.num_hosts == 2
    # stacked trials run on a mesh: bitwise each lane alone and the
    # emulated stack
    want = _arr(runs["emulated"][0][0]["stacked"])
    assert want.tobytes() == _arr(runs["emulated"][0][0]["stacked_seq"]).tobytes()
    for layout in LAYOUTS:
        got = runs[layout][0][0]
        assert _arr(got["stacked"]).tobytes() == want.tobytes(), layout
        assert _arr(got["stacked_seq"]).tobytes() == want.tobytes(), layout


def test_backend_rule():
    assert hostmesh.choose_backend("cpu", 2) == "gloo"
    assert hostmesh.choose_backend("cpu", 1, "gloo") == "gloo"
    with pytest.raises(ValueError, match="NCCL needs one card per host"):
        hostmesh.choose_backend("cpu", 2, "nccl")
    with pytest.raises(ValueError, match="backend must be"):
        hostmesh.choose_backend("cpu", 2, "mpi")
    info = hostmesh.initialize_from_env("cpu")
    assert info == hostmesh.HostInfo(host_id=0, num_hosts=1)


def test_a_host_that_cannot_join_raises_within_its_timeout(tmp_path):
    prog = ("from repro_torch.core import hostmesh\n"
            f"hostmesh.initialize('file://{tmp_path}/rdv', 2, 0, device='cpu', timeout=3)\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=SRC), timeout=120)
    assert out.returncode != 0
    assert time.monotonic() - t0 < 60
    assert "timeout" in out.stderr.lower() or "timed out" in out.stderr.lower(), \
        out.stderr[-2000:]


def test_launch_fit_two_hosts_is_bitwise_the_one_process_run(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", SRC)
    monkeypatch.setattr(tfit, "GENERATION_TIMEOUT", 120.0)
    args = ["--algorithm", "logreg", "--device", "cpu", "--epochs", "3",
            "--schedule", "gather_broadcast", "--json"]
    report = tfit.main(args + ["--hosts", "2", "--devices-per-host", "2",
                               "--ckpt-dir", str(tmp_path / "h")])
    shas = {_result(e.stdout)["sha"] for e in report.final.exits}
    parts = {_result(e.stdout)["partitions"] for e in report.final.exits}
    single = tfit.main(args + ["--num-shards", "4"])
    assert shas == {tfit.state_sha(single.weights)} and parts == {4}
    assert hashlib.sha256(single.weights.numpy().tobytes()).hexdigest() in shas
