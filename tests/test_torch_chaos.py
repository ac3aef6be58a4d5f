"""The port's chaos harness, SSP executor and elastic controller on real host
processes.

Pinned, after the contracts of ``tests/chaos/`` (whose SSP tests pass
against the reference; its BSP and elastic ones fail on the installed jax,
``jax.core.trace_state_clean``):

  * ``Fault`` / ``faults_to_env`` / ``ChaosInjector`` as the reference's
    (same JSON, same exit code); ``delay`` and ``drop`` in-process, ``kill``
    in a child (SIGKILL);
  * **s = 0 is BSP, bitwise**: two host processes running
    ``run_epochs_ssp`` (mean lane and sum lane) end bitwise each other and
    bitwise a sequential simulator replaying both hosts in this process,
    and every round reads every peer's same round;
  * **s = 0 against the reference**: both lanes through the port's and the
    reference's ``run_epochs_ssp`` (emulated, a two-host store, one thread
    a host) on the same numpy windows, within 1e-5, and the port's
    cohort bitwise the simulator;
  * **the staleness bound** under a ``delay`` fault: reads genuinely stale
    yet never more than ``s`` rounds old;
  * **drop**: the departed host exits with ``DROP_EXIT_CODE``, the other
    finishes alone;
  * **kill + resume_ssp**: a SIGKILLed host restarts from its own snapshot
    against the same store and both end bitwise the simulator;
  * **ElasticController**: a SIGKILLed host of a 2-host BSP gang (gloo)
    triggers a restart on 1 host that resumes with ``allow_resize``,
    bitwise a 1-host resume of the same snapshot in this process; a
    casualty (``PEER_LOST_EXIT_CODE``) does not shrink the world.
"""
import json
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.testing.chaos import DROP_EXIT_CODE as J_DROP
from repro.testing.chaos import ENV_VAR as J_ENV
from repro.testing.chaos import Fault as JFault
from repro.testing.chaos import faults_to_env as j_faults_to_env
from repro_torch.core.exchange import ParamStore
from repro_torch.core.hostmesh import PEER_LOST_EXIT_CODE
from repro_torch.core.runner import DistributedRunner
from repro_torch.data import BatchIterator
from repro_torch.launch import fit as tfit
from repro_torch.launch.elastic import ElasticController, HostExit
from repro_torch.testing import (DROP_EXIT_CODE, ENV_VAR, ChaosInjector, Fault,
                                 faults_to_env)

pytestmark = pytest.mark.skipif(not hasattr(signal, "SIGKILL"),
                                reason="POSIX-only kill semantics")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
E, DEV, ROWS, F = 4, 2, 32, 3

# one SSP host's lanes, shared by the host processes and the simulator
_LANES = r'''
import numpy as np
import torch

ROWS, F, DEV = %(ROWS)d, %(F)d, %(DEV)d


def make_source(host):
    def source(step):
        rng = np.random.RandomState(1000 * host + step)
        return {"data": rng.randn(ROWS, F + 1).astype(np.float32)}
    return source


def local_step(blocks, state, r):
    x, y = blocks[..., :F], blocks[..., F]
    resid = (x * state).sum(-1) - y
    g = (x * resid.unsqueeze(-1)).sum(1) / blocks.shape[1]
    return state - 0.1 * g


def stats_step(blocks, state, r):
    x = blocks[..., :F]
    m = ((x * state).sum(-1) > 0).to(torch.float32)
    return {"n": m.sum(1), "s": (x * m.unsqueeze(-1)).sum(1)}


def update(state, merged, r):
    return merged["s"] / torch.clamp(merged["n"], min=1.0)
''' % {"ROWS": ROWS, "F": F, "DEV": DEV}

_HOST = _LANES + r'''
import json, os
from repro_torch.core.exchange import ParamStore
from repro_torch.core.runner import CheckpointPolicy, DistributedRunner
from repro_torch.data import BatchIterator
from repro_torch.testing import ChaosInjector

HOST = int(os.environ["REPRO_HOST_ID"])
N = int(os.environ["REPRO_NUM_HOSTS"])
ROOT = os.environ["STORE_ROOT"]
EPOCHS = int(os.environ.get("EPOCHS", "%(E)d"))
S = int(os.environ.get("STALENESS", "0"))

runner = DistributedRunner(num_shards=DEV, schedule="gather_broadcast")
store = ParamStore(ROOT, HOST, N, timeout=120.0, keep=S + 2)
stream = ChaosInjector.from_env(store=store).wrap_stream(
    BatchIterator(make_source(HOST), device="cpu"))
trace = []
ckpt = None
if os.environ.get("CKPT_BASE"):
    ckpt = CheckpointPolicy(os.path.join(os.environ["CKPT_BASE"], "h%%d" %% HOST))
if os.environ.get("REPRO_RESUME") == "1":
    w = runner.resume_ssp(ckpt.ckpt_dir, stream, torch.zeros(F), local_step,
                          EPOCHS, store=store, combine="mean", trace=trace)
else:
    w = runner.run_epochs_ssp(stream, torch.zeros(F), local_step, EPOCHS,
                              store=store, staleness=S, combine="mean",
                              chunks_per_epoch=2, checkpoint=ckpt, trace=trace)
out = {"host": HOST, "mean": w.numpy().tobytes().hex(),
       "trace": [{"epoch": t["epoch"], "reads": {str(k): v for k, v in t["reads"].items()}}
                 for t in trace]}
if os.environ.get("SUM_LANE") == "1":
    store2 = ParamStore(ROOT + "_sum", HOST, N, timeout=120.0, keep=S + 2)
    c = runner.run_epochs_ssp(BatchIterator(make_source(HOST), device="cpu"),
                              torch.ones(F), stats_step, EPOCHS, store=store2,
                              staleness=S, combine="sum", update=update)
    out["sum"] = c.numpy().tobytes().hex()
print("RESULT::" + json.dumps(out))
''' % {"E": E}

_NS: dict = {}
exec(compile(_LANES, "<ssp lanes>", "exec"), _NS)


def _result(stdout: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT::")]
    assert lines, stdout[-2000:]
    return json.loads(lines[-1][len("RESULT::"):])


def ssp_hosts(tmp_path, env: dict, faults=(), hosts: int = 2, check: bool = True):
    """Run ``hosts`` independent SSP host processes (no process group)."""
    ctl = ElasticController([sys.executable, "-c", _HOST], hosts,
                            env=dict({"PYTHONPATH": SRC}, **env), faults=faults,
                            max_restarts=0, timeout=120.0, global_mesh=False)
    exits = sorted(ctl.run().final.exits, key=lambda e: e.host_id)
    if check:
        for e in exits:
            assert e.returncode == 0, e.stderr[-3000:]
    return exits


def simulate(tmp_path, epochs: int = E, hosts: int = 2) -> dict:
    """The sequential replay of an s = 0 cohort in this process: each
    host's local epoch through ``run_epochs_ssp`` on a one-host store, the
    merge by stacking in host-id order and reducing."""
    ns = _NS
    runner = DistributedRunner(num_shards=DEV, schedule="gather_broadcast")
    streams = [BatchIterator(ns["make_source"](h), device="cpu") for h in range(hosts)]
    w = torch.zeros(F)
    for e in range(epochs):
        mines = [runner.run_epochs_ssp(
            streams[h], w, ns["local_step"], e + 1,
            store=ParamStore(str(tmp_path / f"solo{h}_{e}"), 0, 1), staleness=0,
            combine="mean", chunks_per_epoch=2, start_epoch=e) for h in range(hosts)]
        w = torch.stack(mines).mean(dim=0)
    streams = [BatchIterator(ns["make_source"](h), device="cpu") for h in range(hosts)]
    c = torch.ones(F)
    for e in range(epochs):
        stats = [runner.partition_apply(next(streams[h])["data"],
                                        lambda b: ns["stats_step"](b, c, e),
                                        combine="sum") for h in range(hosts)]
        merged = {k: torch.stack([s[k] for s in stats]).sum(dim=0) for k in ("n", "s")}
        c = ns["update"](c, merged, e)
    return {"mean": w.numpy().tobytes().hex(), "sum": c.numpy().tobytes().hex()}


# --------------------------------------------------------------------------- #
# the injector
# --------------------------------------------------------------------------- #
def test_faults_encode_as_the_reference():
    faults = [(1, 2, "kill", 0.0), (0, 3, "delay", 0.5), (2, 1, "drop", 0.0)]
    got = faults_to_env([Fault(*f) for f in faults])
    want = j_faults_to_env([JFault(*f) for f in faults])
    assert got == want and ENV_VAR == J_ENV == "REPRO_CHAOS"
    assert DROP_EXIT_CODE == J_DROP == 76
    with pytest.raises(ValueError, match="unknown fault action"):
        Fault(0, 0, "explode")
    with pytest.raises(ValueError, match="seconds > 0"):
        Fault(0, 0, "delay")
    with pytest.raises(ValueError, match="two faults"):
        ChaosInjector([Fault(0, 1, "kill"), Fault(0, 1, "drop")])


def test_injector_delays_and_drops_at_its_round(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_VAR, json.dumps(
        [{"host": 1, "round": 1, "action": "delay", "seconds": 0.05},
         {"host": 1, "round": 2, "action": "drop", "seconds": 0.0},
         {"host": 0, "round": 0, "action": "kill", "seconds": 0.0}]))
    store = ParamStore(str(tmp_path), 1, 2)
    inj = ChaosInjector.from_env(host_id=1, store=store)
    assert inj and not ChaosInjector([], host_id=1)
    s = inj.wrap_stream(BatchIterator(_NS["make_source"](1), device="cpu"))
    assert s.device == torch.device("cpu") and s.mesh is None
    next(s)
    next(s)
    assert [f.action for f in inj.injected] == ["delay"]
    with pytest.raises(SystemExit) as err:
        next(s)
    assert err.value.code == DROP_EXIT_CODE
    assert ParamStore(str(tmp_path), 0, 2).peers() == []
    assert s.seek(0).step == 0


def test_kill_fault_sigkills_its_host(tmp_path):
    prog = (_LANES + "\nfrom repro_torch.data import BatchIterator\n"
            "from repro_torch.testing import ChaosInjector\n"
            "s = ChaosInjector.from_env(host_id=0).wrap_stream("
            "BatchIterator(make_source(0), device='cpu'))\n"
            "for _ in range(5):\n    next(s)\nprint('survived')\n")
    env = dict(os.environ, PYTHONPATH=SRC,
               **faults_to_env([Fault(host=0, round=3, action="kill")]))
    out = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == -signal.SIGKILL and "survived" not in out.stdout


# --------------------------------------------------------------------------- #
# the SSP executor on host processes
# --------------------------------------------------------------------------- #
def test_s0_bitwise_across_hosts_and_against_the_simulator(tmp_path):
    h0, h1 = (_result(e.stdout) for e in ssp_hosts(
        tmp_path, {"STORE_ROOT": str(tmp_path / "x"), "SUM_LANE": "1"}))
    assert h0["mean"] == h1["mean"] and h0["sum"] == h1["sum"]
    sim = simulate(tmp_path)
    assert h0["mean"] == sim["mean"] and h0["sum"] == sim["sum"]
    for r in (h0, h1):
        peer = str(1 - r["host"])
        assert [t["reads"] for t in r["trace"]] == [{peer: e} for e in range(E)]


def _j_local_step(block, state, r):
    x, y = block[:, :F], block[:, F]
    return state - 0.1 * (x.T @ (x @ state - y) / block.shape[0])


def _j_stats_step(block, state, r):
    import jax.numpy as jnp

    x = block[:, :F]
    m = (x @ state > 0).astype(jnp.float32)
    return {"n": jnp.sum(m), "s": x.T @ m}


def _j_update(state, merged, r):
    import jax.numpy as jnp

    return merged["s"] / jnp.maximum(merged["n"], 1.0)


def _cohort(run, hosts: int = 2) -> list:
    """``run(h)`` for every host, each in its own thread; results by host."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(hosts) as pool:
        futures = [pool.submit(run, h) for h in range(hosts)]
        return [np.asarray(f.result(timeout=120)) for f in futures]


@pytest.mark.parametrize("lane", ["mean", "sum"])
def test_s0_lanes_agree_with_the_reference_executor(tmp_path, lane):
    import jax.numpy as jnp

    from repro.core.exchange import ParamStore as JParamStore
    from repro.core.runner import DistributedRunner as JDistributedRunner
    from repro.data.pipeline import BatchIterator as JBatchIterator

    ns = _NS
    jrunner = JDistributedRunner(num_shards=DEV, schedule="gather_broadcast")
    trunner = DistributedRunner(num_shards=DEV, schedule="gather_broadcast")

    def reference(h):
        store = JParamStore(str(tmp_path / "ref"), h, 2, timeout=120.0, keep=2)
        stream = JBatchIterator(ns["make_source"](h))
        if lane == "mean":
            return jrunner.run_epochs_ssp(stream, jnp.zeros((F,), jnp.float32), _j_local_step,
                                          E, store=store, staleness=0, combine="mean",
                                          chunks_per_epoch=2)
        return jrunner.run_epochs_ssp(stream, jnp.ones((F,), jnp.float32), _j_stats_step, E,
                                      store=store, staleness=0, combine="sum",
                                      update=_j_update)

    def port(h):
        store = ParamStore(str(tmp_path / "port"), h, 2, timeout=120.0, keep=2)
        stream = BatchIterator(ns["make_source"](h), device="cpu")
        if lane == "mean":
            return trunner.run_epochs_ssp(stream, torch.zeros(F), ns["local_step"], E,
                                          store=store, staleness=0, combine="mean",
                                          chunks_per_epoch=2)
        return trunner.run_epochs_ssp(stream, torch.ones(F), ns["stats_step"], E,
                                      store=store, staleness=0, combine="sum",
                                      update=ns["update"])

    want, got = _cohort(reference), _cohort(port)
    assert want[0].tobytes() == want[1].tobytes()
    assert got[0].tobytes() == got[1].tobytes()
    assert got[0].tobytes().hex() == simulate(tmp_path / "sim")[lane]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


def test_staleness_bound_holds_under_a_delay_fault(tmp_path):
    s = 2
    exits = ssp_hosts(tmp_path, {"STORE_ROOT": str(tmp_path / "x"), "EPOCHS": "6",
                                 "STALENESS": str(s)},
                      faults=[Fault(host=1, round=2, action="delay", seconds=1.0)])
    stale = 0
    for e in exits:
        res = _result(e.stdout)
        for t in res["trace"]:
            for read in t["reads"].values():
                assert t["epoch"] - s <= read <= t["epoch"], (res["host"], t)
                stale += read < t["epoch"]
    assert stale > 0, "the delay produced no stale read: SSP never decoupled"


def test_a_dropped_host_leaves_and_the_other_finishes(tmp_path):
    exits = ssp_hosts(tmp_path, {"STORE_ROOT": str(tmp_path / "x"), "EPOCHS": "5"},
                      faults=[Fault(host=1, round=2, action="drop")], check=False)
    assert exits[1].returncode == DROP_EXIT_CODE and exits[1].dropped
    assert exits[0].returncode == 0, exits[0].stderr[-2000:]
    trace = _result(exits[0].stdout)["trace"]
    assert [t["reads"] for t in trace[:2]] == [{"1": 0}, {"1": 1}]
    assert all(t["reads"] == {} for t in trace[2:])


def test_a_killed_host_resumes_and_the_cohort_matches_the_simulator(tmp_path):
    def spawn(h, extra):
        env = dict(os.environ, PYTHONPATH=SRC, REPRO_NUM_HOSTS="2",
                   REPRO_HOST_ID=str(h), STORE_ROOT=str(tmp_path / "x"),
                   CKPT_BASE=str(tmp_path / "ck"))
        env.pop(ENV_VAR, None)
        env.update(extra)
        return subprocess.Popen([sys.executable, "-c", _HOST], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)

    p0 = spawn(0, {})
    p1 = spawn(1, faults_to_env([Fault(host=1, round=2, action="kill")]))
    try:
        assert p1.wait(timeout=120) == -signal.SIGKILL
        p1b = spawn(1, {"REPRO_RESUME": "1"})
        out1, err1 = p1b.communicate(timeout=120)
        assert p1b.returncode == 0, err1[-2000:]
        out0, err0 = p0.communicate(timeout=120)
        assert p0.returncode == 0, err0[-2000:]
    finally:
        for p in (p0, p1):
            if p.poll() is None:
                p.kill()
    r0, r1 = _result(out0), _result(out1)
    assert r0["mean"] == r1["mean"] == simulate(tmp_path)["mean"]
    assert r1["trace"][0]["epoch"] == 2


# --------------------------------------------------------------------------- #
# the elastic controller
# --------------------------------------------------------------------------- #
def test_a_killed_host_triggers_a_resize_and_a_bitexact_resume(tmp_path, monkeypatch):
    monkeypatch.setenv("PYTHONPATH", SRC)
    monkeypatch.setattr(tfit, "GENERATION_TIMEOUT", 120.0)
    monkeypatch.setenv(ENV_VAR, json.dumps(
        [{"host": 1, "round": 2, "action": "kill", "seconds": 0.0}]))
    args = ["--algorithm", "logreg", "--device", "cpu", "--epochs", "5",
            "--schedule", "gather_broadcast", "--json"]
    ck = tmp_path / "ck"
    report = tfit.main(args + ["--hosts", "2", "--devices-per-host", "2",
                               "--elastic", "--ckpt-dir", str(ck)])
    assert [g.num_hosts for g in report.generations] == [2, 1]
    assert [e.host_id for e in report.generations[0].deaths] == [1]
    assert len(report.restart_seconds) == 1
    migrated = _result(report.host_output(0))
    assert migrated["generation"] == 1 and migrated["partitions"] == 2
    assert migrated["stream_step"] == 5 and 1 <= migrated["resumed_from"] <= 2
    # the same snapshot resumed here on 1 host x 2 partitions
    ref = tmp_path / "ref"
    shutil.copytree(ck, ref, ignore=shutil.ignore_patterns("rendezvous", "exchange"))
    for fn in os.listdir(ref):
        if fn.startswith("step_") and int(fn[5:-4]) > migrated["resumed_from"]:
            os.remove(ref / fn)
    monkeypatch.delenv(ENV_VAR)
    out = tfit.main(args + ["--num-shards", "2", "--elastic", "--resume",
                            "--ckpt-dir", str(ref)])
    assert tfit.state_sha(out.weights) == migrated["sha"]


def test_a_casualty_does_not_shrink_the_world(tmp_path):
    # host 2 dies; hosts 0 and 1 exit as its casualties after it, as a
    # survivor's collective fails only once its peer is gone
    mark = tmp_path / "died"
    prog = ("import os, sys, time\n"
            "h, g = int(os.environ['REPRO_HOST_ID']), int(os.environ['REPRO_GENERATION'])\n"
            "if g:\n    sys.exit(0)\n"
            f"if h == 2:\n    open({str(mark)!r}, 'w').close()\n    sys.exit(1)\n"
            f"while not os.path.exists({str(mark)!r}):\n    time.sleep(0.01)\n"
            f"time.sleep(0.5)\nsys.exit({PEER_LOST_EXIT_CODE})\n")
    report = ElasticController([sys.executable, "-c", prog], 3, max_restarts=1,
                               rendezvous_dir=str(tmp_path)).run()
    g0 = report.generations[0]
    assert [e.host_id for e in g0.deaths] == [2]
    assert [g.num_hosts for g in report.generations] == [3, 2]
    assert report.generations[1].coordinator.startswith("file://")
    lost = HostExit(0, PEER_LOST_EXIT_CODE, "", "")
    assert lost.casualty and not lost.died and not lost.dropped
    assert HostExit(0, 1, "", "").died and not HostExit(0, -9, "", "", evicted=True).died
