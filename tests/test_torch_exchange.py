"""The port's SSP exchange store and barrier discipline against the reference.

``repro_torch.core.exchange.ParamStore`` runs the cases of
``tests/test_exchange_regressions.py`` (a straggler that keeps publishing
is waited out, a frozen clock times out after one window of silence, a
departed peer returns at once, reads survive the peer's pruning); a
publish from either package is read by the other; and ``SyncPolicy``,
``ssp_read_round``, ``ssp_trace`` and ``plan_resize`` equal the
reference's functions on the same inputs (property-tested with hypothesis,
or its fallback).
"""
import os
import random
import threading
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.core import collectives as jcoll
from repro.core import partition as jpt
from repro.core.exchange import ParamStore as JParamStore
from repro_torch.core import collectives as tcoll
from repro_torch.core import partition as tpt
from repro_torch.core.exchange import ParamStore, PeerTimeout


def tree(v: float):
    return {"w": torch.full((4,), v, dtype=torch.float32)}


# --------------------------------------------------------------------------- #
# wait_clock: straggler vs corpse
# --------------------------------------------------------------------------- #
def test_wait_clock_waits_out_slow_but_alive_straggler(tmp_path):
    root = str(tmp_path)
    a = ParamStore(root, 0, 2, timeout=0.3, poll=0.005)
    b = ParamStore(root, 1, 2, timeout=0.3, poll=0.005)
    target = 8

    def straggle():
        for r in range(target):
            time.sleep(0.12)
            b.publish(r, tree(r))

    t = threading.Thread(target=straggle)
    t.start()
    try:
        assert a.wait_clock(1, target) >= target
    finally:
        t.join(timeout=30)
    assert not t.is_alive()


def test_wait_clock_still_times_out_on_frozen_clock(tmp_path):
    root = str(tmp_path)
    a = ParamStore(root, 0, 2, timeout=0.25, poll=0.005)
    b = ParamStore(root, 1, 2)
    b.publish(0, tree(0.0))
    b.publish(1, tree(1.0))
    t0 = time.monotonic()
    with pytest.raises(PeerTimeout) as err:
        a.wait_clock(1, 5)
    elapsed = time.monotonic() - t0
    assert err.value.peer == 1 and err.value.wanted_round == 4
    assert 0.2 <= elapsed < 2.0


def test_wait_clock_timeout_measures_silence_not_total_wait(tmp_path):
    root = str(tmp_path)
    a = ParamStore(root, 0, 2, timeout=0.3, poll=0.005)
    b = ParamStore(root, 1, 2)
    b.publish(0, tree(0.0))

    def one_late_publish():
        time.sleep(0.15)
        b.publish(1, tree(1.0))

    t = threading.Thread(target=one_late_publish)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(PeerTimeout):
        a.wait_clock(1, 4)
    elapsed = time.monotonic() - t0
    t.join(timeout=30)
    assert not t.is_alive()
    assert elapsed >= 0.3


def test_wait_clock_returns_early_for_departed_peer(tmp_path):
    root = str(tmp_path)
    a = ParamStore(root, 0, 2, timeout=5.0, poll=0.005)
    b = ParamStore(root, 1, 2)
    b.publish(0, tree(0.0))
    b.mark_left()
    t0 = time.monotonic()
    assert a.wait_clock(1, 100) == 1
    assert time.monotonic() - t0 < 1.0
    assert a.peers() == [] and b.has_left(1)


# --------------------------------------------------------------------------- #
# read_at_most: racing the peer's pruning
# --------------------------------------------------------------------------- #
def test_read_at_most_retries_when_listed_round_is_pruned(tmp_path):
    root = str(tmp_path)
    a = ParamStore(root, 0, 2)
    b = ParamStore(root, 1, 2)
    for r in range(4):
        b.publish(r, tree(float(r)))
    real_rounds = a.rounds
    state = {"pruned": False}

    def racing_rounds(host):
        out = real_rounds(host)
        if not state["pruned"]:
            state["pruned"] = True
            os.unlink(os.path.join(root, "h1", f"step_{out[-1]}.npz"))
        return out

    a.rounds = racing_rounds
    restored, r = a.read_at_most(1, 3, tree(0.0))
    assert r == 2
    assert torch.equal(restored["w"], torch.full((4,), 2.0))


def test_read_at_most_returns_none_when_everything_pruned(tmp_path):
    root = str(tmp_path)
    a = ParamStore(root, 0, 2)
    b = ParamStore(root, 1, 2)
    for r in range(3):
        b.publish(r, tree(float(r)))
    real_rounds = a.rounds

    def racing_rounds(host):
        out = real_rounds(host)
        for rr in out:
            f = os.path.join(root, "h1", f"step_{rr}.npz")
            if os.path.exists(f):
                os.unlink(f)
        return out

    a.rounds = racing_rounds
    assert a.read_at_most(1, 2, tree(0.0)) is None


def test_read_at_most_survives_repeated_pruning_races(tmp_path):
    root = str(tmp_path)
    a = ParamStore(root, 0, 2)
    b = ParamStore(root, 1, 2)
    for r in range(5):
        b.publish(r, tree(float(r)))
    real_rounds = a.rounds
    state = {"races": 0}

    def racing_rounds(host):
        out = real_rounds(host)
        if state["races"] < 3 and len(out) > 1:
            state["races"] += 1
            os.unlink(os.path.join(root, "h1", f"step_{out[-1]}.npz"))
        return out

    a.rounds = racing_rounds
    restored, r = a.read_at_most(1, 4, tree(0.0))
    assert r == 1 and state["races"] == 3
    assert torch.equal(restored["w"], torch.full((4,), 1.0))


def test_keep_prunes_old_publishes_and_clocks_follow(tmp_path):
    a = ParamStore(str(tmp_path), 0, 2, keep=2)
    for r in range(5):
        a.publish(r, tree(float(r)))
    assert a.rounds(0) == [3, 4] and a.clock(0) == 5
    assert a.clocks() == {0: 5, 1: 0}
    with pytest.raises(ValueError, match="not in"):
        ParamStore(str(tmp_path), 2, 2)


# --------------------------------------------------------------------------- #
# one board, two packages
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_publish_is_read_by_the_other_package(writer, tmp_path):
    root = str(tmp_path)
    rng = np.random.default_rng(0)
    value = {"w": rng.normal(size=(6,)).astype(np.float32),
             "stats": {"n": np.float32(3.0), "s": rng.normal(size=(2, 3)).astype(np.float32)}}
    if writer == "reference":
        JParamStore(root, 1, 2).publish(4, value)
        got, r = ParamStore(root, 0, 2).read_at_most(
            1, 5, {"w": torch.zeros(6), "stats": {"n": torch.zeros(()),
                                                  "s": torch.zeros(2, 3)}})
        flat = {"w": got["w"].numpy(), "n": got["stats"]["n"].numpy(),
                "s": got["stats"]["s"].numpy()}
    else:
        ParamStore(root, 1, 2).publish(4, {
            "w": torch.from_numpy(value["w"]),
            "stats": {"n": torch.tensor(3.0), "s": torch.from_numpy(value["stats"]["s"])}})
        got, r = JParamStore(root, 0, 2).read_at_most(
            1, 5, {"w": np.zeros(6, np.float32),
                   "stats": {"n": np.float32(0), "s": np.zeros((2, 3), np.float32)}})
        flat = {"w": np.asarray(got["w"]), "n": np.asarray(got["stats"]["n"]),
                "s": np.asarray(got["stats"]["s"])}
    assert r == 4
    np.testing.assert_array_equal(flat["w"], value["w"])
    np.testing.assert_array_equal(flat["n"], value["stats"]["n"])
    np.testing.assert_array_equal(flat["s"], value["stats"]["s"])
    assert JParamStore(root, 0, 2).clock(1) == ParamStore(root, 0, 2).clock(1) == 5


def test_departure_markers_are_shared(tmp_path):
    root = str(tmp_path)
    JParamStore(root, 1, 3).mark_left()
    assert ParamStore(root, 0, 3).peers() == [2]
    ParamStore(root, 2, 3).mark_left()
    assert JParamStore(root, 0, 3).peers() == []


# --------------------------------------------------------------------------- #
# the barrier discipline's spec against the reference's
# --------------------------------------------------------------------------- #
@settings(max_examples=60, deadline=None)
@given(workers=st.integers(min_value=1, max_value=6),
       rounds=st.integers(min_value=1, max_value=10),
       staleness=st.integers(min_value=0, max_value=4),
       seed=st.integers(min_value=0, max_value=10_000))
def test_ssp_trace_equals_the_reference(workers, rounds, staleness, seed):
    rng = random.Random(seed)
    durations = [[rng.randint(1, 50) for _ in range(rounds)]
                 for _ in range(workers)]
    got = tcoll.ssp_trace(durations, staleness)
    assert got == jcoll.ssp_trace(durations, staleness)
    for w, wt in enumerate(got):
        for r, reads in enumerate(wt):
            assert all(r - staleness <= v <= r for v in reads.values())


@settings(max_examples=80, deadline=None)
@given(my_round=st.integers(min_value=0, max_value=50),
       clock=st.integers(min_value=0, max_value=60),
       staleness=st.integers(min_value=0, max_value=5))
def test_ssp_read_round_equals_the_reference(my_round, clock, staleness):
    try:
        want = jcoll.ssp_read_round(my_round, clock, staleness)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            tcoll.ssp_read_round(my_round, clock, staleness)
        assert str(err.value) == str(e)
        return
    assert tcoll.ssp_read_round(my_round, clock, staleness) == want


def test_sync_policy_equals_the_reference():
    for v in (None, 0, 3):
        t, j = tcoll.SyncPolicy.parse(v), jcoll.SyncPolicy.parse(v)
        assert (t.staleness, t.elastic, t.mode) == (j.staleness, j.elastic, j.mode)
    p = tcoll.SyncPolicy(staleness=2, elastic=True)
    assert tcoll.SyncPolicy.parse(p) is p and p.mode == "ssp"
    with pytest.raises(ValueError):
        tcoll.SyncPolicy(staleness=-1)
    with pytest.raises(ValueError, match="every worker needs"):
        tcoll.ssp_trace([[1, 2], [1]], 0)


@settings(max_examples=40, deadline=None)
@given(per=st.integers(min_value=1, max_value=8),
       old=st.integers(min_value=1, max_value=8),
       new=st.integers(min_value=1, max_value=8))
def test_plan_resize_equals_the_reference(per, old, new):
    rows = per * old * new
    t, j = tpt.plan_resize(rows, old, new), jpt.plan_resize(rows, old, new)
    assert (t.old_rows_per_shard, t.new_rows_per_shard, t.moved_rows) == \
        (j.old_rows_per_shard, j.new_rows_per_shard, j.moved_rows)
    assert t.describe() == j.describe()
    for r in (0, rows - 1, rows // 2):
        assert t.owner(r, new=False) == j.owner(r, new=False)
        assert t.owner(r) == j.owner(r)


@pytest.mark.parametrize("args", [(10, 2, 3), (10, 3, 2), (10, 0, 2)])
def test_plan_resize_rejects_as_the_reference(args):
    with pytest.raises(ValueError) as jerr:
        jpt.plan_resize(*args)
    with pytest.raises(ValueError) as terr:
        tpt.plan_resize(*args)
    assert str(terr.value) == str(jerr.value)
