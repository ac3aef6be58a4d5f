"""Asynchronous successive halving in the port against the reference.

The scheduler is pure host state, so its traces are compared step for
step with the reference's: the same admissions, ticks, reports and
decisions, and the same ``state_dict`` after every step, over seeded
random score traces.  The search driver runs the reference in emulated
mode (its mesh path is broken on the installed jax) on the same seeded
numpy table; the port runs on the CPU.  Tolerances: 1e-5 on scores and
weights against the reference (``tests/test_tune.py``'s); the port's
stacked and sequential executions are compared bit for bit, since a lane
runs its trial's launches alone.
"""
import random

import numpy as np
import pytest
import torch

from repro.core.numeric_table import MLNumericTable as RefTable
from repro.tune import AshaScheduler as RefSched
from repro.tune import AsyncSuccessiveHalving as RefASHA
from repro.tune import ModelSearch as RefSearch
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.tune import (AshaScheduler, AsyncSuccessiveHalving,
                              ModelSearch, early_stopping, grid)

TOL = 1e-5


def _pair(n, epochs, slots, rf=3, min_rounds=1, budget=None):
    kw = dict(reduction_factor=rf, min_rounds=min_rounds, slots=slots,
              epoch_budget=budget)
    return (AshaScheduler(AsyncSuccessiveHalving(**kw), n, epochs, slots),
            RefSched(RefASHA(**kw), n, epochs, slots))


# --------------------------------------------------------------------------- #
# the scheduler, step for step
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("epochs,rf,min_rounds", [
    (1, 2, 1), (9, 3, 1), (10, 3, 1), (12, 2, 3), (27, 3, 1), (5, 4, 2)])
def test_rung_ladder_equals_reference(epochs, rf, min_rounds):
    assert (AsyncSuccessiveHalving(rf, min_rounds).rung_epochs(epochs)
            == RefASHA(rf, min_rounds).rung_epochs(epochs))


@pytest.mark.parametrize("rf", [2, 3, 4])
def test_promotion_equals_reference(rf):
    rng = np.random.default_rng(rf)
    ours, ref = AsyncSuccessiveHalving(rf), RefASHA(rf)
    for n in range(1, 12):
        scores = list(rng.random(n))
        for s in scores:
            assert ours.promote(s, scores) == ref.promote(s, scores)


@pytest.mark.parametrize("n,slots,epochs,rf,budget,seed", [
    (6, 2, 9, 3, None, 0), (12, 4, 9, 3, None, 1), (7, 3, 12, 2, None, 2),
    (1, 1, 4, 2, None, 3), (10, 4, 8, 2, 20, 4), (9, 2, 27, 3, 30, 5),
    (5, 8, 9, 3, None, 6), (12, 1, 5, 4, 7, 7)])
def test_scheduler_trace_equals_reference(n, slots, epochs, rf, budget, seed):
    """Drive both schedulers with the same seeded random scores: every
    admission, tick, due list and decision, and the state dict after every
    step, equal the reference's."""
    ours, ref = _pair(n, epochs, slots, rf=rf, budget=budget)
    rng = random.Random(seed)
    guard = 0
    while not ref.finished():
        guard += 1
        assert guard < 10_000
        assert ours.finished() is False
        assert ours.admit() == ref.admit()
        if not ref.occupied():
            assert not ours.occupied()
            break
        assert ours.tick_size() == ref.tick_size()
        delta = ref.tick_size()
        ours.advance(delta)
        ref.advance(delta)
        assert ours.due() == ref.due()
        for _, t in ref.due():
            score = rng.random()
            assert ours.report(t, score) == ref.report(t, score)
        assert ours.state_dict() == ref.state_dict()
    assert ours.finished()
    assert ours.terminal == ref.terminal


def test_state_dict_crosses_packages_mid_rung():
    """A reference scheduler's state dict restores a port scheduler (and
    back), and both then continue identically."""
    ours, ref = _pair(6, 9, 2)
    rng = random.Random(0)
    for _ in range(3):
        ref.admit()
        ref.advance(ref.tick_size())
        for _, t in ref.due():
            ref.report(t, rng.random())
    port = AshaScheduler.from_state_dict(AsyncSuccessiveHalving(slots=2), 9,
                                         ref.state_dict())
    back = RefSched.from_state_dict(RefASHA(slots=2), 9, port.state_dict())
    assert port.state_dict() == ref.state_dict() == back.state_dict()
    with pytest.raises(ValueError, match="rung ladder"):
        AshaScheduler.from_state_dict(AsyncSuccessiveHalving(slots=2), 27,
                                      ref.state_dict())


@pytest.mark.parametrize("kw", [dict(reduction_factor=1), dict(min_rounds=0),
                                dict(slots=0)])
def test_rule_validates_parameters(kw):
    with pytest.raises(ValueError):
        AsyncSuccessiveHalving(**kw)


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #
ROWS, D = 192, 4
CONFIGS = grid({"learning_rate": [0.02, 0.1, 0.5, 1.0], "l2": [0.0, 0.01]})


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    w = rng.normal(size=D)
    X = rng.normal(size=(ROWS, D)).astype(np.float32)
    y = (X @ w > 0).astype(np.float32)
    return np.column_stack([y, X]).astype(np.float32)


def _kw(slots=4, budget=None, epochs=9, chunks=2):
    return dict(num_epochs=epochs, chunks_per_epoch=chunks, seed=0)


def port(data, execution="auto", slots=4, budget=None, ckpt=None, cb=None,
         callbacks=(), shards=2, configs=CONFIGS):
    return ModelSearch(
        algorithm="logreg", configs=configs, execution=execution,
        early_stop=AsyncSuccessiveHalving(reduction_factor=3, min_rounds=1,
                                          slots=slots, epoch_budget=budget),
        callbacks=callbacks, ckpt_dir=ckpt, unit_callback=cb, **_kw()
    ).run(MLNumericTable.from_numpy(data, num_shards=shards, device="cpu"))


def reference(data, execution="auto", slots=4, budget=None, shards=2,
              configs=CONFIGS):
    return RefSearch(
        algorithm="logreg", configs=configs, execution=execution,
        early_stop=RefASHA(reduction_factor=3, min_rounds=1, slots=slots,
                           epoch_budget=budget), **_kw()
    ).run(RefTable.from_numpy(data, num_shards=shards))


def _decisions(res):
    return [(t.index, len(t.rung_scores), t.stopped) for t in res.trials]


def _same_as_reference(got, want):
    assert _decisions(got) == _decisions(want)
    for a, b in zip(got.trials, want.trials):
        np.testing.assert_allclose(a.rung_scores, b.rung_scores, atol=TOL)
        np.testing.assert_allclose(a.state.numpy(), np.asarray(b.state),
                                   atol=TOL)
    assert got.best.index == want.best.index


@pytest.mark.parametrize("execution", ["auto", "sequential"])
@pytest.mark.parametrize("slots,budget", [(4, None), (3, None), (4, 12)])
def test_asha_search_matches_reference(data, execution, slots, budget):
    _same_as_reference(port(data, execution, slots, budget),
                       reference(data, execution, slots, budget))


@pytest.mark.parametrize("slots", [2, 4, 8])
def test_asha_stacked_equals_sequential_bitwise(data, slots):
    a, b = port(data, "stacked", slots), port(data, "sequential", slots)
    assert _decisions(a) == _decisions(b)
    for ta, tb in zip(a.trials, b.trials):
        assert ta.rung_scores == tb.rung_scores
        assert torch.equal(ta.state, tb.state)
    finished = [t for t in a.trials if not t.stopped]
    assert finished and all(len(t.rung_scores) == 3 for t in finished)


def test_asha_on_sampled_configs_matches_reference(data):
    from repro.tune import sample as ref_sample
    from repro_torch.tune import sample

    space = {"learning_rate": ("loguniform", 0.01, 1.0), "l2": [0.0, 0.01]}
    configs = sample(space, 12, seed=0)
    assert configs == ref_sample(space, 12, seed=0)
    _same_as_reference(port(data, configs=configs),
                       reference(data, configs=configs))


@pytest.mark.parametrize("execution", ["auto", "sequential"])
def test_asha_resume_is_rung_for_rung(data, tmp_path, execution):
    """Interrupt at every decision batch in turn; each resume reproduces
    the uninterrupted search bit for bit."""
    full = port(data, execution)

    class Kill(Exception):
        pass

    kill_at = 1
    while True:
        ckpt = str(tmp_path / f"k{kill_at}")
        calls = {"n": 0}

        def killer(done, newly):
            calls["n"] += 1
            if calls["n"] == kill_at:
                raise Kill()

        try:
            port(data, execution, ckpt=ckpt, cb=killer)
            break
        except Kill:
            pass
        res = ModelSearch(
            algorithm="logreg", configs=CONFIGS, execution=execution,
            early_stop=AsyncSuccessiveHalving(reduction_factor=3, min_rounds=1,
                                              slots=4),
            ckpt_dir=ckpt, **_kw()
        ).run(MLNumericTable.from_numpy(data, num_shards=2, device="cpu"),
              resume=True)
        assert _decisions(res) == _decisions(full)
        for a, b in zip(full.trials, res.trials):
            assert a.rung_scores == b.rung_scores
            assert torch.equal(a.state, b.state)
        kill_at += 1
    assert kill_at > 2


def test_asha_early_stop_callback_drains(data):
    res = port(data, callbacks=(early_stopping(1),))
    assert 0 < len(res.trials) <= len(CONFIGS)
    assert all(t.rung_scores for t in res.trials)


def test_asha_rejects_pipeline_search(data):
    from repro_torch.features import Standardizer
    from repro_torch.pipeline import Pipeline

    ms = ModelSearch(algorithm=Pipeline([Standardizer()], device="cpu"),
                     configs=CONFIGS, early_stop=AsyncSuccessiveHalving())
    with pytest.raises(NotImplementedError, match="ASHA"):
        ms.run(MLNumericTable.from_numpy(data, device="cpu"))


def test_asha_fingerprint_equals_reference_and_separates_rules(data):
    ours = ModelSearch(algorithm="logreg", configs=CONFIGS,
                       early_stop=AsyncSuccessiveHalving(slots=4), **_kw())
    ref = RefSearch(algorithm="logreg", configs=CONFIGS,
                    early_stop=RefASHA(slots=4), **_kw())
    table = MLNumericTable.from_numpy(data, device="cpu")
    assert ours._fingerprint(table) == ref._fingerprint(RefTable.from_numpy(data))
    med = ModelSearch(algorithm="logreg", configs=CONFIGS, **_kw())
    assert med._fingerprint(table) != ours._fingerprint(table)
