"""The callback protocol and the stacked runner in the port, against the
reference.

The same callbacks are fired by the reference's runner (emulated
partitions, JAX on the CPU) and the port's (``device="cpu"``) on the same
seeded numpy windows: the hook order, every env's counters and evals, the
swaps, the early stop with its tail checkpoint, and the states they leave,
at 1e-5 (the reference's tolerance in ``tests/test_tune.py``).  The
stacked entry points are held against the reference's vmapped ones at
1e-5 — with round offsets and a frozen lane — and against the port's own
K = 1 runs bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.runner import CheckpointPolicy as RefPolicy
from repro.core.runner import DistributedRunner as RefRunner
from repro.data import BatchIterator as RefStream
from repro.eval.metrics import MetricHistory as RefHistory
from repro.tune import callback as rcb
from repro.tune.trials import tree_stack as ref_stack
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import CheckpointPolicy, DistributedRunner
from repro_torch.data import BatchIterator
from repro_torch.eval.metrics import MetricHistory
from repro_torch.tune import callback as pcb
from repro_torch.tune.trials import tree_stack, tree_unstack

TOL = 1e-5


@pytest.fixture
def X():
    return np.random.default_rng(3).normal(size=(8, 3)).astype(np.float32)


def _streams(X, start=0):
    return (BatchIterator(lambda step: {"data": X}, device="cpu", start_step=start),
            RefStream(lambda step: {"data": X}, start_step=start))


def _steps():
    """The same accumulating round in both packages' local-step forms."""
    return (lambda b, s, r: s + b.mean(1),
            lambda b, s, r: s + jnp.mean(b, 0))


def _log(cbmod, into, name, before=False, order=10, swap=None):
    def cb(env):
        into.append((name, env.epoch, env.begin_epoch, env.end_epoch,
                     env.round, tuple((e.trial, e.metric, round(e.value, 5))
                                      for e in env.evals)))
        return swap(env) if swap else None
    cb.before_epoch = before
    cb.order = order
    return cb


def _both(X, epochs, make_cbs, eval_pair=None, start=0, ckpts=(None, None)):
    """Run both runners with callbacks from ``make_cbs(cbmod, log, zeros)``;
    returns (port state, ref state, port log, ref log)."""
    ps, rs = _steps()
    (pstream, rstream), out = _streams(X, start), []
    for mod, runner, stream, step, zeros, ev, ck in (
            (pcb, DistributedRunner(num_shards=2), pstream, ps,
             lambda: torch.zeros(3), eval_pair and eval_pair[0], ckpts[0]),
            (rcb, RefRunner(num_shards=2), rstream, rs,
             lambda: jnp.zeros(3), eval_pair and eval_pair[1], ckpts[1])):
        log = []
        state = runner.run_epochs(stream, zeros(), step, epochs,
                                  callbacks=make_cbs(mod, log, zeros),
                                  eval_fn=ev, start_epoch=start, checkpoint=ck)
        out.append((state, log))
    (p, plog), (r, rlog) = out
    return p, r, plog, rlog


# --------------------------------------------------------------------------- #
# dispatch
# --------------------------------------------------------------------------- #
def _named(order, before, name):
    def cb(env):
        return None
    cb.order, cb.before_epoch, cb.__name__ = order, before, name
    return cb


@pytest.mark.parametrize("spec", [
    [(10, False, "a"), (5, True, "b"), (0, False, "c"), (30, True, "d")],
    [(10, False, "a"), (10, False, "b"), (10, True, "c"), (10, True, "d")],
    [(20, False, "rec"), (30, False, "stop"), (0, True, "sched")]])
def test_split_callbacks_equals_reference(spec):
    cbs = [_named(*s) for s in spec]
    names = lambda groups: [[c.__name__ for c in g] for g in groups]  # noqa: E731
    assert names(pcb.split_callbacks(cbs)) == names(rcb.split_callbacks(cbs))


def test_fire_folds_swaps_like_the_reference():
    seen = {"port": [], "ref": []}

    def make(mod, key):
        def first(env):
            seen[key].append(env.hyper)
            return {"hyper": {"lr": 2}}

        def second(env):
            seen[key].append(env.hyper)
            return {"state": 7}
        return first, second

    outs = [mod.fire_callbacks(make(mod, key), mod.CallbackEnv(epoch=0, hyper={"lr": 1}))
            for mod, key in ((pcb, "port"), (rcb, "ref"))]
    assert outs[0] == outs[1] == {"hyper": {"lr": 2}, "state": 7}
    assert seen["port"] == seen["ref"] == [{"lr": 1}, {"lr": 2}]
    for mod in (pcb, rcb):
        with pytest.raises(ValueError, match="unknown carry keys"):
            mod.fire_callbacks([lambda env: {"bogus": 1}], mod.CallbackEnv(epoch=0))


@pytest.mark.parametrize("rounds,min_delta,values", [
    (2, 0.0, [0.1, 0.2, 0.2, 0.2, 0.3]),
    (1, 0.05, [0.1, 0.12, 0.2, 0.21]),
    (3, 0.0, [0.5, 0.4, 0.45, 0.44, 0.43, 0.6])])
@pytest.mark.parametrize("higher", [True, False])
def test_early_stopping_equals_reference(rounds, min_delta, values, higher):
    """The same eval sequences stop both packages' early_stopping at the
    same hook point with the same best values."""
    stops = []
    for mod in (pcb, rcb):
        cb = mod.early_stopping(rounds, min_delta)
        at = None
        for i, v in enumerate(values):
            env = mod.CallbackEnv(epoch=i + 1, evals=(
                mod.EvalEntry(0, "m", v, higher), mod.EvalEntry(1, "m", v / 2, higher)))
            try:
                cb(env)
            except mod.EarlyStopException as exc:
                at = exc.epoch
                break
        stops.append((at, dict(cb.best)))
    assert stops[0] == stops[1]


def test_record_evaluation_and_hyper_schedule_equal_reference():
    hists = []
    for mod, H in ((pcb, MetricHistory), (rcb, RefHistory)):
        h = H()
        cb = mod.record_evaluation(h)
        for epoch in (1, 2, 2, 3):   # a replayed boundary overwrites
            cb(mod.CallbackEnv(epoch=epoch, evals=(mod.EvalEntry(4, "acc", epoch / 10),)))
        hists.append(h.to_dict())
        with pytest.raises(TypeError):
            mod.record_evaluation(object())
    assert hists[0] == hists[1]

    sched = pcb.hyper_schedule("lr", lambda e: 0.5 ** e)
    out = sched(pcb.CallbackEnv(epoch=3, hyper={"lr": torch.ones(4), "l2": torch.zeros(4)}))
    ref = rcb.hyper_schedule("lr", lambda e: 0.5 ** e)(
        rcb.CallbackEnv(epoch=3, hyper={"lr": jnp.ones(4), "l2": jnp.zeros(4)}))
    np.testing.assert_array_equal(out["hyper"]["lr"].numpy(), np.asarray(ref["hyper"]["lr"]))
    assert out["hyper"]["lr"].dtype == torch.float32
    assert sched(pcb.CallbackEnv(epoch=0)) is None
    with pytest.raises(KeyError):
        sched(pcb.CallbackEnv(epoch=0, hyper={"l2": torch.zeros(2)}))
    assert (sched.order, sched.before_epoch) == (0, True)


# --------------------------------------------------------------------------- #
# run_epochs' hook points
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("epochs,start", [(3, 0), (5, 2)])
def test_run_epochs_firing_order_and_counters_equal_reference(X, epochs, start):
    def cbs(mod, log, zeros):
        return [_log(mod, log, "after-obs", order=20),
                _log(mod, log, "before", before=True),
                _log(mod, log, "after", order=10)]
    p, r, plog, rlog = _both(X, epochs, cbs, start=start)
    assert plog == rlog
    assert plog[0][0] == "before" and plog[1][0] == "after"
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=TOL)


def test_run_epochs_eval_fn_feeds_callbacks_as_in_the_reference(X):
    hists = []

    def cbs(mod, log, zeros):
        h = MetricHistory() if mod is pcb else RefHistory()
        hists.append(h)
        return [mod.record_evaluation(h), _log(mod, log, "obs", order=25)]
    evals = (lambda s, e: [pcb.EvalEntry(0, "norm", float((s ** 2).sum()))],
             lambda s, e: [rcb.EvalEntry(0, "norm", float(jnp.sum(s ** 2)))])
    _, _, plog, rlog = _both(X, 3, cbs, eval_pair=evals)
    assert plog == rlog
    (p_hist, r_hist) = hists
    assert [e for e, _ in p_hist.series(0, "norm")] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in p_hist.series(0, "norm")],
                               [v for _, v in r_hist.series(0, "norm")], rtol=TOL)


def test_run_epochs_early_stop_tail_checkpoint_equals_reference(X, tmp_path):
    from repro.checkpoint import latest_step as ref_latest
    from repro_torch.checkpoint import latest_step, load_metadata

    def cbs(mod, log, zeros):
        def stop(env):
            if env.epoch >= 2:
                raise mod.EarlyStopException(env.epoch, "test stop")
        return [stop]
    pd, rd = str(tmp_path / "p"), str(tmp_path / "r")
    p, r, _, _ = _both(X, 10, cbs, ckpts=(CheckpointPolicy(pd, every_epochs=100),
                                          RefPolicy(rd, every_epochs=100)))
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=TOL)
    assert latest_step(pd) == ref_latest(rd) == 2
    assert load_metadata(pd)["epoch"] == 2
    # the port's run stopped at epoch 2 equals its own 2-epoch run
    ps, _ = _steps()
    want = DistributedRunner(num_shards=2).run_epochs(_streams(X)[0], torch.zeros(3), ps, 2)
    assert torch.equal(p, want)


def test_run_epochs_plateau_stops_at_the_references_epoch(X):
    fired = {"port": [], "ref": []}

    def evals(mod, key):
        def ev(state, epoch):
            fired[key].append(epoch)
            return [mod.EvalEntry(0, "score", float(min(epoch, 2)))]
        return ev
    _both(X, 10, lambda mod, log, zeros: [mod.early_stopping(2)],
          eval_pair=(evals(pcb, "port"), evals(rcb, "ref")))
    assert fired["port"] == fired["ref"] == [1, 2, 3, 4]


def test_run_epochs_state_swap_changes_the_carry_as_in_the_reference(X):
    def cbs(mod, log, zeros):
        def reset(env):
            if env.epoch == 2:
                return {"state": zeros()}
        return [reset]
    p, r, _, _ = _both(X, 4, cbs)
    np.testing.assert_allclose(p.numpy(), np.asarray(r), atol=TOL)
    ps, _ = _steps()
    want = DistributedRunner(num_shards=2).run_epochs(
        _streams(X, start=2)[0], torch.zeros(3), ps, 4, start_epoch=2)
    assert torch.equal(p, want)


def test_run_epochs_refuses_a_hyper_swap(X):
    ps, _ = _steps()
    with pytest.raises(ValueError, match="hyper"):
        DistributedRunner(num_shards=2).run_epochs(
            _streams(X)[0], torch.zeros(3), ps, 2,
            callbacks=[lambda env: {"hyper": {"lr": 0.0}}])


# --------------------------------------------------------------------------- #
# the stacked entry points
# --------------------------------------------------------------------------- #
def _trial_fns():
    """One logistic-regression step a round, in both packages' forms."""
    def port_step(blocks, w, r, h):
        X, y = blocks[..., 1:], blocks[..., 0]
        z = torch.sigmoid(X @ w) - y
        g = (X * z.unsqueeze(-1)).sum(1) / X.shape[1]
        return w - h["lr"] * h["decay"] ** r * g

    def ref_step(block, w, r, h):
        import jax
        X, y = block[:, 1:], block[:, 0]
        g = X.T @ (jax.nn.sigmoid(X @ w) - y) / X.shape[0]
        return w - h["lr"] * h["decay"] ** r * g
    return port_step, ref_step


@pytest.fixture(scope="module")
def clf():
    rng = np.random.default_rng(11)
    Xf = rng.normal(size=(64, 5)).astype(np.float32)
    y = (Xf @ np.linspace(-1, 1, 5) > 0).astype(np.float32)
    return np.concatenate([y[:, None], Xf], 1)


LRS, DECAYS = [0.05, 0.2, 0.4, 0.8], [1.0, 0.9, 0.95, 1.0]


def _hypers():
    return (tree_stack([{"lr": torch.tensor(a), "decay": torch.tensor(b)}
                        for a, b in zip(LRS, DECAYS)]),
            ref_stack([{"lr": jnp.float32(a), "decay": jnp.float32(b)}
                       for a, b in zip(LRS, DECAYS)]))


@pytest.mark.parametrize("active", [None, [True, False, True, True]])
def test_run_stacked_rounds_matches_reference(clf, active):
    from repro.core.numeric_table import MLNumericTable as RefTable

    ps, rs = _trial_fns()
    ph, rh = _hypers()
    d = clf.shape[1] - 1
    got = DistributedRunner(num_shards=4).run_stacked_rounds(
        MLNumericTable.from_numpy(clf, num_shards=4, device="cpu"),
        torch.zeros((4, d)), ph, ps, 6, active=active, start_round=1)
    want = RefRunner(num_shards=4).run_stacked_rounds(
        RefTable.from_numpy(clf, num_shards=4), jnp.zeros((4, d)), rh, rs, 6,
        active=None if active is None else jnp.asarray(active), start_round=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    if active is not None:
        assert torch.equal(got[1], torch.zeros(d))   # the frozen lane


@pytest.mark.parametrize("chunks,offsets,active", [
    (1, None, None),
    (2, [0, 2, 4, 0], [True, True, False, True]),
    (2, [2, 0, 0, 6], None)])
def test_run_stacked_epochs_matches_reference(clf, chunks, offsets, active):
    ps, rs = _trial_fns()
    ph, rh = _hypers()
    d = clf.shape[1] - 1
    init = np.random.default_rng(1).normal(size=(4, d)).astype(np.float32)
    pstream, rstream = _streams(clf)
    got = DistributedRunner(num_shards=2).run_stacked_epochs(
        pstream, torch.tensor(init), ph, ps, 5, chunks_per_epoch=chunks,
        start_epoch=1, round_offsets=offsets, active=active)
    want = RefRunner(num_shards=2).run_stacked_epochs(
        rstream, jnp.asarray(init), rh, rs, 5, chunks_per_epoch=chunks,
        start_epoch=1, active=None if active is None else jnp.asarray(active),
        round_offsets=None if offsets is None else jnp.asarray(offsets, jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    if active is not None:
        assert torch.equal(got[2], torch.tensor(init[2]))


def test_a_lane_is_its_trial_run_alone_bit_for_bit(clf):
    """Every lane of a K = 4 stack (offsets, a frozen lane) equals the same
    trial in a K = 1 run, bit for bit."""
    ps, _ = _trial_fns()
    ph, _ = _hypers()
    d = clf.shape[1] - 1
    init = torch.tensor(np.random.default_rng(2).normal(size=(4, d)).astype(np.float32))
    offsets, active = [0, 2, 4, 2], [True, True, False, True]
    runner = DistributedRunner(num_shards=2)
    stacked = runner.run_stacked_epochs(
        _streams(clf)[0], init, ph, ps, 4, chunks_per_epoch=2,
        round_offsets=offsets, active=active)
    for j, h in enumerate(tree_unstack(ph)):
        alone = runner.run_stacked_epochs(
            _streams(clf)[0], init[j:j + 1], tree_stack([h]), ps, 4,
            chunks_per_epoch=2, round_offsets=[offsets[j]], active=[active[j]])
        assert torch.equal(stacked[j], alone[0])
    assert torch.equal(stacked[2], init[2])
    assert not torch.equal(stacked[0], init[0])


def test_stacked_hyper_schedule_steers_all_lanes_as_in_the_reference(X):
    def pstep(blocks, s, r, h):
        return h["lr"] * blocks.mean(1) + 0 * s

    def rstep(block, s, r, h):
        return h["lr"] * jnp.mean(block, 0) + 0 * s

    outs = []
    for mod, runner, stream, step, stack, zeros, ones, f32 in (
            (pcb, DistributedRunner(num_shards=2), _streams(X)[0], pstep, tree_stack,
             torch.zeros, torch.ones, lambda v: torch.tensor(v)),
            (rcb, RefRunner(num_shards=2), _streams(X)[1], rstep, ref_stack,
             jnp.zeros, jnp.ones, jnp.float32)):
        init = stack([zeros(3), ones(3)])
        hyper = stack([{"lr": f32(1.0)}, {"lr": f32(2.0)}])
        half = runner.run_stacked_epochs(
            stream, init, hyper, step, 3, update=lambda s, c, r, h: s + c,
            callbacks=[mod.hyper_schedule("lr", lambda e: 0.5 * e)])
        outs.append(np.asarray(half))
    np.testing.assert_allclose(outs[0], outs[1], atol=TOL)


def test_stacked_callbacks_see_the_active_mask_and_stop_as_in_the_reference(X):
    seen = {"port": [], "ref": []}

    def watch(mod, key):
        def cb(env):
            seen[key].append((env.epoch, tuple(bool(a) for a in env.active),
                              tuple(np.asarray(env.state).shape)))
            if env.epoch == 2:
                raise mod.EarlyStopException(env.epoch, "enough")
        return cb
    DistributedRunner(num_shards=2).run_stacked_epochs(
        _streams(X)[0], tree_stack([torch.zeros(3), torch.ones(3)]),
        tree_stack([{"lr": torch.tensor(1.0)}] * 2),
        lambda b, s, r, h: h["lr"] * b.mean(1) + 0 * s, 5,
        update=lambda s, c, r, h: s + c, active=[True, False],
        callbacks=[watch(pcb, "port")])
    RefRunner(num_shards=2).run_stacked_epochs(
        _streams(X)[1], ref_stack([jnp.zeros(3), jnp.ones(3)]),
        ref_stack([{"lr": jnp.float32(1.0)}] * 2),
        lambda b, s, r, h: h["lr"] * jnp.mean(b, 0) + 0 * s, 5,
        update=lambda s, c, r, h: s + c, active=jnp.asarray([True, False]),
        callbacks=[watch(rcb, "ref")])
    assert seen["port"] == seen["ref"] == [(1, (True, False), (2, 3)),
                                           (2, (True, False), (2, 3))]


def test_stacked_inputs_are_not_changed(clf):
    ps, _ = _trial_fns()
    ph, _ = _hypers()
    init = torch.zeros((4, clf.shape[1] - 1))
    DistributedRunner(num_shards=2).run_stacked_epochs(_streams(clf)[0], init, ph, ps, 2)
    assert torch.equal(init, torch.zeros_like(init))


def test_stacked_carry_validates_shapes():
    with pytest.raises(ValueError, match="leading trial axis"):
        DistributedRunner._stacked_carry({"a": torch.zeros((3, 2)), "b": torch.zeros((2,))}, {})
    with pytest.raises(ValueError, match="round offsets"):
        DistributedRunner._stacked_carry(torch.zeros((3, 2)), {}, offsets=[0, 1])
