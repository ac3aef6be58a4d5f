"""The port's data tier and emulated runner against the JAX reference, plus
the package rule that the port imports neither JAX nor the reference (the
card-by-default rule is tested in ``tests/test_torch_cuda.py``).

Same seeded numpy inputs go through ``repro`` (JAX, CPU) and
``repro_torch`` (``device="cpu"``).  Tolerance: fp32 rtol = atol = 2e-4
(``tests/test_kernels.py``'s).
"""
import ast
import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import partition as jpt
from repro.core.collectives import CollectiveSchedule as JSchedule
from repro.core.numeric_table import MLNumericTable as JTable
from repro.core.runner import DistributedRunner as JRunner
from repro_torch.core import partition as tpt
from repro_torch.core.collectives import CollectiveSchedule as TSchedule
from repro_torch.core.numeric_table import MLNumericTable as TTable
from repro_torch.core.runner import DistributedRunner as TRunner
from repro_torch.data import synthetic as tsyn
from repro.data import synthetic as jsyn

REPO = pathlib.Path(__file__).resolve().parents[1]
SCHEDULES = ["allreduce", "gather_broadcast", "reduce_scatter"]
TOL = dict(rtol=2e-4, atol=2e-4)


def _data(n=48, d=6, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


# --------------------------------------------------------------------------- #
# package rules
# --------------------------------------------------------------------------- #
def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


# --------------------------------------------------------------------------- #
# data tier
# --------------------------------------------------------------------------- #
def test_synthetic_copies_equal_the_reference():
    for t, j in [(tsyn.synth_classification(40, 7, seed=3),
                  jsyn.synth_classification(40, 7, seed=3)),
                 (tsyn.synth_imagenet_features(30, 16, seed=2),
                  jsyn.synth_imagenet_features(30, 16, seed=2))]:
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bad", ["bogus", "all_reduce", 3])
def test_schedule_parse_errors_match_reference(bad):
    with pytest.raises(ValueError) as t_err:
        TSchedule.parse(bad)
    with pytest.raises(ValueError) as j_err:
        JSchedule.parse(bad)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("name", SCHEDULES + ["ALLREDUCE"])
def test_schedule_parse_accepts_reference_values(name):
    assert TSchedule.parse(name).value == JSchedule.parse(name).value
    assert TSchedule.parse(TSchedule.parse(name)) is TSchedule.parse(name)


def test_partition_round_trip_and_errors_match_reference():
    x = _data(24, 5)
    blocks = tpt.partition_rows(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(
        blocks.numpy(), np.asarray(jpt.partition_rows(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(tpt.unpartition_rows(blocks).numpy(), x)
    with pytest.raises(ValueError) as t_err:
        tpt.check_rows_divisible(10, 4, what="stream partitions")
    with pytest.raises(ValueError) as j_err:
        jpt.check_rows_divisible(10, 4, what="stream partitions")
    assert str(t_err.value) == str(j_err.value)


def test_partition_of_a_column_slice_is_a_view():
    table = torch.zeros(12, 5)
    blocks = tpt.partition_rows(table[:, 1:], 3)
    assert blocks.shape == (3, 4, 4) and blocks.data_ptr() == table[:, 1:].data_ptr()


def test_numeric_table_accessors_match_reference():
    x = _data(48, 6).astype(np.float64)          # float64 arrives as float32
    t = TTable.from_numpy(x, num_shards=4, device="cpu")
    j = JTable.from_numpy(x, num_shards=4)
    for attr in ("num_rows", "num_cols", "num_shards", "rows_per_shard",
                 "numRows", "numCols"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.data.dtype == torch.float32
    np.testing.assert_array_equal(t.to_numpy(), j.to_numpy())
    wrapped = TTable(t.data, num_shards=2)          # no copy
    assert wrapped.data is t.data and wrapped.rows_per_shard == 24
    with pytest.raises(ValueError, match="must divide evenly"):
        TTable.from_numpy(_data(10, 3), num_shards=4, device="cpu")
    with pytest.raises(ValueError, match="2-D"):
        TTable(torch.zeros(4))


# --------------------------------------------------------------------------- #
# runner: emulated rounds under every schedule
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_run_rounds_matches_reference(combine, schedule):
    """A state-dependent local step and update over 3 rounds from a nonzero
    start round: the port's stacked step equals the reference's per-block
    step under vmap."""
    x = _data(48, 6, seed=1)
    w0 = np.linspace(-1, 1, 6).astype(np.float32)

    def j_step(block, w, r):
        return jnp.mean(jnp.tanh(block * w), axis=0) * (r + 1)

    def t_step(blocks, w, r):
        return torch.mean(torch.tanh(blocks * w), dim=1) * (r + 1)

    def j_update(w, c, r):
        return 0.5 * w + 0.1 * c

    def t_update(w, c, r):
        return 0.5 * w + 0.1 * c

    jr = JRunner(num_shards=4, schedule=schedule)
    tr = TRunner(num_shards=4, schedule=schedule)
    want = jr.run_rounds(JTable.from_numpy(x, num_shards=4), jnp.asarray(w0),
                         j_step, 3, combine=combine, update=j_update,
                         start_round=2)
    got = tr.run_rounds(TTable.from_numpy(x, num_shards=4, device="cpu"),
                        torch.from_numpy(w0), t_step, 3, combine=combine,
                        update=t_update, start_round=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # without an update the combined value is the next state
    want = jr.run_rounds(JTable.from_numpy(x, num_shards=4), jnp.asarray(w0),
                         j_step, 2, combine=combine)
    got = tr.run_rounds(TTable.from_numpy(x, num_shards=4, device="cpu"),
                        torch.from_numpy(w0), t_step, 2, combine=combine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("combine", [None, "mean", "sum", "concat"])
def test_partition_apply_and_run_once_match_reference(combine):
    x = _data(32, 5, seed=2)
    b = np.arange(5, dtype=np.float32)
    want = JRunner(num_shards=4).partition_apply(
        jnp.asarray(x), lambda blk, v: blk * v + 1.0, (jnp.asarray(b),), combine)
    got = TRunner(num_shards=4).partition_apply(
        torch.from_numpy(x), lambda blks, v: blks * v + 1.0,
        (torch.from_numpy(b),), combine)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if combine in ("mean", "sum"):
        tt = TTable.from_numpy(x, num_shards=4, device="cpu")
        jt = JTable.from_numpy(x, num_shards=4)
        np.testing.assert_allclose(
            TRunner.for_table(tt).run_once(tt, lambda blks: blks.sum(1),
                                           combine=combine).numpy(),
            np.asarray(JRunner.for_table(jt).run_once(
                jt, lambda blk: blk.sum(0), combine=combine)), **TOL)


def test_runner_rejects_bad_combine_and_shards():
    with pytest.raises(ValueError, match="unknown combine"):
        TRunner(num_shards=2).partition_apply(torch.zeros(4, 2),
                                              lambda b: b, (), "max")
    with pytest.raises(ValueError, match="num_shards"):
        TRunner(num_shards=0)
    with pytest.raises(ValueError, match="is not a valid CollectiveSchedule"):
        TRunner(schedule="ring")
