"""The port's tables against the JAX reference: ``Schema``, ``MLRow``, every
``MLTable`` operation (and its commit to the numeric tier), ``LocalMatrix``,
and the numeric table's ``map_rows`` / ``filter_mask`` / ``reduce`` /
``matrix_batch_map`` / ``sum_rows`` / ``mean_rows``.

The same seeded numpy inputs go to ``repro`` and to ``repro_torch``
(``device="cpu"``).  Host-tier results (rows, schemas, partitions) are
compared exactly; device-tier results at fp32 rtol = atol = 1e-5 (one
order of fp32 sums either side), and bitwise where both sides run the same
elementwise or tree-ordered operations; eigenvectors and singular vectors
up to sign, through the products they reconstruct.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.local_matrix import LocalMatrix as JLocal
from repro.core.mltable import MLTable as JTable
from repro.core.numeric_table import MLNumericTable as JNumeric
from repro.core.schema import EMPTY as JEMPTY
from repro.core.schema import ColumnType as JType
from repro.core.schema import MLRow as JRow
from repro.core.schema import Schema as JSchema
from repro_torch.core.local_matrix import LocalMatrix as TLocal
from repro_torch.core.mltable import MLTable as TTable
from repro_torch.core.numeric_table import MLNumericTable as TNumeric
from repro_torch.core.schema import EMPTY as TEMPTY
from repro_torch.core.schema import ColumnType as TType
from repro_torch.core.schema import MLRow as TRow
from repro_torch.core.schema import Schema as TSchema

TOL = dict(rtol=1e-5, atol=1e-5)

PEOPLE = [("ann", 34, True, 1.5), ("bob", 21, False, 2.5),
          ("cat", 45, True, 3.5), ("dan", 21, True, 4.5), ("eve", 30, False, 0.5)]
NAMES = ["name", "age", "member", "score"]


def _tables(rows=PEOPLE, names=NAMES, parts=2):
    return (JTable.from_rows(rows, names=names, num_partitions=parts),
            TTable.from_rows(rows, names=names, num_partitions=parts))


def _same(j, t):
    """Two MLTables hold the same partitions, rows, values and schema."""
    assert [c.ctype.value for c in j.schema.columns] == \
        [c.ctype.value for c in t.schema.columns]
    assert j.schema.names == t.schema.names
    assert [[tuple(r) for r in p] for p in j.partitions] == \
        [[tuple(r) for r in p] for p in t.partitions]


# --------------------------------------------------------------------------- #
# Schema and MLRow
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("value", [True, 3, 2.5, "x", None])
def test_column_type_inference_matches_reference(value):
    if value is None:
        with pytest.raises(TypeError):
            TType.infer(object())
        with pytest.raises(TypeError):
            JType.infer(object())
        return
    assert TType.infer(value).value == JType.infer(value).value
    assert TType.infer(value).is_numeric == JType.infer(value).is_numeric


def test_schema_validation_projection_and_names_match_reference():
    js = JSchema.of(JType.STRING, JType.INTEGER, JType.SCALAR, names=["a", "b", "c"])
    ts = TSchema.of(TType.STRING, TType.INTEGER, TType.SCALAR, names=["a", "b", "c"])
    assert ts.names == js.names and ts.index_of("c") == js.index_of("c") == 2
    assert ts.project([2, 0]).names == js.project([2, 0]).names
    assert ts.is_numeric == js.is_numeric is False
    ts.validate_row(("x", 1, 2))            # an int in a scalar column
    ts.validate_row(("x", TEMPTY, 2.0))     # Empty anywhere
    for bad in [("x", 1.5, 2.0), ("x", 1), (1, 1, 1.0)]:
        with pytest.raises((TypeError, ValueError)) as te:
            ts.validate_row(bad)
        with pytest.raises((TypeError, ValueError)) as je:
            js.validate_row(bad)
        assert type(te.value) is type(je.value)
    with pytest.raises(KeyError):
        ts.index_of("zz")
    assert TSchema.infer_from_row((1, 2.0, "s", True)) == \
        TSchema.of(TType.INTEGER, TType.SCALAR, TType.STRING, TType.BOOLEAN)


def test_mlrow_access_and_floats_match_reference():
    js = JSchema.of(JType.STRING, JType.BOOLEAN, JType.INTEGER, JType.SCALAR,
                    names=["s", "b", "i", "f"])
    ts = TSchema.of(TType.STRING, TType.BOOLEAN, TType.INTEGER, TType.SCALAR,
                    names=["s", "b", "i", "f"])
    jr, tr = JRow(("q", True, 3, 0.25), js), TRow(("q", True, 3, 0.25), ts)
    assert tr.get("i") == jr.get("i") and tr.get(0) == jr.get(0)
    assert TRow((True, 3, TEMPTY, 0.5)).is_empty(2)
    jf = JRow((True, 3, JEMPTY, 0.5)).to_floats()
    tf = TRow((True, 3, TEMPTY, 0.5)).to_floats()
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))
    with pytest.raises(TypeError):
        tr.to_floats()
    with pytest.raises(KeyError):
        TRow((1,)).get("x")


# --------------------------------------------------------------------------- #
# MLTable
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("parts", [1, 2, 3, 7])
def test_constructors_partition_like_the_reference(parts):
    _same(*_tables(parts=parts))
    arr = np.random.default_rng(parts).normal(size=(11, 3))
    _same(JTable.from_numpy(arr, num_partitions=parts, names=["x", "y", "z"]),
          TTable.from_numpy(arr, num_partitions=parts, names=["x", "y", "z"]))
    lines = [f"line {i}\n" for i in range(9)]
    _same(JTable.from_text(lines, num_partitions=parts),
          TTable.from_text(lines, num_partitions=parts))


def test_constructor_errors_match_reference():
    for T in (JTable, TTable):
        with pytest.raises(ValueError):
            T.from_rows([])
        with pytest.raises(ValueError):
            T.from_numpy(np.zeros(3))
        with pytest.raises(TypeError):
            T.from_rows([("a", 1), (2, 1)])


@pytest.mark.parametrize("op", ["project", "union", "filter", "join", "map",
                                "flat_map", "reduce_by_key"])
def test_relational_and_mapreduce_ops_match_reference(op):
    j, t = _tables(parts=3)
    grades = [("ann", "A"), ("bob", "B"), ("dan", "D"), ("dan", "E")]
    calls = {
        "project": lambda T, tab: tab.project(["score", 0]),
        "union": lambda T, tab: tab.union(tab),
        "filter": lambda T, tab: tab.filter(lambda r: r.get("age") < 40),
        "join": lambda T, tab: tab.join(
            T.from_rows(grades, names=["name", "grade"], num_partitions=2), on=["name"]),
        "map": lambda T, tab: tab.map(lambda r: (r.get("age") * 2, r[3] + 1.0)),
        "flat_map": lambda T, tab: tab.flatMap(lambda r: [(r[0],)] * (r[1] % 3)),
        "reduce_by_key": lambda T, tab: tab.reduceByKey(
            "age", lambda a, b: (a[0] + b[0], a[1], a[2] and b[2], a[3] + b[3])),
    }
    _same(calls[op](JTable, j), calls[op](TTable, t))
    assert t.numRows == j.numRows == 5 and t.numCols == j.numCols == 4


@pytest.mark.parametrize("parts", [1, 2, 3, 10])
def test_reduce_matches_reference_in_partition_order(parts):
    rows = [(float(i) * 0.1, i) for i in range(10)]
    j = JTable.from_rows(rows, num_partitions=parts)
    t = TTable.from_rows(rows, num_partitions=parts)

    def fn(a, b):
        return (a[0] * 0.5 + b[0], a[1] * 3 - b[1])

    assert tuple(t.reduce(fn)) == tuple(j.reduce(fn))
    with pytest.raises(ValueError):
        t.filter(lambda r: False).reduce(fn)


def test_union_and_commit_errors_match_reference():
    j, t = _tables()
    with pytest.raises(TypeError):
        t.union(TTable.from_rows([(1.0, 2.0)], num_partitions=1))
    with pytest.raises(TypeError):
        t.to_numeric(device="cpu")
    with pytest.raises(TypeError):
        j.to_numeric()


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_to_numeric_matches_reference(shards):
    rows = [(float(i % 2), i, bool(i % 3), 0.5 * i) for i in range(8)]
    rows[3] = (1.0, 3, True, JEMPTY)
    j = JTable.from_rows(rows, names=["label", "i", "b", "x"], num_partitions=3)
    rows[3] = (1.0, 3, True, TEMPTY)
    t = TTable.from_rows(rows, names=["label", "i", "b", "x"], num_partitions=3)
    jn, tn = j.to_numeric(num_shards=shards), t.to_numeric(num_shards=shards, device="cpu")
    np.testing.assert_array_equal(tn.to_numpy(), np.asarray(jn.data))
    assert tn.names == jn.names and tn.num_shards == jn.num_shards
    assert tn.data.dtype == torch.float32 and tn.data.device.type == "cpu"


# --------------------------------------------------------------------------- #
# LocalMatrix
# --------------------------------------------------------------------------- #
def _pair(a):
    return JLocal(jnp.asarray(a, jnp.float32)), TLocal(torch.tensor(a, dtype=torch.float32))


def _np(x):
    if isinstance(x, (JLocal, TLocal)):
        x = x.data
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture
def mats():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(4, 4)).astype(np.float32)
    spd = (a @ a.T + 4 * np.eye(4)).astype(np.float32)
    b = rng.normal(size=(4, 3)).astype(np.float32)
    v = rng.normal(size=(4,)).astype(np.float32)
    return a, spd, b, v


@pytest.mark.parametrize("op", ["add", "radd", "sub", "rsub", "mul", "rmul", "div",
                                "neg", "times", "matmul", "dot", "T", "on", "then",
                                "plus", "minus"])
def test_local_matrix_arithmetic_matches_reference(mats, op):
    a, _, b, v = mats
    (ja, ta), (jb, tb), (jv, tv) = _pair(a), _pair(b[:, :1] * 0 + a[:, :1]), _pair(v)
    calls = {
        "add": lambda A, B, V: A + B, "radd": lambda A, B, V: 2.0 + A,
        "sub": lambda A, B, V: A - B, "rsub": lambda A, B, V: 1.0 - A,
        "mul": lambda A, B, V: A * B, "rmul": lambda A, B, V: 3.0 * A,
        "div": lambda A, B, V: A / (B * B + 1.0), "neg": lambda A, B, V: -A,
        "times": lambda A, B, V: A.times(B), "matmul": lambda A, B, V: A @ A,
        "dot": lambda A, B, V: V.dot(V), "T": lambda A, B, V: A.T.transpose(),
        "on": lambda A, B, V: A.on(A), "then": lambda A, B, V: A.then(B),
        "plus": lambda A, B, V: A.plus(B), "minus": lambda A, B, V: A.minus(B),
    }
    np.testing.assert_allclose(_np(calls[op](ta, tb, tv)), _np(calls[op](ja, jb, jv)), **TOL)


def test_local_matrix_linear_algebra_matches_reference(mats):
    a, spd, b, v = mats
    (js, ts), (jb, tb) = _pair(spd), _pair(b)
    np.testing.assert_allclose(_np(ts.solve(tb)), _np(js.solve(jb)), **TOL)
    np.testing.assert_allclose(_np(ts.solve(torch.tensor(v))), _np(js.solve(jnp.asarray(v))), **TOL)
    np.testing.assert_allclose(_np(ts.inverse()), _np(js.inverse()), **TOL)
    (tu, tsv, tvt), (ju, jsv, jvt) = _pair(a)[1].svd(), _pair(a)[0].svd()
    np.testing.assert_allclose(tsv.numpy(), np.asarray(jsv), **TOL)
    np.testing.assert_allclose(_np(tu.times(TLocal(torch.diag(tsv))).times(tvt)), a,
                               rtol=1e-4, atol=1e-4)
    (tw, tv_), (jw, jv_) = ts.eigen(), js.eigen()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(tv_.times(TLocal(torch.diag(tw))).times(tv_.T)), spd,
                               rtol=1e-4, atol=1e-4)
    low = np.outer(v, v).astype(np.float32)
    assert int(_pair(low)[1].rank()) == int(_pair(low)[0].rank()) == 1
    for order in (None, "fro", 1, 2, np.inf):
        np.testing.assert_allclose(float(ts.norm(order)), float(js.norm(order)), rtol=1e-5)


def test_local_matrix_indexing_and_updates_match_reference(mats):
    a, _, _, _ = mats
    ja, ta = _pair(a)
    np.testing.assert_array_equal(_np(ta.row(2)), _np(ja.row(2)))
    np.testing.assert_array_equal(_np(ta.col(1)), _np(ja.col(1)))
    np.testing.assert_array_equal(_np(ta[1:3, 0:2]), _np(ja[1:3, 0:2]))
    assert float(ta[1, 2]) == float(ja[1, 2])
    np.testing.assert_array_equal(_np(ta.slice_rows([3, 0])), _np(ja.slice_rows([3, 0])))
    tu, ju = ta.updated((1, 2), 5.0), ja.updated((1, 2), 5.0)
    np.testing.assert_array_equal(_np(tu), _np(ju))
    assert float(ta[1, 2]) == float(a[1, 2])          # the original is kept
    sparse = np.array([[0.0, 2.0, 0.0, 3.0, 0.0]], np.float32)
    (ti, tm), (ji, jm) = _pair(sparse)[1].nonZeroIndices(0), _pair(sparse)[0].nonZeroIndices(0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    (ti, tm), (ji, jm) = (_pair(sparse)[1].non_zero_indices(0, max_nnz=3),
                          _pair(sparse)[0].non_zero_indices(0, max_nnz=3))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ti.numpy()[tm.numpy()], np.asarray(ji)[np.asarray(jm)])
    assert TLocal(torch.arange(4.0)).shape == JLocal(jnp.arange(4.0)).shape == (4, 1)
    with pytest.raises(ValueError):
        TLocal(torch.zeros((2, 2, 2)))
    cpu = "cpu"
    assert TLocal.zeros(2, 3, device=cpu).dims == (2, 3)
    assert TLocal.eye(3, device=cpu).to_vector().sum() == 3
    assert TLocal.ones(2, device=cpu).numRows == 2
    assert TLocal.rand(3, 2, device=cpu).shape == (3, 2)
    np.testing.assert_array_equal(TLocal.rand(3, 2, device=cpu).to_numpy(),
                                  TLocal.rand(3, 2, device=cpu).to_numpy())
    host = TLocal(np.arange(6.0).reshape(2, 3), device=cpu)
    assert host.data.device.type == cpu and host.shape == (2, 3)


# --------------------------------------------------------------------------- #
# MLNumericTable's row-wise ops and matrixBatchMap
# --------------------------------------------------------------------------- #
def _numeric(shards, n=24, d=5, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return (JNumeric.from_numpy(x, num_shards=shards),
            TNumeric.from_numpy(x, num_shards=shards, device="cpu"), x)


@pytest.mark.parametrize("shards", [1, 3, 4])
def test_map_rows_and_filter_mask_match_reference(shards):
    j, t, _ = _numeric(shards)
    np.testing.assert_array_equal(
        t.map_rows(lambda r: r * 2.0 + 1.0).to_numpy(),
        np.asarray(j.map_rows(lambda r: r * 2.0 + 1.0).data))
    tm = t.map_rows(lambda r: torch.sum(r * r))
    jm = j.map_rows(lambda r: jnp.sum(r * r))
    assert tm.num_cols == 1 and tm.num_shards == shards
    np.testing.assert_allclose(tm.to_numpy(), np.asarray(jm.data), **TOL)
    np.testing.assert_array_equal(t.filter_mask(lambda r: r[0] > 0).numpy(),
                                  np.asarray(j.filter_mask(lambda r: r[0] > 0)))


@pytest.mark.parametrize("shards,n", [(1, 24), (3, 24), (4, 24), (4, 20), (5, 15)])
def test_reduce_matches_reference_tree(shards, n):
    j, t, x = _numeric(shards, n=n, seed=n)
    np.testing.assert_array_equal(t.reduce(lambda a, b: a + b).numpy(),
                                  np.asarray(j.reduce(lambda a, b: a + b)))
    ident = torch.full((5,), -np.inf)
    np.testing.assert_array_equal(
        t.reduce(torch.maximum, identity=ident).numpy(),
        np.asarray(j.reduce(jnp.maximum, identity=jnp.full((5,), -jnp.inf))))
    np.testing.assert_allclose(t.sum_rows().numpy(), np.asarray(j.sum_rows()), **TOL)
    np.testing.assert_allclose(t.mean_rows().numpy(), np.asarray(j.mean_rows()), **TOL)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_matrix_batch_map_matches_reference(shards):
    j, t, x = _numeric(shards)
    w = np.arange(5, dtype=np.float32)

    def jfn(m, v):
        return m.times(JLocal(jnp.asarray(v))) + 1.0

    def tfn(m, v):
        return m.times(TLocal(torch.as_tensor(v))) + 1.0

    tout, jout = t.matrixBatchMap(tfn, w), j.matrixBatchMap(jfn, w)
    assert tout.num_shards == jout.num_shards == shards
    np.testing.assert_allclose(tout.to_numpy(), np.asarray(jout.data), **TOL)
    # a per-partition summary: one row per partition, in partition order
    tsum = t.matrix_batch_map(lambda m: m.data.sum(0, keepdim=True))
    jsum = j.matrix_batch_map(lambda m: m.data.sum(0, keepdims=True))
    np.testing.assert_allclose(tsum.to_numpy(), np.asarray(jsum.data), **TOL)


def test_numeric_table_context_and_local_matrix_match_reference():
    j, t, x = _numeric(2)
    assert t.context is t and t.broadcast(x) is x
    np.testing.assert_array_equal(t.toLocalMatrix().to_numpy(), _np(j.toLocalMatrix()))
    named = TNumeric.from_numpy(x, num_shards=2, device="cpu", names=list("abcde"))
    assert named.names == tuple("abcde") and named.map_rows(lambda r: r).names is None
    with pytest.raises(ValueError):
        TNumeric.from_numpy(x[:5], num_shards=2, device="cpu")
