"""The one-pass logistic-regression gradient (``logreg_grad``) on the CPU:
its plan, and its plain version against the JAX Pallas kernels.

The plan (``grad_plan``) fixes the order of every sum of ``grad_kernel``,
so it must be a function of (n, d) alone, cover every column and row once,
and fit a block's shared memory and registers: checked here at the
paper's widths and at ragged ones, by the same rules the C launcher checks.
The CUDA kernel itself is checked on the card by ``tests/test_torch_cuda.py``.
On the CPU ``logreg_grad`` runs its plain version; it is held against
``logreg_grad_pallas`` run in interpret mode at ``tests/test_kernels.py``'s
tolerances (fp32 rtol = atol = 2e-4, bf16 5e-2), with per-partition w and
the strided view of a table's feature columns.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.logreg_grad import logreg_grad_pallas
from repro_torch import kernels as tk
from repro_torch.kernels import logreg_grad as tlg

WIDTHS = [1, 7, 33, 511, 512, 1031, 4095, 4096, 4097, 10239, 10240, 10241, 20481,
          30000, 32767, 32768, 32769, 33000, 65536, 150001, 160000, 163839, 163840]
ROWS = [1, 3, 4, 16, 17, 37, 128, 256, 1000, 8192]
THREADS = 512


def _column_slices(p):
    """[c0, c1) of each block of a cluster, by rank (csrc's c0 = rank·W,
    width = min(W, d − c0))."""
    return [(r * p.width, min(p.d, (r + 1) * p.width)) for r in range(p.clusters)]


def _row_chunks(p):
    """[r0, r1) of each chunk of a partition, in chunk order."""
    return [(q * p.chunk_rows, min(p.n, (q + 1) * p.chunk_rows)) for q in range(p.chunks)]


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_covers_every_column_once_within_its_form(d):
    """The slices tile [0, d) in rank order, none empty, each within the
    form's columns a thread at 512 threads, in a cluster the form allows
    (the C launcher's checks)."""
    forms = {k: (r, most) for k, r, most in tlg.GRAD_FORMS}
    for n in ROWS:
        p = tlg.grad_plan(n, d)
        assert p.n == n and p.d == d
        slices = _column_slices(p)
        assert len(slices) == p.clusters and slices[0][0] == 0 and slices[-1][1] == d
        assert all(a < b for a, b in slices)
        assert all(slices[i][1] == slices[i + 1][0] for i in range(len(slices) - 1))
        assert p.clusters * p.width >= d > (p.clusters - 1) * p.width
        assert p.width <= p.cols_per_thread * THREADS
        assert p.cols_per_thread in forms
        assert p.group_rows == forms[p.cols_per_thread][0]
        assert 1 <= p.clusters <= forms[p.cols_per_thread][1]


@pytest.mark.parametrize("n", ROWS)
def test_plan_covers_every_row_once(n):
    """The chunks tile [0, n) in chunk order, none empty."""
    for d in (4096, 30000, 160000, 1031):
        chunks = _row_chunks(tlg.grad_plan(n, d))
        assert chunks[0][0] == 0 and chunks[-1][1] == n
        assert all(a < b for a, b in chunks)
        assert all(chunks[i][1] == chunks[i + 1][0] for i in range(len(chunks) - 1))


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_fits_shared_memory(d):
    """The ring of S stages of R row slots fits a block's shared memory
    with at least 3 stages (a group's rows are issued two iterations before
    they are read), and a slot holds the slice and 15 bytes either side."""
    p = tlg.grad_plan(256, d)
    slot = p.smem_bytes // (p.group_rows * p.stages)
    assert slot % 16 == 0 and slot >= 4 * p.width + 30
    assert 3 <= p.stages <= tlg.GRAD_MAX_STAGES
    assert p.smem_bytes <= tlg.GRAD_SMEM < 232448


def test_plan_at_the_main_paths_widths():
    """d = 4,096 one block; Fig. A2's 30,000 a cluster of 8 (slices of
    3,750); the paper's 160,000 a cluster of 16 (slices of 10,000), its
    partitions in 7 chunks; wider than 16 slices of 10,240 no plan (the
    chain route)."""
    assert (tlg.grad_plan(256, 4096).clusters, tlg.grad_plan(256, 4096).width) == (1, 4096)
    assert (tlg.grad_plan(4, 30000).clusters, tlg.grad_plan(4, 30000).width) == (8, 3750)
    p = tlg.grad_plan(256, 160000)
    assert (p.clusters, p.width, p.chunks) == (16, 10000, 7)
    assert tlg.grad_plan(8192, 160000).chunks == 7
    assert tlg.grad_plan(128, 160000).chunk_rows == 32
    assert tlg.grad_plan(256, 163841) is None and tlg.grad_plan(1, 400000) is None


@pytest.mark.parametrize("P", range(1, 9))
def test_plan_depends_on_rows_and_columns_alone(P):
    """The plan a launch takes is the same for any P, for a strided view of
    a table's feature columns and its contiguous copy, for 2-D and 3-D X,
    and in bf16: a partition's sums run in one order whatever shares its
    launch."""
    table = torch.zeros(P, 37, 1032)
    views = [table[..., 1:], table[..., 1:].contiguous(), table[..., 1:].to(torch.bfloat16),
             table[0, :, 1:], table[:, :, 1:][::1]]
    assert {tlg.grad_plan_of(v) for v in views} == {tlg.grad_plan(37, 1031)}


def test_scratch_only_where_a_partition_is_several_chunks():
    """Chunk partials (P·Q·d floats) and tickets (P·C) only where Q > 1."""
    assert tlg.grad_plan(4, 30000).scratch(8) == (0, 0)
    p = tlg.grad_plan(256, 160000)
    assert p.scratch(8) == (8 * 7 * 160000, 8 * 16)
    assert p.scratch(4) == (4 * 7 * 160000, 4 * 16)


def _pair(arr, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    j = jnp.asarray(arr, jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,n,d", [(3, 64, 512), (2, 256, 1024), (4, 40, 96), (2, 1, 7)])
def test_logreg_grad_matches_pallas(P, n, d, dtype):
    """logreg_grad on CPU tensors (its plain version) against
    logreg_grad_pallas in interpret mode, partition by partition: the
    features the strided view after a label column, w per partition."""
    rng = np.random.default_rng(P * 1000 + n + d)
    table = rng.normal(size=(P, n, d + 1))
    Xj, _ = _pair(table[..., 1:], dtype)
    _, Tt = _pair(table, dtype)
    Xt = Tt[..., 1:]
    assert Xt.stride(1) == d + 1
    y = rng.integers(0, 2, size=(P, n)).astype(np.float32)
    Wj, Wt = _pair(rng.normal(size=(P, d)) * 0.1, dtype)
    tol = dict(rtol=5e-2, atol=5e-2) if dtype == "bfloat16" else dict(rtol=2e-4, atol=2e-4)
    tk.reset_launch_counts()
    g = tlg.logreg_grad(Xt, torch.from_numpy(y), Wt)
    assert g.shape == (P, d) and g.dtype == Wt.dtype
    assert tk.launch_counts()["logreg_grad"] == 0
    for p in range(P):
        want = np.asarray(logreg_grad_pallas(Xj[p], jnp.asarray(y[p]), Wj[p], interpret=True),
                          np.float32)
        np.testing.assert_allclose(g[p].float().numpy(), want, **tol)


def test_logreg_grad_shared_weights_match_pallas():
    """With one w for every partition, and a 2-D X as one partition."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(3, 64, 512)).astype(np.float32)
    y = rng.integers(0, 2, size=(3, 64)).astype(np.float32)
    w = (rng.normal(size=512) * 0.1).astype(np.float32)
    g = tlg.logreg_grad(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w))
    for p in range(3):
        want = np.asarray(logreg_grad_pallas(jnp.asarray(X[p]), jnp.asarray(y[p]),
                                             jnp.asarray(w), interpret=True))
        np.testing.assert_allclose(g[p].numpy(), want, rtol=2e-4, atol=2e-4)
        one = tlg.logreg_grad(torch.from_numpy(X[p]), torch.from_numpy(y[p]),
                              torch.from_numpy(w))
        np.testing.assert_allclose(one.numpy(), want, rtol=2e-4, atol=2e-4)


def test_margin_without_labels_is_the_sigmoid_bitwise():
    """logreg_margin with y None (the served path) gives σ(Xw), bitwise
    what zero labels gave (σ − 0), partitioned or not."""
    rng = np.random.default_rng(22)
    X = torch.from_numpy(rng.normal(size=(2, 9, 13)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=13).astype(np.float32))
    got = tlg.logreg_margin(X, None, w)
    assert torch.equal(got, tlg.logreg_margin(X, torch.zeros(2, 9), w))
    assert torch.equal(got[1], tlg.logreg_margin(X[1], None, w))
    assert torch.equal(got[0], torch.sigmoid(X[0] @ w))


def test_reset_clears_logreg_grad_routes():
    tlg.logreg_grad.routes["one_pass"] += 2
    tlg.logreg_grad.launches = 5
    tk.reset_launch_counts()
    assert not tlg.logreg_grad.routes and tk.launch_counts()["logreg_grad"] == 0
    assert tk.KERNELS["logreg_grad"] is tlg.logreg_grad


def test_logreg_grad_on_another_device_raises():
    X = torch.ones(8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tlg.logreg_grad(X, torch.zeros(8, device="meta"), torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="shape mismatch"):
        tlg.logreg_grad(torch.ones(8, 4), torch.zeros(7), torch.zeros(4))
