"""The port's kernel modules against the JAX Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version; it is held
against the Pallas kernel run in interpret mode, as ``tests/test_kernels.py``
runs it, on the same seeded numpy inputs.  Tolerances are
``tests/test_kernels.py``'s: fp32 rtol = atol = 2e-4, bf16 5e-2; k-means
assignments are exact in both.  The CUDA kernels themselves are checked on
the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.kmeans_assign import kmeans_assign_pallas
from repro.kernels.logreg_grad import logreg_margin as j_margin
from repro.kernels.logreg_grad import logreg_xt_z as j_xt_z
from repro_torch import kernels as tk
from repro_torch.kernels import _build
from repro_torch.kernels import kmeans_assign as tka
from repro_torch.kernels import logreg_grad as tlg
from repro_torch.kernels import ops as tops

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=5e-2, atol=5e-2) if name == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _pair(arr, name):
    """The same values as a jax array and a torch tensor of one dtype."""
    jd, td = DTYPES[name]
    j = jnp.asarray(arr, jd)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
    return j, t


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("P,n,d", [(1, 64, 32), (3, 77, 33), (2, 5, 96),
                                   (2, 1, 7)])
def test_logreg_kernels_match_pallas(P, n, d, dtype):
    rng = np.random.default_rng(P * 1000 + n * 10 + d)
    Xj, Xt = _pair(rng.normal(size=(P, n, d)), dtype)
    y = rng.integers(0, 2, size=(P, n)).astype(np.float32)
    Wj, Wt = _pair(rng.normal(size=(P, d)) * 0.1, dtype)
    z = tlg.logreg_margin(Xt, torch.from_numpy(y), Wt)
    g = tlg.logreg_xt_z(Xt, z)
    for p in range(P):
        zj = j_margin(Xj[p], jnp.asarray(y[p]), Wj[p], interpret=True)
        gj = j_xt_z(Xj[p], zj, interpret=True)
        np.testing.assert_allclose(z[p].numpy(), np.asarray(zj), **_tol(dtype))
        np.testing.assert_allclose(g[p].numpy(), np.asarray(gj), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_logreg_grad_shared_weights_match_reference(dtype):
    """ops.logreg_grad on (n, d) and on (P, n, d) with one shared w equals
    the reference wrapper per partition, cast to w's dtype."""
    rng = np.random.default_rng(5)
    Xj, Xt = _pair(rng.normal(size=(3, 40, 24)), dtype)
    y = rng.integers(0, 2, size=(3, 40)).astype(np.float32)
    wj, wt = _pair(rng.normal(size=24) * 0.1, dtype)
    stacked = tops.logreg_grad(Xt, torch.from_numpy(y), wt)
    assert stacked.dtype == wt.dtype and stacked.shape == (3, 24)
    for p in range(3):
        want = np.asarray(jops.logreg_grad(Xj[p], jnp.asarray(y[p]), wj),
                          np.float32)
        one = tops.logreg_grad(Xt[p], torch.from_numpy(y[p]), wt)
        np.testing.assert_allclose(one.float().numpy(), want, **_tol(dtype))
        oracle = tlg.logreg_grad_plain(Xt[p], torch.from_numpy(y[p]), wt)
        np.testing.assert_allclose(
            oracle.float().numpy(),
            np.asarray(jref.logreg_grad_ref(Xj[p], jnp.asarray(y[p]), wj),
                       np.float32), **_tol(dtype))
        np.testing.assert_allclose(stacked[p].float().numpy(), want,
                                   **_tol(dtype))


def test_logreg_reads_strided_feature_columns():
    """The features after a label column are a strided view; the result is
    the one of the same values copied contiguous."""
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.normal(size=(2, 30, 17)).astype(np.float32))
    X, y = table[..., 1:], (table[..., 0] > 0).float()
    w = torch.from_numpy(rng.normal(size=16).astype(np.float32))
    np.testing.assert_allclose(
        tlg.logreg_grad(X, y, w).numpy(),
        tlg.logreg_grad(X.contiguous(), y, w).numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("n,d,k", [(256, 64, 8), (77, 33, 65), (200, 96, 257),
                                   (5, 3, 1), (129, 50, 50), (256, 4096, 50)])
def test_kmeans_assign_matches_pallas(n, d, k, dtype):
    rng = np.random.default_rng(n + d + k)
    Xj, Xt = _pair(rng.normal(size=(2, n, d)), dtype)
    Cj, Ct = _pair(rng.normal(size=(k, d)), dtype)
    got = tka.kmeans_assign(Xt, Ct)
    assert got.dtype == torch.int32 and got.shape == (2, n)
    for p in range(2):
        want = np.asarray(kmeans_assign_pallas(Xj[p], Cj, interpret=True))
        np.testing.assert_array_equal(got[p].numpy(), want)
        np.testing.assert_array_equal(tops.kmeans_assign(Xt[p], Ct).numpy(),
                                      want)


def test_kmeans_assign_ties_to_lowest_index():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(64, 40)).astype(np.float32)
    C0 = rng.normal(size=(4, 40)).astype(np.float32)
    C = np.concatenate([C0, C0])
    got = tka.kmeans_assign(torch.from_numpy(X), torch.from_numpy(C)).numpy()
    want = np.asarray(jref.kmeans_assign_ref(jnp.asarray(X), jnp.asarray(C)))
    np.testing.assert_array_equal(got, want)
    assert got.max() < 4


@pytest.mark.parametrize("call,args", [
    ("logreg_grad", ((4, 4), (5,), (4,))),
    ("logreg_grad", ((2, 4, 4), (2, 5), (4,))),
    ("logreg_grad", ((2, 4, 4), (2, 4), (3, 4))),
    ("kmeans_assign", ((8, 4), (2, 5))),
])
def test_shape_errors_match_reference(call, args):
    """Same ValueError text as the reference's wrappers (2-D cases), and
    the same form for the partitioned ones."""
    t_args = [torch.zeros(s) for s in args]
    with pytest.raises(ValueError) as t_err:
        getattr(tops, call)(*t_args)
    if len(args[0]) == 2:
        with pytest.raises(ValueError) as j_err:
            getattr(jops, call)(*[jnp.zeros(s) for s in args])
        assert str(t_err.value) == str(j_err.value)
    assert str(t_err.value).startswith("shape mismatch: X")


def test_cpu_tensors_use_the_plain_version_and_count_no_launch():
    tk.reset_launch_counts()
    X = torch.ones(2, 8, 4)
    tlg.logreg_xt_z(X, tlg.logreg_margin(X, torch.zeros(2, 8), torch.zeros(4)))
    tka.kmeans_assign(X, torch.ones(3, 4))
    tk.KERNELS["lm_head"](X[0], torch.ones(5, 4), tied=True)
    tk.KERNELS["quantize_rows"](X[0])
    tk.KERNELS["quant_linear"](X[0], [(torch.ones(4, 3, dtype=torch.int8), torch.ones(3))])
    tk.KERNELS["fixed_linear"](X[0], [torch.ones(4, 3)], norm=(torch.ones(4), 1e-6, True))
    tk.KERNELS["ssd_decode"](torch.zeros(1, 1, 2, 4), torch.zeros(1, 1), torch.ones(1, 1, 2),
                             torch.ones(1, 4), torch.ones(1, 4), torch.zeros(1),
                             torch.zeros(1), torch.ones(1))
    assert tk.launch_counts() == {"logreg_grad": 0, "logreg_margin": 0, "logreg_xt_z": 0,
                                  "kmeans_assign": 0, "quant_matmul": 0,
                                  "quant_linear": 0, "quantize_rows": 0,
                                  "rmsnorm": 0, "ssd_chunk_scan": 0,
                                  "flash_attention": 0, "flash_attention_decode": 0,
                                  "lm_head": 0, "ssd_decode": 0, "fixed_linear": 0}


def test_other_devices_raise_instead_of_falling_back():
    X = torch.ones(8, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tlg.logreg_margin(X, torch.zeros(8, device="meta"),
                          torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tka.kmeans_assign(X, torch.ones(2, 4, device="meta"))


def test_build_targets_hopper_and_needs_nvcc(monkeypatch):
    cmd = _build.nvcc_command("nvcc", "kmeans_assign", _build.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd and "-Xptxas" in cmd
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    if not _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
