"""The port on the CUDA card: kernels against their plain versions, the
fitted path against the same fit on the CPU, and launch counts.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tests marked ``cuda`` decide inside the test whether a card is present and
skip without one.  Tolerances are ``tests/test_kernels.py``'s fp32 2e-4
(for the gradient: max abs error over the largest entry); k-means
assignments are compared exactly on random data, where fp32 ties do not
occur.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.kernels import kmeans_assign as tka
from repro_torch.kernels import logreg_grad as tlg
from repro_torch.serve.predictor import ModelPredictor
from repro_torch.weights import from_reference


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_entry_points_default_to_the_card():
    """Without ``device=`` an entry point runs on the card, or raises where
    there is none — never quietly on the CPU."""
    rows = np.ones((8, 6), np.float32)
    calls = [
        lambda: MLNumericTable.from_numpy(rows).data.device,
        lambda: ModelPredictor(model=None, predict_fn=lambda x: x).device,
        lambda: from_reference("kmeans", {"centroids": rows[:4]}).centroids.device,
    ]
    for call in calls:
        if torch.cuda.is_available():
            assert call().type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each kernel against its plain version, fp32 and bf16, ragged n/d/k,
    k = 65 and 257; one launch counted per wrapper call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    tk.reset_launch_counts()
    for P, n, d in [(3, 77, 1031), (1, 1, 7), (2, 300, 33)]:
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(P, n, d + 1, generator=gen, device="cuda").to(dtype)
            X, y = table[..., 1:], (table[..., 0] > 0).float()
            w = torch.randn(P, d, generator=gen, device="cuda") * 0.05
            z = tlg.logreg_margin(X, y, w)
            zp = tlg.logreg_margin_plain(X, y, w)
            torch.testing.assert_close(z, zp, rtol=2e-4, atol=2e-4)
            g, gp = tlg.logreg_xt_z(X, zp), tlg.logreg_xt_z_plain(X, zp)
            assert ((g - gp).abs().max() / gp.abs().max()).item() < 2e-4
    for P, n, d, k in [(2, 300, 70, 65), (1, 513, 100, 257), (3, 129, 33, 1)]:
        for dtype in (torch.float32, torch.bfloat16):
            X = torch.randn(P, n, d, generator=gen, device="cuda").to(dtype)
            C = torch.randn(k, d, generator=gen, device="cuda")
            assert torch.equal(tka.kmeans_assign(X, C),
                               tka.kmeans_assign_plain(X, C))
    torch.cuda.synchronize()
    assert tk.launch_counts() == {"logreg_margin": 6, "logreg_xt_z": 6,
                                  "kmeans_assign": 6}


@pytest.mark.cuda
@pytest.mark.parametrize("solver,lr", [("sgd", 0.1), ("gd", 0.002)])
def test_logreg_fit_on_card_matches_cpu(solver, lr):
    """The fit through the kernels on the card equals the same fit through
    the plain versions on the CPU; one launch of each kernel per chunk."""
    _need_card()
    rng = np.random.default_rng(1)
    data = rng.normal(size=(512, 65)).astype(np.float32)
    data[:, 0] = data[:, 1:] @ rng.normal(size=64) > 0
    kw = dict(solver=solver, learning_rate=lr, max_iter=3, local_batch_size=8,
              use_kernel=True)
    tk.reset_launch_counts()
    card = LogisticRegression(**kw).fit(MLNumericTable.from_numpy(data, num_shards=4))
    per_round = 128 // 8 if solver == "sgd" else 1
    assert tk.launch_counts()["logreg_margin"] == 3 * per_round
    cpu = LogisticRegression(**kw).fit(
        MLNumericTable.from_numpy(data, num_shards=4, device="cpu"))
    err = (card.weights.cpu() - cpu.weights).abs().max() / cpu.weights.abs().max()
    assert err.item() < 2e-4


@pytest.mark.cuda
def test_kmeans_fit_and_serving_on_card():
    """Lloyd rounds through the kernel (one launch a round) equal the
    direct form on the CPU; serving launches once per microbatch."""
    _need_card()
    rng = np.random.default_rng(2)
    X = (rng.normal(size=(512, 16)) + np.repeat(np.eye(4, 16) * 8, 128, 0)
         ).astype(np.float32)
    init = X[[0, 128, 256, 384, 1]]
    tk.reset_launch_counts()
    card = KMeans(k=5, max_iter=4, use_kernel=True).fit(
        MLNumericTable.from_numpy(X, num_shards=4), init_centroids=init)
    assert tk.launch_counts()["kmeans_assign"] == 4
    cpu = KMeans(k=5, max_iter=4).fit(
        MLNumericTable.from_numpy(X, num_shards=4, device="cpu"),
        init_centroids=init)
    torch.testing.assert_close(card.centroids.cpu(), cpu.centroids,
                               rtol=2e-4, atol=2e-4)
    svc = ModelPredictor(card, max_batch=64)
    tk.reset_launch_counts()
    got = svc.predict_many([X[:100], X[100:101], X[101:300]])
    assert tk.launch_counts()["kmeans_assign"] == svc.batches == 5
    want = cpu.predict(torch.from_numpy(X[:300])).numpy()
    np.testing.assert_array_equal(np.concatenate(got), want)
