"""The port on the CUDA card: kernels against their plain versions, the
fitted path against the same fit on the CPU, and launch counts.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tests marked ``cuda`` decide inside the test whether a card is present and
skip without one.  Tolerances are ``tests/test_kernels.py``'s fp32 2e-4
(for the gradient: max abs error over the largest entry); k-means
assignments are compared exactly on random data, where fp32 ties do not
occur, at d of one 512-element slice, and at d of several (where the kernel
sums in slices and the plain version in one chain) differ only where two
scores lie within fp32 rounding; ``quant_matmul`` is bitwise (its sum is integer), and greedy token
streams are compared exactly.  ``rmsnorm`` is held at rtol = atol = 1e-5
in fp32 and within one bf16 step (rtol 2⁻⁷) in bf16 (only the order of a
row's sum of squares differs), and bitwise between a row alone and in a
batch; ``layernorm`` the same way (its plain version takes the kernel's
order, so the two differ only where a library's sqrt or division would); ``ssd_chunk_scan`` at rtol = atol = 1e-4, ``tests/test_kernels.py``'s
own tolerance for that kernel, within ``chip_smoke.FP32_TOL`` (2e-4 of max
|entry|) of its fp64 value at the served decays, and bitwise between a head
alone and in a batch, and from call to call.  ``flash_attention`` (both
forms) is held at ``tests/test_kernels.py``'s fp32 2e-4 and, in bf16,
within one bf16 step of each value (rtol 2⁻⁷, atol 1e-6: the kernel sums in
fp32 where the plain version sums in fp64, and the output rounds to bf16
either side of a boundary); a row's output is bitwise the same alone and in
a batch, and at its exact length and padded.
"""
import collections
import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.kernels import fixed_linear as tfl
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kmeans_assign as tka
from repro_torch.kernels import layernorm as tln
from repro_torch.kernels import logreg_grad as tlg
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models.layers import ssd as tlssd
from repro_torch.core.local_matrix import LocalMatrix
from repro_torch.core.mltable import MLTable
from repro_torch.data.synthetic import synth_labeled_text, synth_text_corpus
from repro_torch.features import NGrams, Standardizer, TfIdf, tf_idf
from repro_torch.pipeline import Pipeline
from repro_torch.serve.predictor import ModelPredictor, PredictRequest
from repro_torch.weights import from_reference
from repro_torch.core.algorithms.als import BroadcastALS, pack_csr_table
from repro_torch.core.algorithms.linear_models import LinearRegression, LinearSVM
from repro_torch.core.algorithms.naive_bayes import GaussianNaiveBayes
from repro_torch.core.algorithms.pca import PCA
from repro_torch.core.local_matrix import PaddedCSR
from repro_torch.data.synthetic import synth_netflix_tiled
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.core.runner import CheckpointPolicy
from repro_torch.data import BatchIterator


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _device_of_work(call):
    """Where ``call`` computed, for an entry point whose result comes back
    to the host: the card if it allocated there."""
    def allocated():
        return torch.cuda.memory_stats().get("allocation.all.allocated", 0)

    before = allocated() if torch.cuda.is_available() else 0
    call()
    return torch.device("cuda" if allocated() > before else "cpu")


def test_entry_points_default_to_the_card(tmp_path):
    """Without ``device=`` an entry point runs on the card, or raises where
    there is none — never quietly on the CPU."""
    rows = np.ones((8, 6), np.float32)
    save_checkpoint(str(tmp_path), 0, {"w": torch.zeros(3)})
    docs = MLTable.from_text(["a b c", "b c d"], num_partitions=1)
    counts = NGrams(n=1).fit(docs).transform(docs)   # the host tier
    calls = [
        lambda: MLNumericTable.from_numpy(rows).data.device,
        lambda: ModelPredictor(model=None, predict_fn=lambda x: x).device,
        lambda: from_reference("kmeans", {"centroids": rows[:4]}).centroids.device,
        lambda: MLTable.from_numpy(rows).to_numeric().data.device,
        lambda: Pipeline([NGrams(n=1), TfIdf()]).fit(docs).device,
        lambda: TfIdf().fit(counts).idf.device,
        lambda: _device_of_work(lambda: TfIdf().fit_transform(counts)),
        lambda: _device_of_work(lambda: tf_idf(counts)),
        lambda: LocalMatrix.zeros(2, 3).data.device,
        lambda: LocalMatrix.ones(2).data.device,
        lambda: LocalMatrix.eye(3).data.device,
        lambda: LocalMatrix.rand(3, 2).data.device,
        lambda: LocalMatrix(rows).data.device,
        lambda: PaddedCSR.from_dense(rows).indices.device,
        lambda: PaddedCSR.from_coo([0, 1], [1, 0], [1.0, 2.0], 2, 1).values.device,
        lambda: pack_csr_table([0, 1], [1, 0], [1.0, 2.0], 2, 1).data.device,
        lambda: from_reference("als", {"U": rows, "V": rows}).U.device,
        lambda: from_reference("linear_regression", {"weights": rows[0]}).weights.device,
        lambda: from_reference("linear_svm", {"weights": rows[0]}).weights.device,
        lambda: from_reference("pca", {"components": rows[:2], "mean": rows[0],
                                       "explained_variance": rows[0, :2]}).mean.device,
        lambda: from_reference("naive_bayes", {"priors": rows[0, :2], "means": rows[:2],
                                               "variances": rows[:2]}).means.device,
        lambda: BatchIterator(lambda step: {"data": rows}).device,
        lambda: restore_checkpoint(str(tmp_path), {"w": 0})[0]["w"].device,
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
    assert tk.launch_counts() == {"logreg_grad": 0, "logreg_margin": 6, "logreg_xt_z": 6,
                                  "kmeans_assign": 6, "quant_matmul": 0,
                                  "quant_linear": 0, "quantize_rows": 0,
                                  "rmsnorm": 0, "ssd_chunk_scan": 0,
                                  "flash_attention": 0, "flash_attention_decode": 0,
                                  "flash_attention_tail": 0,
                                  "lm_head": 0, "ssd_decode": 0, "fixed_linear": 0,
                                  "rglru_scan": 0, "layernorm": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("solver,lr", [("sgd", 0.1), ("gd", 0.002)])
def test_logreg_fit_on_card_matches_cpu(solver, lr):
    """The fit through the kernels on the card equals the same fit through
    the plain versions on the CPU; one logreg_grad launch per chunk, and no
    launch of the two-kernel chain."""
    _need_card()
    rng = np.random.default_rng(1)
    data = rng.normal(size=(512, 65)).astype(np.float32)
    data[:, 0] = data[:, 1:] @ rng.normal(size=64) > 0
    kw = dict(solver=solver, learning_rate=lr, max_iter=3, local_batch_size=8,
              use_kernel=True)
    tk.reset_launch_counts()
    card = LogisticRegression(**kw).fit(MLNumericTable.from_numpy(data, num_shards=4))
    per_round = 128 // 8 if solver == "sgd" else 1
    got = tk.launch_counts()
    assert (got["logreg_grad"], got["logreg_margin"], got["logreg_xt_z"]) == (3 * per_round, 0, 0)
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


def _fig_a2_pipes(device):
    """The Fig. A2 flows at the examples' sizes, k-means and classifier,
    through the kernels (the plain versions on the CPU)."""
    kmeans = Pipeline([NGrams(n=2, top=64), TfIdf(),
                       KMeans(k=4, max_iter=10, seed=0, use_kernel=True)],
                      num_shards=4, device=device)
    text = Pipeline([NGrams(n=1, top=64, column="text"), TfIdf(), Standardizer(),
                     LogisticRegression(learning_rate=0.5, max_iter=8, local_batch_size=4,
                                        use_kernel=True)], num_shards=8, device=device)
    return kmeans, text


@pytest.mark.cuda
def test_fig_a2_pipelines_on_card_match_cpu():
    """Both Fig. A2 flows fitted on the card equal the same flows on the
    CPU: the featurized tables and the statistics at fp32 rtol = atol =
    1e-6, centroids and weights at 2e-4, labels exactly; kernels 1-3 carry
    the estimators (one kmeans_assign launch a round, one logreg_grad launch
    a step)."""
    _need_card()
    docs = MLTable.from_text(synth_text_corpus(n_docs=64, words_per_doc=40), 4)
    rows = synth_labeled_text(n_docs=128, words_per_doc=20, seed=0)
    labeled = MLTable.from_rows(rows, names=["label", "text"], num_partitions=4)
    (card_k, card_t), (cpu_k, cpu_t) = _fig_a2_pipes(None), _fig_a2_pipes("cpu")
    tk.reset_launch_counts()
    fits = [(card_k.fit(docs), cpu_k.fit(docs), docs),
            (card_t.fit(labeled), cpu_t.fit(labeled), labeled)]
    got = tk.launch_counts()
    assert (got["kmeans_assign"], got["logreg_grad"], got["logreg_margin"],
            got["logreg_xt_z"]) == (10, 8 * 16 // 4, 0, 0)
    for card, cpu, raw in fits:
        assert card.device.type == "cuda" and card["ngrams"].vocab == cpu["ngrams"].vocab
        torch.testing.assert_close(card.transform(raw).data.cpu(), cpu.transform(raw).data,
                                   rtol=1e-6, atol=1e-6)
    (ck, pk, _), (ct, pt, _) = fits
    torch.testing.assert_close(ck.model.centroids.cpu(), pk.model.centroids,
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(ct.model.weights.cpu(), pt.model.weights, rtol=2e-4, atol=2e-4)
    for card, cpu, texts in ((ck, pk, synth_text_corpus(n_docs=64, words_per_doc=40)),
                             (ct, pt, [t for _, t in rows])):
        np.testing.assert_array_equal(card.predict(texts).cpu().numpy(),
                                      cpu.predict(texts).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("flow", ["kmeans", "text"])
def test_fig_a2_served_raw_text_is_the_offline_prediction_bitwise(flow):
    """Raw-text requests of 1..7 docs through ModelPredictor on the card:
    every result bitwise the fitted model's prediction on the featurized
    table (kernel 3 at any row count, kernel 1 at any row stride), one
    kernel launch a microbatch, the memo hit on repeats."""
    _need_card()
    if flow == "kmeans":
        texts = synth_text_corpus(n_docs=64, words_per_doc=40)
        raw, pipe = MLTable.from_text(texts, 4), _fig_a2_pipes(None)[0]
    else:
        rows = synth_labeled_text(n_docs=128, words_per_doc=20, seed=0)
        texts = [t for _, t in rows]
        raw = MLTable.from_rows(rows, names=["label", "text"], num_partitions=4)
        pipe = _fig_a2_pipes(None)[1]
    fitted = pipe.fit(raw)
    table = fitted.transform(raw).data
    offline = fitted.model.predict(table if flow == "kmeans" else table[:, 1:]).cpu().numpy()
    rng = np.random.default_rng(5)
    idx = [rng.integers(0, 32, size=int(m)) for m in rng.integers(1, 8, size=40)]
    svc = ModelPredictor(fitted, max_batch=8)
    kernel = "kmeans_assign" if flow == "kmeans" else "logreg_margin"
    tk.reset_launch_counts()
    reqs = [svc.submit(PredictRequest(features=[texts[i] for i in ix])) for ix in idx]
    svc.flush()
    assert tk.launch_counts()[kernel] == svc.batches
    for ix, r in zip(idx, reqs):
        np.testing.assert_array_equal(r.result, offline[ix])
    rep = svc.report()
    assert rep["featurize_hits"] > 0 and rep["featurize_hits"] + rep["featurize_misses"] == \
        sum(len(ix) for ix in idx)


def _kmeans_ties_only(X, C, got, want):
    """Every row where two assignments differ is a tie within fp32
    rounding: the two scores ||c||² − 2·x·c, in fp64, lie within twice the
    error bound of an fp32 sum of d products (d·2⁻²⁴ times the sum of the
    magnitudes) of each other (chip_smoke.py's ``score_gap``)."""
    rows = (got != want).nonzero(as_tuple=True)
    if rows[0].numel() == 0:
        return True
    x, Cd = X[rows].double(), C.double()
    cn = (Cd * Cd).sum(1)
    ca, cb = Cd[got[rows].long()], Cd[want[rows].long()]
    gap = ((cn[got[rows].long()] - 2 * (x * ca).sum(-1))
           - (cn[want[rows].long()] - 2 * (x * cb).sum(-1))).abs()
    mag = cn.max() + 2 * torch.maximum((x.abs() * ca.abs()).sum(-1),
                                       (x.abs() * cb.abs()).sum(-1))
    return bool((gap <= 2 * X.shape[-1] * 2.0 ** -24 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("P,n,d,k,form", [(3, 333, 1031, 50, "split"),
                                          (1, 2048, 4096, 50, "split"),
                                          (2, 12000, 1031, 50, "stream"),
                                          (1, 20000, 4096, 65, "stream")])
def test_kmeans_assign_slices_match_plain_version(P, n, d, k, form):
    """At d of several 512-element slices, in the form the shape takes, the
    kernel's picks are the plain version's but for ties within fp32
    rounding: a dropped or reordered slice, or a wrong cross-block sum,
    moves picks by far more."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(P + n + d + k)
    X = torch.randn(P, n, d, generator=gen, device="cuda")
    C = torch.randn(k, d, generator=gen, device="cuda")
    tka.kmeans_assign.forms.clear()
    got = tka.kmeans_assign(X, C)
    torch.cuda.synchronize()
    assert dict(tka.kmeans_assign.forms) == {form: 1}
    assert _kmeans_ties_only(X, C, got, tka.kmeans_assign_plain(X, C))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 50, 64, 65, 257])
def test_kmeans_assign_rows_are_batch_invariant(k):
    """A row's pick is bitwise the same in a launch of any size, at any
    offset and in either form: sub-batches of X (2, 4096, 4096) at n = 1,
    7, 128 and 2048, at offsets, as (P, n, d) and as (n, d), against X's
    launch (the split form), and X's rows against a launch of a
    (2, 16384, 4096) table whose first 4096 rows a partition are X's (the
    stream form)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(k)
    big = torch.randn(2, 16384, 4096, generator=gen, device="cuda")
    C = torch.randn(k, 4096, generator=gen, device="cuda")
    X = big[:, :4096]
    tka.kmeans_assign.forms.clear()
    whole = tka.kmeans_assign(big, C)
    full = tka.kmeans_assign(X, C)
    assert torch.equal(full, whole[:, :4096])
    for n in (1, 7, 128, 2048):
        for off in (0, 1, 1000, 4096 - n):
            assert torch.equal(tka.kmeans_assign(X[:, off:off + n], C),
                               full[:, off:off + n]), (n, off)
            assert torch.equal(tka.kmeans_assign(X[1, off:off + n], C),
                               full[1, off:off + n]), (n, off)
    torch.cuda.synchronize()
    assert tka.kmeans_assign.forms["stream"] >= 1
    assert tka.kmeans_assign.forms["split"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,d,k", [(300, 1031, 50), (77, 4099, 65), (1000, 4096, 50),
                                   (2500, 33, 7), (129, 1, 3), (5, 512, 257)])
def test_kmeans_assign_routes_agree(n, d, k, dtype):
    """The same rows contiguous, in a 16-byte-aligned strided view (the TMA
    route) and in an unaligned one (row stride d + 1, the general route):
    bitwise the same picks, and the first n − 1 rows alone the same too;
    the plain version's but for ties within fp32 rounding."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n + d + k)
    X = torch.randn(2, n, d, generator=gen, device="cuda").to(dtype)
    C = torch.randn(k, d, generator=gen, device="cuda")
    step = 16 // X.element_size()
    aligned = torch.zeros(2, n, -(-d // step) * step + step, dtype=dtype, device="cuda")
    aligned[..., :d] = X
    unaligned = torch.zeros(2, n, d + 1, dtype=dtype, device="cuda")
    unaligned[..., 1:] = X
    tka.kmeans_assign.routes.clear()
    want = tka.kmeans_assign(X, C)
    assert _kmeans_ties_only(X, C, want, tka.kmeans_assign_plain(X, C))
    for view in (aligned[..., :d], unaligned[..., 1:]):
        assert torch.equal(tka.kmeans_assign(view, C), want)
        assert torch.equal(tka.kmeans_assign(view[:, 1:], C), want[:, 1:])
    torch.cuda.synchronize()
    assert tka.kmeans_assign.routes["tma"] >= 2
    assert tka.kmeans_assign.routes["general"] >= 2


@pytest.mark.cuda
def test_quant_matmul_kernel_matches_plain_version():
    """Bitwise against the plain version at decode and prefill shapes of
    Qwen2-1.5B, ragged M, N and K, unaligned K, and ±127 operands; one
    launch counted, and counted by shape, per call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(8, 1536, 1536), (8, 1536, 256), (8, 8960, 1536), (1, 1537, 255),
              (5, 8960, 33), (33, 1537, 255), (300, 1536, 520)]
    tk.reset_launch_counts()
    tqm.quant_matmul.shapes.clear()
    for M, K, N in shapes:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        wt = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        xs = torch.rand(M, generator=gen, device="cuda") * 0.02 + 1e-3
        ws = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
        assert torch.equal(tqm.quant_matmul(xq, xs, wt.t(), ws),
                           tqm.quant_matmul_plain(xq, xs, wt.t(), ws)), (M, K, N)
    xq = torch.full((8, 8960), 127, dtype=torch.int8, device="cuda")
    wq = torch.full((8960, 64), -127, dtype=torch.int8, device="cuda")
    ones = torch.ones(64, device="cuda")
    got = tqm.quant_matmul(xq, ones[:8], wq, ones)      # a (K, N) layout too
    assert torch.equal(got, torch.full_like(got, float(8960 * 127 * -127)))
    torch.cuda.synchronize()
    assert tk.launch_counts()["quant_matmul"] == len(shapes) + 1
    assert tqm.quant_matmul.shapes == dict.fromkeys(shapes + [(8, 8960, 64)], 1)


def _qmm_operands(gen, M, K, N, extreme=False):
    if extreme:
        xq = torch.full((M, K), 127, dtype=torch.int8, device="cuda")
        wt = torch.full((N, K), -127, dtype=torch.int8, device="cuda")
    else:
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        wt = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                           dtype=torch.int8)
    xs = torch.rand(M, generator=gen, device="cuda") * 0.02 + 1e-3
    ws = torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3
    return xq, xs, wt.t(), ws


# (M, K, N) of Qwen2-1.5B's and Gemma3-1B's prefill waves as chip_smoke.py
# serves them, ragged M, N and K on the tiled form (N past a 128- and a
# 256-column tile, N odd, K a multiple of 16 but not of 128, K odd), N = 256
@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    *[(M, K, N) for M in (7168, 8000)
      for K, N in ((1536, 1536), (1536, 256), (1536, 8960), (8960, 1536))],
    *[(M, K, N) for M in (8192, 15680)
      for K, N in ((1152, 1024), (1152, 256), (1024, 1152), (1152, 6912), (6912, 1152))],
    (7999, 1536, 1000), (8000, 1536, 129), (4097, 1040, 300), (130, 1537, 257),
    (17, 8960, 255), (33, 1536, 8960), (300, 256, 256),
])
def test_quant_matmul_prefill_form_is_bitwise(M, K, N):
    """The tiled form (``qmm_wgmma``, M > 16) bitwise against the plain
    version, at its chosen tile width."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(M + K + N)
    ops = _qmm_operands(gen, M, K, N)
    got = tqm.quant_matmul(*ops)
    want = tqm.quant_matmul_plain(*ops)
    torch.cuda.synchronize()
    assert tqm.tile_n(M, N, torch.cuda.get_device_properties(0).multi_processor_count)
    assert torch.equal(got, want), (M, K, N, (got - want).abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(8000, 1536), (130, 257), (15680, 256)])
def test_quant_matmul_prefill_form_at_127_and_full_depth(M, N):
    """±127 operands at K = 8960: the int32 sums reach 8960 · 127² without
    overflow, and the epilogue gives the oracle's bits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(N)
    ops = _qmm_operands(gen, M, 8960, N, extreme=True)
    assert torch.equal(tqm.quant_matmul(*ops), tqm.quant_matmul_plain(*ops))


def _x_rows(gen, M, K, dtype, extreme=False, ties=False, stride=0):
    """x (M, K) on the card, viewed with row stride K + stride; with ties, row
    0 has max |x| 127 (scale exactly 1) and values k + 0.5, row 1 is zero."""
    x = torch.randn(M, K + stride, generator=gen, device="cuda") * 3
    if extreme:
        x = torch.where(x > 0, 127.0, -127.0)
    if ties:
        x[0, :K] = (torch.arange(K, device="cuda") % 254 - 127) + 0.5
        x[0, 0] = 127.0
        if M > 1:
            x[1] = 0.0
    return x.to(dtype)[:, :K]


def _int8_group(gen, K, Ns, extreme=False):
    group = []
    for N in Ns:
        if extreme:
            wt = torch.full((N, K), -127, dtype=torch.int8, device="cuda")
        else:
            wt = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                               dtype=torch.int8)
        group.append((wt.t(), torch.rand(N, generator=gen, device="cuda") * 0.02 + 1e-3))
    return group


# groups of 1-3 weights: Qwen2's q/k/v, gate/up and down, ragged K (1537,
# 255) and ragged widths (1, 129, 255)
QUANT_GROUPS = [(1536, (1536, 256, 256)), (1536, (8960, 8960)), (8960, (1536,)),
                (1537, (1, 129, 255)), (255, (129, 255))]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5, 8, 16, 17, 33])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_linear_kernels_match_plain_version(M, dtype):
    """``quant_linear`` (``qmm_group`` at M <= 16; ``quantize_rows_kernel``
    and ``qmm_wgmma`` above) bitwise against its plain version, for groups
    of 1-3 weights, ragged K and N, a row-strided x, ±127 operands and tie
    and zero rows; launches counted as the wrapper documents."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(M)
    cases = [dict(K=K, Ns=Ns) for K, Ns in QUANT_GROUPS]
    cases += [dict(K=1536, Ns=(1536, 256), stride=5), dict(K=8960, Ns=(255,), extreme=True),
              dict(K=1537, Ns=(300,), ties=True)]
    tk.reset_launch_counts()
    for c in cases:
        x = _x_rows(gen, M, c["K"], dtype, c.get("extreme", False), c.get("ties", False),
                    c.get("stride", 0))
        group = _int8_group(gen, c["K"], c["Ns"], c.get("extreme", False))
        got = tqm.quant_linear(x, group)
        want = tqm.quant_linear_plain(x, group)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, b), (M, c)
    counts = tk.launch_counts()
    prefill = M > tqm.SKINNY_M
    assert counts["quant_linear"] == sum(len(c["Ns"]) if prefill else 1 for c in cases)
    assert counts["quantize_rows"] == (len(cases) if prefill else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [5, 16])
def test_quant_linear_group_gives_the_same_bits_launch_after_launch(M):
    """``qmm_group`` at Qwen2's gate/up group (140 column tiles, clusters of
    one block, two blocks on some SMs; the weight ring wraps) equal to its
    plain version in each of 300 launches.  Without the proxy fence before a
    warp frees a ring stage, about 2 % of these launches read weight rows
    that the next TMA fill had overwritten."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(M)
    x = _x_rows(gen, M, 1536, torch.bfloat16)
    group = _int8_group(gen, 1536, (8960, 8960))
    want = tqm.quant_linear_plain(x, group)
    bad = torch.zeros((), dtype=torch.int64, device="cuda")
    for _ in range(300):
        got = tqm.quant_linear(x, group)
        bad += sum((a != b).any().long() for a, b in zip(got, want))
    assert int(bad) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 5, 8, 16, 17, 33, 7168])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_rows_kernel_matches_plain_version(M, dtype):
    """``ops.quantize_rows`` on the card (``quantize_rows_kernel``) bitwise
    against its plain version at K = 1536, 8960 and ragged 1537 and 255, a
    row-strided x, ±127 and tie and zero rows; one launch a call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(M + 1)
    tk.reset_launch_counts()
    calls = 0
    for K, kw in ((1536, {}), (8960, {}), (1537, dict(ties=True)), (255, dict(stride=3)),
                  (1536, dict(extreme=True))):
        x = _x_rows(gen, M, K, dtype, **kw)
        xq, xs = tops.quantize_rows(x)
        pq, ps = tqm.quantize_rows_plain(x)
        torch.cuda.synchronize()
        calls += 1
        assert torch.equal(xq, pq) and torch.equal(xs, ps), (M, K, kw)
    assert tk.launch_counts()["quantize_rows"] == calls


@pytest.mark.cuda
@pytest.mark.parametrize("K,Ns", [(1536, (1536, 256, 256)), (8960, (1536,)),
                                  (1152, (6912, 6912)), (20480, (7168,))])
def test_quant_linear_rows_are_batch_invariant(K, Ns):
    """Row m's outputs are bitwise the same at M = 1 and at M = 8, and
    bitwise the plain version's (LLaVA's down-projection, K = 20,480 over
    56 tiles, splits K over more blocks than a wave would give)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(K)
    x = _x_rows(gen, 8, K, torch.bfloat16)
    group = _int8_group(gen, K, Ns)
    eight = tqm.quant_linear(x, group)
    assert all(torch.equal(a, b) for a, b in zip(eight, tqm.quant_linear_plain(x, group)))
    for m in range(8):
        one = tqm.quant_linear(x[m:m + 1], group)
        assert all(torch.equal(a[0], b[m]) for a, b in zip(one, eight)), m


@pytest.mark.cuda
def test_int8_lm_engine_on_card_matches_slot_at_a_time():
    """Qwen2-1.5B's SMOKE widths with int8 weights on the card: continuous
    batching equals the slot-at-a-time oracle, and every projection of
    every forward went through the kernel (7 a layer)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Request, ServeEngine

    _need_card()
    cfg = dataclasses.replace(get_smoke("qwen2-1.5b"), quantize="int8")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=3, max_seq=64)

    def reqs():
        r = np.random.default_rng(3)
        return [Request(prompt=r.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=m)
                for n, m in zip((5, 9, 12, 7, 14), (3, 8, 5, 6, 4))]

    tk.reset_launch_counts()
    tqm.quant_linear.shapes.clear()
    served = eng.run(reqs())
    forwards = eng.calls["prefill_waves"] + eng.calls["decode_steps"]
    counts = tk.launch_counts()
    groups = tqm.quant_linear.shapes
    # 4 group calls a layer a forward: one launch each at M <= 16, one per
    # weight (and one quantize_rows) above
    assert sum(groups.values()) == 4 * cfg.num_layers * forwards > 0
    assert counts["quant_linear"] == sum(
        n * (1 if M <= tqm.SKINNY_M else len(Ns)) for (M, _, Ns), n in groups.items())
    assert counts["quantize_rows"] == sum(
        n for (M, _, _), n in groups.items() if M > tqm.SKINNY_M) > 0
    assert counts["quant_matmul"] == 0
    solo = [eng._run_one(r) for r in reqs()]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


@pytest.mark.cuda
def test_rmsnorm_kernel_matches_plain_version():
    """Mamba2's and Qwen2's served widths, fp32 and bf16, ragged widths
    (not a multiple of 32, or of a 16-byte chunk), an unaligned row base;
    a row gives the same bits alone as in a batch."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [((8, 2560), torch.bfloat16), ((1, 300, 2560), torch.bfloat16),
              ((8, 5120), torch.float32), ((2, 77, 5120), torch.float32),
              ((16, 1536), torch.bfloat16), ((5, 37), torch.float32),
              ((3, 37), torch.bfloat16), ((4, 1), torch.float32)]
    tk.reset_launch_counts()
    for shape, dtype in shapes:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
        w = 1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
        got, want = trn.rmsnorm(x, w), trn.rmsnorm_plain(x, w)
        assert got.dtype == dtype and got.shape == x.shape
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
            else dict(rtol=2.0 ** -7, atol=0.0)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        rows = x.reshape(-1, shape[-1])
        alone = trn.rmsnorm(rows[-1:].clone(), w)
        assert torch.equal(alone[0], got.reshape(-1, shape[-1])[-1])
    # a base 6 bytes past 16-byte alignment takes the element-by-element
    # loads, in the same order as the vector loads of the aligned copy
    flat = torch.randn(9 * 2560, generator=gen, device="cuda").to(torch.bfloat16)
    x = flat[3:3 + 8 * 2560].view(8, 2560)
    w = torch.ones(2560, device="cuda")
    assert torch.equal(trn.rmsnorm(x, w), trn.rmsnorm(x.clone(), w))
    torch.cuda.synchronize()
    assert tk.launch_counts()["rmsnorm"] == 2 * len(shapes) + 2


@pytest.mark.cuda
def test_rmsnorm_kernel_reads_a_bf16_scale_plus_one():
    """The models' call: a bf16 scale taken as 1 + scale, in the kernel,
    gives the bits of the kernel given w = 1 + scale in fp32; a bf16
    weight alone the bits of its fp32 copy."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for shape, dtype in (((8, 2560), torch.bfloat16), ((300, 5120), torch.float32),
                         ((3, 37), torch.bfloat16)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 3).to(dtype)
        s = (0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).to(torch.bfloat16)
        got = trn.rmsnorm(x, s, plus_one=True)
        assert torch.equal(got, trn.rmsnorm(x, 1.0 + s.float()))
        assert torch.equal(trn.rmsnorm(x, s), trn.rmsnorm(x, s.float()))
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
            else dict(rtol=2.0 ** -7, atol=0.0)
        torch.testing.assert_close(got.float(), trn.rmsnorm_plain(
            x, s, plus_one=True).float(), **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("with_h0", [True, False])
def test_ssd_kernel_matches_plain_version(with_h0):
    """Mamba2-2.7B's widths (P = 64, N = 128) over several chunks (L = 256
    and 64, up to S = 2,048) and at one ragged chunk L = S (301, 956, 998),
    L = 37, L = 1, narrower P and N, and the SMOKE widths (P = 16,
    N = 16), with log_a and dx contiguous and as the SSD layer passes them
    (transposed views)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(1, 80, 512, 64, 128, 256), (1, 80, 2048, 64, 128, 256),
             (1, 80, 1024, 64, 128, 64), (1, 80, 301, 64, 128, 301),
             (1, 80, 956, 64, 128, 956), (1, 80, 998, 64, 128, 998),
             (2, 3, 74, 64, 128, 37), (2, 5, 96, 37, 50, 48), (1, 4, 300, 61, 127, 300),
             (2, 2, 5, 16, 16, 1), (1, 16, 40, 16, 16, 40)]
    tk.reset_launch_counts()
    for (B, H, S, P, N, L), contiguous in itertools.product(cases, (True, False)):
        la, dx, Bm, Cm, h0 = _ssd_inputs(gen, B, H, S, P, N, with_h0)
        if contiguous:
            la, dx = la.contiguous(), dx.contiguous()
        y, h = tss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        yp, hp = tss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L)
        torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h, hp, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="P ≤ 64"):
        tss.ssd_chunk_scan(la, torch.zeros(B, H, S, 65, device="cuda"), Bm, Cm,
                           chunk=L)
    torch.cuda.synchronize()
    assert tk.launch_counts()["ssd_chunk_scan"] == 2 * len(cases)


def _ssd_inputs(gen, B, H, S, P, N, with_h0, served=False):
    """Mild decays (cum ≈ −0.1 a step), or with ``served`` the SSD layer's
    on a random model: log_a = −softplus(dt)·A, A in [1, 16] per head,
    dx = softplus(dt)·x, unit B and C (cum reaches −10⁴ over ~1,000 steps).
    log_a and dx are transposes of (B, S, H[, P]) tensors, as the layer
    passes them."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    if served:
        A = 1.0 + 15.0 * torch.rand(H, generator=gen, device="cuda")
        dt = torch.nn.functional.softplus(randn(B, S, H))
        la, dx = -dt * A, dt[..., None] * randn(B, S, H, P)
        Bm, Cm = randn(B, S, N), randn(B, S, N)
    else:
        la = -torch.rand(B, S, H, generator=gen, device="cuda") * 0.2
        dx, Bm, Cm = randn(B, S, H, P), randn(B, S, N) * 0.3, randn(B, S, N) * 0.3
    h0 = randn(B, H, P, N) * 0.1 if with_h0 else None
    return la.transpose(1, 2), dx.transpose(1, 2), Bm, Cm, h0


@pytest.mark.cuda
@pytest.mark.parametrize("S,L", [(1024, 256), (956, 956), (74, 37)])
def test_ssd_kernel_is_batch_and_call_invariant(S, L):
    """Head b of a batch of 3 is bitwise the same as the same head at
    B = 1, and a second call gives the first call's bits: every sum runs in
    an order fixed by (L, P, N) and the tile alone."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    la, dx, Bm, Cm, h0 = _ssd_inputs(gen, 3, 80, S, 64, 128, True, served=True)
    y, h = tss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
    y2, h2 = tss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    for b in (0, 2):
        one = slice(b, b + 1)
        y1, h1 = tss.ssd_chunk_scan(la[one], dx[one], Bm[one], Cm[one], h0[one], chunk=L)
        assert torch.equal(y1, y[one]) and torch.equal(h1, h[one])


@pytest.mark.cuda
@pytest.mark.parametrize("S,L,with_h0", [(1024, 256, True), (956, 956, True),
                                         (998, 998, False), (512, 256, False)])
def test_ssd_kernel_at_served_decays_against_fp64(S, L, with_h0):
    """At the decays a random Mamba2 layer makes (|cum| up to ~10⁴ over a
    chunk, where the order of the running sum moves the result), y and
    h_final are within chip_smoke.FP32_TOL (2e-4) of the same function in
    fp64, relative to their max |entry|."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    la, dx, Bm, Cm, h0 = _ssd_inputs(gen, 1, 80, S, 64, 128, with_h0, served=True)
    y, h = tss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
    y64, h64 = tss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L, dtype=torch.float64)
    for got, want in ((y, y64), (h, h64)):
        err = ((got.double() - want).abs().max() / want.abs().max()).item()
        assert err <= 2e-4, err


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,P,N,L", [(1, 80, 512, 64, 128, 1), (1, 80, 2048, 64, 128, 4),
                                         (2, 5, 96, 37, 50, 8)])
def test_ssd_kernel_workspace_is_bounded(B, H, S, P, N, L, monkeypatch):
    """At small L the stages' scratch would hold ~S/L states a head: the
    workspace stays within WORKSPACE_BYTES beside the (B, H, S) running
    sums, the stages run over segments of chunks, and the result is
    bitwise the same in segments of any length (down to one chunk) as in
    one segment, and within 1e-4 of the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(4)
    la, dx, Bm, Cm, h0 = _ssd_inputs(gen, B, H, S, P, N, True)
    lib = tss._lib()
    seg = lib.ssd_chunk_scan_segment(B, H, S, P, N, L, B * H * S + tss.WORKSPACE_BYTES // 4)
    work = 4 * lib.ssd_chunk_scan_workspace(B, H, S, P, N, L, seg)
    assert work <= 4 * (B * H * S + 4) + tss.WORKSPACE_BYTES
    if (B, H) == (1, 80):
        assert seg < S // L
    y, h = tss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
    yp, hp = tss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L)
    torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, hp, rtol=1e-4, atol=1e-4)
    for bound in (1, 1 << 40):               # one chunk a segment; one segment
        monkeypatch.setattr(tss, "WORKSPACE_BYTES", bound)
        y1, h1 = tss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        assert torch.equal(y1, y) and torch.equal(h1, h)


@pytest.mark.cuda
def test_mamba_engine_on_card_matches_slot_at_a_time():
    """Mamba2's SMOKE widths (fp32) on the card: per-request prefill and
    batched decode give the slot-at-a-time oracle's streams; every prefill
    ran the scan once a layer and every norm went through the kernel."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Request, ServeEngine

    _need_card()
    cfg = get_smoke("mamba2-2.7b")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=3, max_seq=128)

    def reqs():
        r = np.random.default_rng(3)
        return [Request(prompt=r.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=m)
                for n, m in zip((5, 64, 40, 7, 33), (3, 8, 5, 6, 4))]

    tk.reset_launch_counts()
    served = eng.run(reqs())
    steps = eng.calls["decode_steps"]
    assert eng.calls["prefill_waves"] == 0 and eng.calls["prefills"] == 5
    counts = tk.launch_counts()
    assert counts["ssd_chunk_scan"] == cfg.num_layers * 5
    # a prefill runs every norm; a decode step folds the block norms into
    # its fixed_linear launches (2 a layer) and runs the final norm alone
    assert counts["rmsnorm"] == (2 * cfg.num_layers + 1) * 5 + steps
    assert counts["fixed_linear"] == 2 * cfg.num_layers * steps > 0
    assert counts["ssd_decode"] == cfg.num_layers * steps
    solo = [eng._run_one(r) for r in reqs()]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


def _flash_tol(dtype):
    return dict(rtol=2e-4, atol=2e-4) if dtype == torch.float32 \
        else dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_match_plain_versions(dtype):
    """Both forms against their plain versions: hd 32, 64, 128 and 256,
    GQA 1:1 to 6:1, every mask, Sq < Sk, lengths that are not a multiple of
    the key tile nor of the tensor-core kernel's 16 rows, and rings that
    have wrapped (pos ≥ slots).  Every bf16 prefill takes the tensor-core
    route and every fp32 one the fp32 kernel."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    tk.reset_launch_counts()
    prefill = [((2, 12, 2, 100, 100, 128), dict()),
               ((1, 4, 1, 37, 600, 256), dict(window=512)),
               ((2, 4, 1, 64, 64, 256), dict(chunk=16)),
               ((3, 4, 4, 33, 33, 32), dict(causal=False)),
               ((1, 8, 2, 1, 77, 64), dict(window=20)),
               ((2, 6, 1, 45, 45, 64), dict()),                # 6:1, Sq % 16 != 0
               ((1, 6, 1, 23, 200, 32), dict(window=64)),      # 6:1, Sq < Sk
               ((2, 4, 2, 130, 130, 64), dict(chunk=48)),
               ((1, 12, 2, 77, 300, 128), dict(causal=False, window=90))]
    for (B, H, KV, Sq, Sk, hd), kw in prefill:
        q, k, v = randn(B, H, Sq, hd), randn(B, KV, Sk, hd), randn(B, KV, Sk, hd)
        torch.testing.assert_close(tfa.flash_attention(q, k, v, **kw).float(),
                                   tfa.flash_attention_plain(q, k, v, **kw).float(),
                                   **_flash_tol(dtype))
    decode = [((8, 4, 1, 512, 256), dict(window=512),
               [0, 100, 511, 512, 600, 1500, 7, 2047]),
              ((8, 12, 2, 2048, 128), dict(), [0, 1, 31, 32, 1000, 2047, 5, 64]),
              ((3, 4, 1, 16, 32), dict(chunk=16), [5, 31, 100])]
    for (B, H, KV, slots, hd), kw, pos in decode:
        q, kc, vc = randn(B, H, hd), randn(B, slots, KV, hd), randn(B, slots, KV, hd)
        p = torch.tensor(pos, device="cuda")
        torch.testing.assert_close(
            tfa.flash_attention_decode(q, kc, vc, p, **kw).float(),
            tfa.flash_attention_decode_plain(q, kc, vc, p, **kw).float(),
            **_flash_tol(dtype))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(randn(1, 2, 8, 48), randn(1, 2, 8, 48), randn(1, 2, 8, 48))
    with pytest.raises(ValueError, match="at most 16"):
        tfa.flash_attention_decode(randn(1, 32, 32), randn(1, 8, 1, 32),
                                   randn(1, 8, 1, 32), torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention"] == len(prefill)
    assert tk.launch_counts()["flash_attention_decode"] == len(decode)
    assert dict(tfa.flash_attention.routes) == {tfa.ROUTES[dtype]: len(prefill)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_are_batch_and_padding_invariant(dtype):
    """Bitwise: a prompt's rows at B = 1 and its exact length equal the same
    rows in a right-padded batch of 8; a decode row alone equals it in a
    batch of 8, and over a global cache of exactly pos + 1 slots the same as
    over 2,048."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    lens = [40, 127, 128, 300, 513, 700, 1023, 1024]
    S = 1024
    tk.reset_launch_counts()
    for H, KV, hd, kw in ((4, 1, 256, dict(window=512)), (12, 2, 128, dict()),
                          (6, 1, 64, dict()), (4, 2, 32, dict(window=100))):
        q, k, v = randn(8, H, S, hd), randn(8, KV, S, hd), randn(8, KV, S, hd)
        batch = tfa.flash_attention(q, k, v, **kw)
        for b, n in enumerate(lens):
            alone = tfa.flash_attention(q[b:b + 1, :, :n], k[b:b + 1, :, :n],
                                        v[b:b + 1, :, :n], **kw)
            assert torch.equal(alone[0], batch[b, :, :n]), (H, n)
        slots = 2048
        qd, kc, vc = randn(8, H, hd), randn(8, slots, KV, hd), randn(8, slots, KV, hd)
        pos = torch.tensor(lens, device="cuda") - 1
        batch = tfa.flash_attention_decode(qd, kc, vc, pos, **kw)
        for b, n in enumerate(lens):
            alone = tfa.flash_attention_decode(qd[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                               pos[b:b + 1], **kw)
            exact = tfa.flash_attention_decode(qd[b:b + 1], kc[b:b + 1, :n],
                                               vc[b:b + 1, :n], pos[b:b + 1], **kw)
            assert torch.equal(alone[0], batch[b]) and torch.equal(exact[0], batch[b])
    assert set(tfa.flash_attention.routes) == {tfa.ROUTES[dtype]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_decode_route_is_the_bf16_route_over_dequantized_caches(dtype):
    """The decode form over an int8 cache (codes and an fp32 scale a slot
    and kv head) is, bitwise, the same form over the caches the reference's
    ``_cache_read`` dequantizes (bf16, widened for an fp32 q), at Qwen2's
    and Gemma3's global and ring shapes, a chunked and a 6:1 ring, with
    ragged and stale (pos ≥ slots) positions; and within the tolerance of
    the plain version.  Each launch counts on the int8 route."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    cases = [((8, 12, 2, 2048, 128), dict(), [0, 1, 127, 128, 1000, 2047, 5, 4000]),
             ((8, 4, 1, 2048, 256), dict(), [63, 64, 65, 300, 2047, 0, 1500, 9]),
             ((8, 4, 1, 512, 256), dict(window=512), [0, 100, 511, 512, 600, 1500, 7, 2047]),
             ((3, 4, 1, 16, 32), dict(chunk=16), [5, 31, 100]),
             ((5, 6, 1, 77, 64), dict(window=50), [3, 76, 77, 200, 31])]
    tk.reset_launch_counts()
    for (B, H, KV, slots, hd), kw, pos in cases:
        q = torch.randn(B, H, hd, generator=gen, device="cuda").to(dtype)
        codes = [torch.randint(-127, 128, (B, slots, KV, hd), generator=gen, device="cuda",
                               dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand(B, slots, KV, generator=gen, device="cuda") * 0.05 + 1e-8
                  for _ in range(2)]
        p = torch.tensor(pos, device="cuda")
        got = tfa.flash_attention_decode(q, *codes, p, k_scale=scales[0], v_scale=scales[1],
                                         **kw)
        kd, vd = (tfa.cache_read(c, sc).to(dtype) for c, sc in zip(codes, scales))
        want = tfa.flash_attention_decode(q, kd, vd, p, **kw)
        assert torch.equal(got, want), ((B, H, KV, slots, hd), kw)
        torch.testing.assert_close(
            got.float(), tfa.flash_attention_decode_plain(
                q, *codes, p, k_scale=scales[0], v_scale=scales[1], **kw).float(),
            **_flash_tol(dtype))
    torch.cuda.synchronize()
    routes = dict(tfa.flash_attention_decode.routes)
    assert routes == {"int8": len(cases), tfa.DECODE_ROUTES[dtype]: len(cases)}, routes


def _tail_from_full(q, k, v, start, ring):
    """The tail prefill's operands cut from a full prefill's: rows from
    ``start[b]`` on (padded to the longest tail), and a ring cache of
    ``ring`` slots holding what a full prefill leaves at positions below
    ``start[b]`` (slot p mod ring, the last ring of them)."""
    B, KV, S, hd = k.shape
    L = [S - s for s in start]
    Sq = max(L)

    def cut(t):
        out = torch.zeros(t.shape[0], t.shape[1], Sq, hd, dtype=t.dtype, device=t.device)
        for b, s in enumerate(start):
            out[b, :, :S - s] = t[b, :, s:]
        return out

    caches = []
    for t in (k, v):
        c = torch.zeros(B, ring, KV, hd, dtype=t.dtype, device=t.device)
        for b, s in enumerate(start):
            for p_ in range(max(0, s - ring), s):
                c[b, p_ % ring] = t[b, :, p_]
        caches.append(c)
    dev = q.device
    return (cut(q), cut(k), cut(v), *caches, torch.tensor(start, device=dev),
            torch.tensor(L, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tail_rows_are_the_full_prefill_rows(dtype):
    """The tail form over a restored prefix gives, bitwise, the full
    prefill's rows at the same positions: global, window and chunk masks,
    prefix lengths that are not multiples of the key tile (32 or 64), a
    tile straddling prefix and tail; and it stays within the tolerance of
    its plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    S = 700
    start = [37, 100, 300, 513]
    cases = [((12, 2, 128), dict(), S), ((4, 1, 256), dict(), S),
             ((4, 1, 256), dict(window=512), 512), ((4, 2, 64), dict(chunk=128), 128)]
    tk.reset_launch_counts()
    for (H, KV, hd), kw, ring in cases:
        q = torch.randn(4, H, S, hd, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(4, KV, S, hd, generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        full = tfa.flash_attention(q, k, v, **kw)
        tq, tk_, tv, kc, vc, st, L = _tail_from_full(q, k, v, start, ring)
        got = tfa.flash_attention_tail(tq, tk_, tv, kc, vc, st, L, **kw)
        for b, s in enumerate(start):
            assert torch.equal(got[b, :, :S - s], full[b, :, s:]), ((H, KV, hd), kw, s)
        torch.testing.assert_close(
            got.float(), tfa.flash_attention_tail_plain(tq, tk_, tv, kc, vc, st, L,
                                                        **kw).float(),
            **_flash_tol(dtype))
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention_tail"] == len(cases)


@pytest.mark.cuda
def test_flash_prefill_terms_reading():
    """The tensor-core prefill kernel with p in three bf16 terms is the
    served kernel, bitwise; with p in one term it leaves the bf16
    tolerance of the plain version."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(*shape, generator=gen, device="cuda").bfloat16()
               for shape in ((1, 4, 512, 256), (1, 1, 512, 256), (1, 1, 512, 256)))
    want = tfa.flash_attention_plain(q, k, v).float()
    allowed = 1e-6 + 2.0 ** -7 * want.abs()
    assert torch.equal(tfa.flash_attention_terms(q, k, v, 3), tfa.flash_attention(q, k, v))
    one = tfa.flash_attention_terms(q, k, v, 1).float()
    assert ((one - want).abs() > allowed).any()


@pytest.mark.cuda
def test_gemma3_engine_on_card_matches_slot_at_a_time():
    """Gemma3's SMOKE widths (fp32, a 32-slot ring on the local layer) on
    the card: continuous batching equals the slot-at-a-time oracle over
    prompts and decodes that wrap the ring, and every attention went
    through kernel 6 (one prefill launch a layer a wave, one decode launch
    a layer a step)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Request, ServeEngine

    _need_card()
    cfg = get_smoke("gemma3-1b")
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=3, max_seq=96)

    def reqs():
        r = np.random.default_rng(3)
        return [Request(prompt=r.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=m)
                for n, m in zip((5, 33, 12, 40, 31, 3), (30, 8, 25, 6, 20, 9))]

    tk.reset_launch_counts()
    served = eng.run(reqs())
    counts = tk.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers * eng.calls["prefill_waves"] > 0
    assert counts["flash_attention_decode"] == cfg.num_layers * eng.calls["decode_steps"]
    solo = [eng._run_one(r) for r in reqs()]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_kernel_at_span_boundaries(dtype):
    """The decode form splits the slots into spans from slot 0 (64 slots at
    hd 256, 128 below) and merges them in span order: against its plain
    version at positions either side of a span boundary, on a ring that is not a multiple of
    the span and on wrapped rings; bitwise the same alone and in a batch of
    8, and over exactly pos + 1 slots."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    edges = [63, 64, 65, 127, 128, 255, 257, 2047]
    cases = [((8, 4, 1, 2048, 256), dict(), edges),
             ((8, 12, 2, 2048, 128), dict(), edges),
             ((8, 4, 1, 512, 256), dict(window=512), [300, 511, 512, 513, 640, 1124, 2047, 0]),
             ((4, 6, 1, 300, 64), dict(window=200), [128, 299, 300, 777])]
    tk.reset_launch_counts()
    launched = 0
    for (B, H, KV, slots, hd), kw, pos in cases:
        q, kc, vc = randn(B, H, hd), randn(B, slots, KV, hd), randn(B, slots, KV, hd)
        p = torch.tensor(pos, device="cuda")
        batch = tfa.flash_attention_decode(q, kc, vc, p, **kw)
        launched += 1
        torch.testing.assert_close(
            batch.float(), tfa.flash_attention_decode_plain(q, kc, vc, p, **kw).float(),
            **_flash_tol(dtype))
        for b, n in enumerate(pos):
            alone = tfa.flash_attention_decode(q[b:b + 1], kc[b:b + 1], vc[b:b + 1],
                                               p[b:b + 1], **kw)
            assert torch.equal(alone[0], batch[b]), (slots, n)
            launched += 1
            if n < slots:
                exact = tfa.flash_attention_decode(q[b:b + 1], kc[b:b + 1, :n + 1],
                                                   vc[b:b + 1, :n + 1], p[b:b + 1], **kw)
                assert torch.equal(exact[0], batch[b]), (slots, n)
                launched += 1
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention_decode"] == launched


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_head_kernel_matches_plain_and_is_batch_invariant(dtype):
    """``lm_head`` against its plain version (fp64 sums rounded to fp32),
    tied and untied, at rtol = atol = 2e-4 (the kernel sums in fp32), and
    row m bitwise the same at M = 1 and M = 8 (and in an M-tile of 13)."""
    from repro_torch.kernels import lm_head as tlm

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(9)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    tk.reset_launch_counts()
    n = 0
    for tied, D, V in ((True, 1152, 5003), (True, 2560, 777), (False, 256, 1048)):
        w = randn(V, D) if tied else randn(D, V)
        x = randn(13, D)
        full = tlm.lm_head(x, w, tied=tied)
        torch.testing.assert_close(full, tlm.lm_head_plain(x, w, tied=tied),
                                   rtol=2e-4, atol=2e-4)
        eight = tlm.lm_head(x[:8], w, tied=tied)
        n += 2
        for m in range(8):
            one = tlm.lm_head(x[m:m + 1], w, tied=tied)
            n += 1
            assert torch.equal(one[0], eight[m]) and torch.equal(one[0], full[m]), (D, m)
    with pytest.raises(ValueError, match="multiple of 8"):
        tlm.lm_head(randn(2, 100), randn(50, 100), tied=True)
    torch.cuda.synchronize()
    assert tk.launch_counts()["lm_head"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("D,V", [(1152, 262144), (1536, 151936), (2560, 50280),
                                 (2560, 50280 + 7 * 8)])
def test_lm_head_served_shapes_on_the_tensor_cores(D, V):
    """The served heads (bf16, tied) at Gemma3-1B's, Qwen2-1.5B's and
    Mamba2-2.7B's (D, V), and a V whose last 16-row tile is ragged by 8:
    the tensor-core route, within rtol = atol = 2e-4 of the fp64 plain
    version, and row m bitwise the same at M = 1 and M = 8."""
    from repro_torch.kernels import lm_head as tlm

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(D + V)
    w = torch.randn(V, D, generator=gen, device="cuda").bfloat16()
    x = torch.randn(8, D, generator=gen, device="cuda").bfloat16()
    tlm.lm_head.routes.clear()
    eight = tlm.lm_head(x, w, tied=True)
    torch.testing.assert_close(eight, tlm.lm_head_plain(x, w, tied=True),
                               rtol=2e-4, atol=2e-4)
    for m in range(8):
        assert torch.equal(tlm.lm_head(x[m:m + 1], w, tied=True)[0], eight[m]), m
    assert tlm.lm_head.routes == {"mma_bf16": 9}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-2.7b"])
def test_graph_replayed_engine_equals_eager(arch):
    """The engine's decode steps as CUDA graph replays give the eager
    engine's streams token for token; every step but the warm-up before
    each capture is a replay, and the launch counts stay exact."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Request, ServeEngine

    _need_card()
    cfg = get_smoke(arch)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    graphed = ServeEngine(cfg, params, batch_size=3, max_seq=96)
    eager = ServeEngine(cfg, params, batch_size=3, max_seq=96)
    eager._graphed = False

    def reqs():
        r = np.random.default_rng(4)
        return [Request(prompt=r.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=m)
                for n, m in zip((5, 40, 12, 33, 3), (20, 8, 25, 6, 9))]

    tk.reset_launch_counts()
    served = graphed.run(reqs())
    counts = tk.launch_counts()
    calls = graphed.calls
    assert calls["decode_eager"] == 1
    assert calls["decode_graph_replays"] == calls["decode_steps"] - 1 > 0
    # every norm at a prefill, the final one alone at a decode step (the
    # block norms fold into the decode products)
    assert counts["rmsnorm"] == (2 * cfg.num_layers + 1) * (
        calls["prefills"] + calls["prefill_waves"]) + calls["decode_steps"]
    assert counts["lm_head"] == calls["prefills"] + calls["prefill_waves"] + calls["decode_steps"]
    want = eager.run(reqs())
    assert eager.calls["decode_graph_replays"] == 0
    assert [r.out_tokens for r in served] == [r.out_tokens for r in want]
    solo = [graphed._run_one(r) for r in reqs()]
    assert graphed.calls["decode_eager"] == 2
    assert [r.out_tokens for r in solo] == [r.out_tokens for r in want]


@pytest.mark.cuda
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "int8"])
def test_span_graph_replay_equals_the_eager_span_step(cache_dtype):
    """The router's span decode (a step over views of the first lanes of
    the shared cache) replayed from its CUDA graph gives, bitwise, the
    logits and the cache the same step run eagerly gives on a copy of the
    cache; lanes past the span keep their bits.  With the int8 KV cache
    every attention layer's decode launch takes the int8 route."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Request, ServeEngine

    _need_card()
    cfg = dataclasses.replace(get_smoke("qwen2-1.5b"), dtype="bfloat16",
                              cache_dtype=cache_dtype)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=4, max_seq=64)
    cache = eng.init_shared_cache()
    r = np.random.default_rng(5)
    reqs = [Request(prompt=r.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=4) for n in (5, 17, 9, 30)]
    cache, first = eng._prefill_into(cache, list(enumerate(reqs)))
    toks = torch.as_tensor(first[:2, None], device="cuda")
    pos = torch.tensor([5, 17], device="cuda")

    def copy(c):
        return {k: copy(v) for k, v in c.items()} if isinstance(c, dict) else c.clone()

    def leaves(c):
        return [t for v in c.values() for t in (leaves(v) if isinstance(v, dict) else [v])]

    # a step on a copy runs eagerly; the first on the shared cache runs
    # eagerly and captures the span's graph
    eng.decode_span(2, toks, pos, copy(cache))
    assert eng.calls["decode_eager"] == 1 and not eng._graphs
    got = eng.decode_span(2, toks, pos, cache)
    toks, pos = torch.argmax(got[:, -1], -1)[:, None].to(toks.dtype), pos + 1
    for step in range(3):
        before = copy(cache)
        want, sub = eng.model.decode_step(eng.params, toks, pos,
                                          ServeEngine.span_views(copy(cache), 2))
        tk.reset_launch_counts()
        got = eng.decode_span(2, toks, pos, cache)
        torch.cuda.synchronize()
        assert torch.equal(got, want), step
        for a, b, c in zip(leaves(cache), leaves(sub), leaves(before)):
            assert torch.equal(a[:, :2], b) and torch.equal(a[:, 2:], c[:, 2:])
        launched = tfa.flash_attention_decode.routes
        assert launched == {("int8" if cache_dtype == "int8" else "bf16"): cfg.num_layers}
        toks, pos = torch.argmax(got[:, -1], -1)[:, None].to(toks.dtype), pos + 1
    assert eng.calls["decode_graph_replays"] == 3 and eng.calls["decode_eager"] == 2


# ------------------------------------------------------------------------- #
# fixed_linear and ssd_decode: the decode step's fixed-order kernels
# ------------------------------------------------------------------------- #

# (M, K, Ns): Mamba2-2.7B's in- and out-projections, Qwen2-1.5B's q/k/v,
# gate/up and down, ragged widths, and Qwen2-1.5B's o
FIXED_SHAPES = [(8, 2560, (5120, 5120, 128, 128, 80)), (8, 5120, (2560,)),
                (8, 1536, (1536, 256, 256)), (8, 1536, (8960, 8960)), (8, 8960, (1536,)),
                (3, 64, (1, 17, 100)), (16, 264, (40,)), (1, 520, (33, 7)),
                (8, 1536, (1536,))]
# (M, K, Ns) above 16 rows: a prefill wave's q/k/v, gate/up and down at
# Qwen2-1.5B's widths, ragged M, N and K (K = 520: a partial group of 32),
# Qwen2-1.5B's o and Mamba2-2.7B's in- and out-projections
TILED_SHAPES = [(200, 1536, (1536, 256, 256)), (130, 1536, (8960, 8960)),
                (70, 8960, (1536,)), (17, 64, (1, 17, 100)), (65, 520, (33, 7, 300)),
                (64, 1536, (1536,)), (100, 2560, (5120, 5120, 128, 128, 80)),
                (33, 5120, (2560,))]
# (K, Ns, prologue) at every served width: Mamba2-2.7B's in-projections
# (behind the block's norm) and out-projection (behind the gated norm),
# Qwen2-1.5B's q/k/v and gate/up (behind the block's norm), o and down; and
# the row counts a row is held bitwise across (the decode form to 16 rows,
# the tiled form above, but behind a norm)
SERVED_WIDTHS = [(2560, (5120, 5120, 128, 128, 80), "norm"), (5120, (2560,), "gated"),
                 (1536, (1536, 256, 256), "norm"), (1536, (1536,), None),
                 (1536, (8960, 8960), "norm"), (8960, (1536,), None)]
ACROSS_M = (1, 8, 16, 17, 64, 65, 1000)


def _fixed_close(got, want):
    """Within 2e-4 of max |want| (``tests/test_kernels.py``'s fp32 tolerance:
    the kernel sums in fp32 where the plain version sums in fp64), and bf16
    outputs one bf16 step more (the two sums round either side of a
    boundary)."""
    g, w = got.float(), want.float()
    lim = 2e-4 * w.abs().max().clamp(min=1e-30)
    if got.dtype == torch.bfloat16:
        lim = lim + torch.maximum(g.abs(), w.abs()) * 2.0 ** -7
    return bool(((g - w).abs() <= lim).all())


def _fixed_operands(gen, M, K, Ns, dtype):
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    ws = [(torch.randn(N, K, generator=gen, device="cuda") / K ** 0.5).to(dtype).t()
          for N in Ns]
    scale = (torch.randn(K, generator=gen, device="cuda") * 0.1).to(dtype)
    z = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    return x, ws, scale, z


def _prologue(x, scale, z, prologue):
    """(what the product is handed, its norm=): x; x behind the model's
    norm; or Mamba-2's gate y·silu(z) in fp32 behind the gated norm's."""
    if prologue == "norm":
        return x, {"norm": (scale, 1e-6, True)}
    if prologue == "gated":
        return x.float() * torch.nn.functional.silu(z.float()), {"norm": (scale, 1e-5, False)}
    return x, {}


def _normed(x, scale, z, prologue):
    """The rows an unfused product is handed behind the prologue: the
    ``rmsnorm`` kernel's, or the layer's gated norm's (which runs that
    kernel).  The folded prologue hands the product these rows bit for bit
    (``test_fixed_linear_folded_norms_equal_the_unfused_composition``)."""
    if prologue == "norm":
        return tops.rmsnorm(x, scale, 1e-6, plus_one=True)
    return tlssd._gated_norm(x, z, scale, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("prologue", [None, "norm", "gated"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fixed_linear_kernel_matches_plain_version(dtype, prologue):
    """``fixed_linear`` against its plain version at every served width
    (decode and wave row counts) and ragged ones, with each prologue; one
    launch a call on the route of its dtype.  Behind a norm the plain
    product is taken of the rows the norm's own kernel gives (``_normed``):
    an element of the normed row one bf16 step from ``rmsnorm_plain``'s
    moves the product by more than the sum's tolerance, and the norm's
    kernel is held to its plain version by its own test."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    tk.reset_launch_counts()
    routes = collections.Counter()
    for M, K, Ns in FIXED_SHAPES + TILED_SHAPES:
        x0, ws, scale, z = _fixed_operands(gen, M, K, Ns, dtype)
        x, kw = _prologue(x0, scale, z, prologue)
        outs = [dtype] + [torch.float32] * (len(Ns) - 1)
        way = tfl.route(dtype, x.dtype, bool(kw), M)
        if way != "mma_bf16_tiled" and K > tfl.max_k(dtype, x.dtype, bool(kw)):
            with pytest.raises(ValueError, match="the kernel takes K"):
                tfl.fixed_linear(x, ws, outs, **kw)
            continue
        routes[way] += 1
        got = tfl.fixed_linear(x, ws, outs, **kw)
        want = tfl.fixed_linear_plain(_normed(x0, scale, z, prologue) if kw else x, ws, outs)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _fixed_close(a, b), (M, K, Ns, prologue)
    launched = sum(routes.values())
    assert tk.launch_counts()["fixed_linear"] == launched >= len(FIXED_SHAPES) - 1
    assert dict(tfl.fixed_linear.routes) == dict(routes)
    assert ("mma_bf16_tiled" in routes) == (dtype == torch.bfloat16 and prologue is None)


@pytest.mark.cuda
def test_fixed_linear_tiled_rows_equal_the_decode_form():
    """Above 16 rows (bf16, no norm: a prefill wave) the tiled form sums
    each output as the decode form does: every row bitwise equal to the
    same row alone, at ragged M, N and K, with a row-strided x."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for M, K, Ns in TILED_SHAPES:
        x, ws, _, _ = _fixed_operands(gen, M, K, Ns, torch.bfloat16)
        outs = [torch.bfloat16] + [torch.float32] * (len(Ns) - 1)
        tfl.fixed_linear.routes.clear()
        many = tfl.fixed_linear(x, ws, outs)
        assert dict(tfl.fixed_linear.routes) == {"mma_bf16_tiled": 1}
        for m in sorted({0, 1, 62, 63, 64, M // 2, M - 1} & set(range(M))):
            one = tfl.fixed_linear(x[m:m + 1], ws, outs)
            assert all(torch.equal(a[0], b[m]) for a, b in zip(one, many)), (M, K, m)
    wide = torch.randn(100, 2 * 264, generator=gen, device="cuda").to(torch.bfloat16)
    (w,) = _fixed_operands(gen, 1, 264, (72,), torch.bfloat16)[1]
    strided = tfl.fixed_linear(wide[:, :264], [w])[0]
    assert torch.equal(strided, tfl.fixed_linear(wide[:, :264].contiguous(), [w])[0])
    assert torch.equal(strided[7], tfl.fixed_linear(wide[7:8, :264], [w])[0][0])


def _chain_probe():
    """``tests/csrc/mma_chain_probe.cu`` built with the kernels' flags and
    loaded (its entry point: the outputs of one chain of k16 steps through
    mma.sync and through wgmma)."""
    import ctypes
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    src = Path(__file__).resolve().parent / "csrc" / "mma_chain_probe.cu"
    out = _build.BUILD_DIR / "libmma_chain_probe.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.find_nvcc(), *_build._FLAGS, "-I", str(_build.CSRC), "-o", str(out),
                    str(src)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P = ctypes.c_void_p
    lib.mma_chain_probe.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                    P, P, P, P, P, P]
    lib.mma_chain_probe.restype = ctypes.c_int
    return lib


def _chain_operands(gen, kind, N, K):
    """x (64, K) and w (N, K) bf16: normal values; products that cancel in
    pairs within a k16 step (exactly, or to a bf16 step); exponents over
    2^-24..2^24; or a first half of large positive products that the second
    half takes back."""
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    x, w = r(64, K), r(N, K)
    if kind == "cancel":
        x[:, 1::2] = x[:, 0::2]
        w[:, 1::2] = -w[:, 0::2] * torch.where(r(N, K // 2) > 0, 1.0, 1.0 + 2.0 ** -6)
    elif kind == "wide":
        e = lambda *s: torch.randint(-24, 25, s, generator=gen, device="cuda")  # noqa: E731
        x, w = x * 2.0 ** e(64, K), w * 2.0 ** e(N, K)
    elif kind == "halves":
        x, w = x.abs(), 1000 * w.abs()
        w[:, K // 2:] *= -1
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


@pytest.mark.cuda
def test_tensor_core_chain_is_the_same_bits_in_mma_sync_and_wgmma():
    """The probe behind ``fixed_linear``'s sum order: a chain of 16 bf16 k16
    steps at natural positions, accumulated by the tensor core (the first
    step from zero), gives the same fp32 bits through ``mma.sync.m16n8k16``
    (the decode form: weights as A) as through ``wgmma.m64nNk16`` (the
    tiled form: x as A) at N = 64, 128 and 256, and with the operands'
    sides swapped; k16 steps of zeros past the data leave the chain as it
    is.  Prints how many outputs the per-step order (each step from zero,
    IEEE adds) gives other bits."""
    _need_card()
    lib = _chain_probe()
    gen = torch.Generator(device="cuda").manual_seed(7)
    K = 256
    stream = torch.cuda.current_stream().cuda_stream
    for N, kind in itertools.product((64, 128, 256), ("normal", "cancel", "wide", "halves")):
        x, w = _chain_operands(gen, kind, N, K)
        outs = [torch.full((64, N), float("nan"), device="cuda") for _ in range(5)]
        wg, swap, wa, xa, steps = outs
        assert lib.mma_chain_probe(x.data_ptr(), w.data_ptr(), K, N, K,
                                   *[o.data_ptr() for o in outs], stream) == 0
        torch.cuda.synchronize()
        swap = swap.view(N, 64).t()
        assert torch.equal(wg, wa) and torch.equal(wg, xa) and torch.equal(wg, swap), (N, kind)
        ref = x.double() @ w.double().t()
        size = x.double().abs() @ w.double().abs().t()
        assert bool(((wg.double() - ref).abs() <= 1e-4 * size + 1e-30).all()), (N, kind)
        print(f"chain probe N={N} {kind}: mma.sync == wgmma == swapped sides bitwise; the "
              f"per-step order differs in {int((steps != wg).sum())} of {wg.numel()}")
    # zero steps past K: the chain over 208 elements, and over 256 whose last
    # 48 are zeros (the tiled form's TMA fill), the same bits
    x, w = _chain_operands(gen, "normal", 128, K)
    x[:, 208:] = 0
    w[:, 208:] = 0
    full, short = (torch.empty(64, 128, device="cuda") for _ in range(2))
    spare = [torch.empty(64, 128, device="cuda") for _ in range(3)]
    assert lib.mma_chain_probe(x.data_ptr(), w.data_ptr(), K, 128, K, full.data_ptr(), None,
                               *[t.data_ptr() for t in spare], stream) == 0
    assert lib.mma_chain_probe(x.data_ptr(), w.data_ptr(), K, 128, 208, None, None,
                               short.data_ptr(), spare[1].data_ptr(), spare[2].data_ptr(),
                               stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(full, short) and torch.equal(spare[0], short)


@pytest.mark.cuda
def test_fixed_linear_rows_are_bitwise_the_same_across_both_forms():
    """At every served width, with its served N and with a ragged one: the
    rows of a launch of M = 1000 bitwise the same as in launches of M = 1,
    8, 16 (the decode form) and 17, 64, 65 (the tiled form, or the decode
    form behind a norm), and from a row-strided x; behind a norm, every row
    bitwise the unfused composition (the norm's own kernel, then the product
    on the tiled form at M = 1000)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    for K, Ns, prologue in SERVED_WIDTHS:
        for widths in (Ns, (Ns[0] - 5,) + Ns[1:]):
            x0, ws, scale, z = _fixed_operands(gen, ACROSS_M[-1], K, widths, torch.bfloat16)
            x, kw = _prologue(x0, scale, z, prologue)
            outs = [torch.bfloat16] + [torch.float32] * (len(widths) - 1)
            what = (K, widths, prologue)
            full = tfl.fixed_linear(x, ws, outs, **kw)
            for M in ACROSS_M[:-1]:
                part = tfl.fixed_linear(x[:M], ws, outs, **kw)
                assert all(torch.equal(a, b[:M]) for a, b in zip(part, full)), (what, M)
            for m in (7, 16, 64, 999):
                one = tfl.fixed_linear(x[m:m + 1], ws, outs, **kw)
                assert all(torch.equal(a[0], b[m]) for a, b in zip(one, full)), (what, m)
            wide = torch.zeros(ACROSS_M[-1], K + 64, dtype=x.dtype, device="cuda")
            wide[:, 8:8 + K] = x
            for M in (8, 65):
                strided = tfl.fixed_linear(wide[:M, 8:8 + K], ws, outs, **kw)
                assert all(torch.equal(a, b[:M]) for a, b in zip(strided, full)), (what, M)
            if prologue is not None:
                tfl.fixed_linear.routes.clear()
                unfused = tfl.fixed_linear(_normed(x0, scale, z, prologue), ws, outs)
                assert dict(tfl.fixed_linear.routes) == {"mma_bf16_tiled": 1}
                assert all(torch.equal(a, b) for a, b in zip(unfused, full)), what


@pytest.mark.cuda
@pytest.mark.parametrize("K,Ns", [(2560, (80000,)), (8960, (4000,))])
def test_fixed_linear_decode_form_runs_its_waves(K, Ns):
    """Widths whose partials do not fit a block at once: the decode form
    runs its tiles in waves (a second cluster barrier a wave), within the
    tolerance of the plain version, row m bitwise the same at M = 1 and
    M = 8."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(13)
    x, ws, _, _ = _fixed_operands(gen, 8, K, Ns, torch.bfloat16)
    plan = tfl.plan(torch.bfloat16, None, K, Ns)
    tiles = sum((N + 15) // 16 for N in Ns)
    assert plan["clusters"] * plan["wave"] < tiles       # more than one wave
    got = tfl.fixed_linear(x, ws)
    want = tfl.fixed_linear_plain(x, ws)
    torch.cuda.synchronize()
    assert _fixed_close(got[0], want[0])
    for m in (0, 5):
        assert torch.equal(tfl.fixed_linear(x[m:m + 1], ws)[0][0], got[0][m])


@pytest.mark.cuda
@pytest.mark.parametrize("K,Ns,prologue", [(12800, (4096,), None), (8192, (1024,), "norm"),
                                           (8192, (1024,), "gated")])
def test_fixed_linear_decode_form_takes_wide_rows(K, Ns, prologue):
    """The decode form takes K = 12,800 (Granite-3-8B's d_ff) without a
    norm, x's rows staged in phases of 4,096 elements, and K = 8,192 behind
    either norm (the rows whole; behind the block's norm with an fp32 scale,
    beside one piece a warp): within the tolerance of the plain product of
    the rows it reads, row m bitwise the same at M = 1, 8 and 16, and behind
    a norm bitwise the unfused composition."""
    _need_card()
    bf16, f32 = torch.bfloat16, torch.float32
    assert tfl.max_k(bf16, bf16, False) >= 12800
    assert min(tfl.max_k(bf16, bf16, True), tfl.max_k(bf16, f32, True)) >= 8192
    gen = torch.Generator(device="cuda").manual_seed(17)
    x0, ws, scale, z = _fixed_operands(gen, 16, K, Ns, bf16)
    scale = scale.float()
    x, kw = _prologue(x0, scale, z, prologue)
    plan = tfl.plan(x.dtype, scale.dtype if kw else None, K, Ns)
    assert plan["phases"] == (1 if kw else 4)
    assert (plan["pieces"] == 1) == (prologue == "norm")
    sixteen = tfl.fixed_linear(x, ws, **kw)[0]
    eight = tfl.fixed_linear(x[:8], ws, **kw)[0]
    want = tfl.fixed_linear_plain(_normed(x0[:8], scale, z[:8], prologue) if kw else x[:8], ws)
    torch.cuda.synchronize()
    assert _fixed_close(eight, want[0])
    assert torch.equal(eight, sixteen[:8])
    for m in (0, 5, 15):
        assert torch.equal(tfl.fixed_linear(x[m:m + 1], ws, **kw)[0][0], sixteen[m]), m
    if kw:
        unfused = tfl.fixed_linear(_normed(x0, scale, z, prologue), ws)[0]
        assert torch.equal(unfused, sixteen)


@pytest.mark.cuda
def test_fixed_linear_replayed_in_a_cuda_graph_equals_the_eager_launch():
    """A decode-form launch captured in a CUDA graph and replayed gives the
    eager launch's bits, on the inputs it was captured on and on new ones
    copied into them (Mamba2's two launches, Qwen2's q/k/v, each behind its
    norm)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    for K, Ns, prologue in (SERVED_WIDTHS[0], SERVED_WIDTHS[1], SERVED_WIDTHS[2]):
        x0, ws, scale, z = _fixed_operands(gen, 8, K, Ns, torch.bfloat16)
        x, kw = _prologue(x0, scale, z, prologue)
        outs = [torch.bfloat16] + [torch.float32] * (len(Ns) - 1)
        eager = tfl.fixed_linear(x, ws, outs, **kw)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = tfl.fixed_linear(x, ws, outs, **kw)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager)), (K, Ns)
        x.copy_(torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype))
        eager = tfl.fixed_linear(x, ws, outs, **kw)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager)), (K, Ns, "new x")


@pytest.mark.cuda
def test_fixed_linear_raises_for_a_weight_in_another_storage():
    """A weight on the card that is not (N, K) row-major is refused, never
    copied for the call."""
    _need_card()
    x = torch.ones(8, 64, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(64, 32, device="cuda", dtype=torch.bfloat16)      # (K, N) row-major
    with pytest.raises(ValueError, match="kernel_layout"):
        tfl.fixed_linear(x, [w])
    assert tfl.fixed_linear(x, [w.t().contiguous().t()])[0].shape == (8, 32)


@pytest.mark.cuda
def test_engine_puts_host_made_weights_in_the_kernel_layout():
    """Params made on the host and handed to an engine on the card reach it
    with every plain projection weight in ``kernel_layout``."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.params import in_kernel_layout, projection_contract
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import ServeEngine

    _need_card()
    cfg = get_smoke("qwen2-1.5b")
    params = init_model(torch.Generator().manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=2, max_seq=32)
    seen = 0
    for name, block in eng.params["blocks"].items():
        for mod, leaves in block.items():
            for leaf, w in leaves.items():
                nc = projection_contract((name, mod, leaf))
                if nc is not None:
                    assert w.is_cuda and in_kernel_layout(w, nc, 1), (name, mod, leaf)
                    seen += 1
    assert seen == 7 * len(eng.params["blocks"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fixed_linear_folded_norms_equal_the_unfused_composition(dtype):
    """The norm prologue bitwise equal to the ``rmsnorm`` kernel and then
    the product; on the gate y·silu(z) (fp32), bitwise equal to the layer's
    gated norm (PyTorch's silu and product, the ``rmsnorm`` kernel, the
    cast) and then the product; and ``ssd_decode``'s gate bitwise PyTorch's
    y·silu(z)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    for M, K, Ns in FIXED_SHAPES:
        x, ws, scale, z = _fixed_operands(gen, M, K, Ns, dtype)
        if K > tfl.max_k(dtype, torch.float32, True):
            continue                     # no norm in front of so wide a row
        folded = tfl.fixed_linear(x, ws, norm=(scale, 1e-6, True))
        unfused = tfl.fixed_linear(tops.rmsnorm(x, scale, 1e-6, plus_one=True), ws)
        assert all(torch.equal(a, b) for a, b in zip(folded, unfused)), (M, K, "norm")
        gate = x.float() * torch.nn.functional.silu(z.float())
        folded = tfl.fixed_linear(gate, ws, norm=(scale, 1e-5, False))
        unfused = tfl.fixed_linear(tlssd._gated_norm(x, z, scale, 1e-5), ws)
        assert all(torch.equal(a, b) for a, b in zip(folded, unfused)), (M, K, "gated")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fixed_linear_rows_are_batch_invariant(dtype):
    """Row m bitwise the same at M = 1 and at M = 8, with each prologue."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    for M, K, Ns in FIXED_SHAPES[:5]:
        x0, ws, scale, z = _fixed_operands(gen, 8, K, Ns, dtype)
        for prologue in (None, "norm", "gated"):
            x, kw = _prologue(x0, scale, z, prologue)
            if K > tfl.max_k(dtype, x.dtype, bool(kw)):
                continue
            eight = tfl.fixed_linear(x, ws, **kw)
            for m in range(8):
                one = tfl.fixed_linear(x[m:m + 1], ws, **kw)
                assert all(torch.equal(a[0], b[m]) for a, b in zip(one, eight)), (K, m, prologue)


def _decode_operands(gen, B, H, P, N, dtype):
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    h = r(B, H, P, N) * 0.5
    return h, [r(B, H), r(B, H, P).to(dtype), r(B, N), r(B, N), r(H), torch.log(
        1.0 + 15.0 * torch.rand(H, generator=gen, device="cuda")), torch.ones(H, device="cuda")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,H,P,N", [(8, 80, 64, 128), (1, 80, 64, 128), (3, 16, 16, 16),
                                     (5, 7, 9, 44)])
def test_ssd_decode_kernel_matches_plain_version(B, H, P, N, dtype):
    """The state bitwise the plain update; y within ``_fixed_close`` of the
    plain version (fp32 sum against fp64); the gate y·silu(z) bitwise
    PyTorch's on the kernel's y; a slot alone the same bits as in the
    batch."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(B * H + N)
    h0, args = _decode_operands(gen, B, H, P, N, dtype)
    ha, hb = h0.clone(), h0.clone()
    tk.reset_launch_counts()
    y = tss.ssd_decode(ha, *args)
    yp = tss.ssd_decode_plain(hb, *args)
    torch.cuda.synchronize()
    assert tk.launch_counts()["ssd_decode"] == 1
    assert torch.equal(ha, hb)
    assert y.dtype == dtype and _fixed_close(y, yp)
    z = torch.randn(B, H, P, generator=gen, device="cuda").to(dtype)
    gate = tss.ssd_decode(h0.clone(), *args, z=z)
    assert gate.dtype == torch.float32
    assert torch.equal(gate, y.float() * torch.nn.functional.silu(z.float()))
    for b in range(B):
        hm = h0[b:b + 1].clone()
        ym = tss.ssd_decode(hm, *[a[b:b + 1] if a.ndim > 1 else a for a in args])
        assert torch.equal(hm[0], ha[b]) and torch.equal(ym[0], y[b]), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b"])
def test_plain_weight_engine_on_card_matches_slot_at_a_time(arch, dtype):
    """SMOKE widths with plain weights (``quantize="none"``), fp32 (the
    SIMT route) and bf16 (the tensor cores): continuous batching gives the
    slot-at-a-time oracle's streams; a decode step runs the final norm
    alone and folds the block norms into its fixed_linear launches."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Request, ServeEngine

    _need_card()
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype)
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=4, max_seq=96)

    def reqs():
        r = np.random.default_rng(5)
        return [Request(prompt=r.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=m)
                for n, m in zip((5, 40, 12, 33, 3, 21), (20, 8, 25, 6, 9, 14))]

    tk.reset_launch_counts()
    served = eng.run(reqs())
    counts = tk.launch_counts()
    steps = eng.calls["decode_steps"]
    per_step = 2 * cfg.num_layers if arch == "mamba2-2.7b" else 4 * cfg.num_layers
    assert counts["fixed_linear"] >= per_step * steps > 0
    assert counts["rmsnorm"] == (2 * cfg.num_layers + 1) * (
        eng.calls["prefills"] + eng.calls["prefill_waves"]) + steps
    solo = [eng._run_one(r) for r in reqs()]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


# --------------------------------------------------------------------------- #
# the paper's §IV-B and the other estimators (no kernel of the port)
# --------------------------------------------------------------------------- #
def _als_tables(device, shards):
    """``examples/als_recommender.py``'s ratings, packed on ``device``."""
    M = synth_netflix_tiled(users=128, items=96, rank=6, tiles=2, density=0.15)
    r, c = np.nonzero(M)
    v = M[r, c]
    w = int(max((M != 0).sum(1).max(), (M != 0).sum(0).max()))
    return (pack_csr_table(r, c, v, M.shape[0], w, num_shards=shards, device=device),
            pack_csr_table(c, r, v, M.shape[1], w, num_shards=shards, device=device),
            (r, c, v))


@pytest.mark.cuda
def test_als_half_sweep_and_fit_are_bitwise_the_same_for_any_partition_count():
    """A half-sweep solves every partition's rows as one batch, so U and V
    do not depend on P; the fit on the card is within 1e-3 of max |U| of
    the same fit on the CPU from the same init; no kernel of the port
    launches."""
    _need_card()
    tk.reset_launch_counts()
    fits, factors = [], []
    for shards in (1, 4, 8):
        data, data_t, _ = _als_tables("cuda", shards)
        V = torch.rand((data_t.num_rows, 10), generator=torch.Generator().manual_seed(0))
        factors.append(BroadcastALS.compute_factor(data, V.cuda(), 0.01))
        fits.append(BroadcastALS(max_iter=10).fit(data, data_transposed=data_t))
    for f, m in zip(factors[1:], fits[1:]):
        assert torch.equal(f, factors[0])
        assert torch.equal(m.U, fits[0].U) and torch.equal(m.V, fits[0].V)
    assert all(v == 0 for v in tk.launch_counts().values())
    data, data_t, (r, c, v) = _als_tables("cpu", 4)
    card, card_t, _ = _als_tables("cuda", 4)
    gen = torch.Generator().manual_seed(1)
    init = (torch.rand((data.num_rows, 10), generator=gen),
            torch.rand((data_t.num_rows, 10), generator=gen))
    on_card = BroadcastALS(max_iter=10).fit(card, data_transposed=card_t, init_factors=init)
    on_cpu = BroadcastALS(max_iter=10).fit(data, data_transposed=data_t, init_factors=init)
    for a, b in ((on_card.U, on_cpu.U), (on_card.V, on_cpu.V)):
        assert ((a.cpu() - b).abs().max() / b.abs().max()).item() <= 1e-3
    assert fits[0].rmse(r, c, v).item() < 0.5


@pytest.mark.cuda
def test_served_mf_pairs_and_glm_rows_are_bitwise_the_offline_prediction():
    """(user, item) pairs in microbatches of 64 (zero pad rows: the pair
    (0, 0)) and GLM / naive Bayes rows in microbatches of 16, each served
    result bitwise the offline predict of every row at once."""
    _need_card()
    data, data_t, _ = _als_tables("cuda", 4)
    mf = BroadcastALS(max_iter=3).fit(data, data_transposed=data_t)
    rng = np.random.default_rng(0)
    pairs = np.stack([rng.integers(0, data.num_rows, 3000),
                      rng.integers(0, data_t.num_rows, 3000)], 1)
    X = rng.normal(size=(512, 4097)).astype(np.float32)
    tab = np.concatenate([np.sign(X[:, :1]), X[:, 1:]], 1)
    table = MLNumericTable.from_numpy(tab, num_shards=4)
    nb_tab = np.concatenate([(X[:, :1] > 0).astype(np.float32), X[:, 1:65]], 1)
    models = [(mf, pairs, 64),
              (LinearRegression(max_iter=2, learning_rate=1e-4,
                                local_batch_size=16).fit(table), X[:, 1:], 16),
              (LinearSVM(max_iter=2, learning_rate=1e-4,
                         local_batch_size=16).fit(table), X[:, 1:], 16),
              (GaussianNaiveBayes(num_classes=2).fit(
                  MLNumericTable.from_numpy(nb_tab, num_shards=4)), X[:, 1:65], 16)]
    for model, rows, batch in models:
        offline = model.predict(torch.as_tensor(rows).cuda()).cpu().numpy()
        sizes = rng.integers(1, batch + 1, 200)
        starts = np.cumsum(np.concatenate([[0], sizes]))
        starts = starts[starts <= len(rows)]
        blocks = [rows[a:b] for a, b in zip(starts[:-1], starts[1:])]
        served = ModelPredictor(model, max_batch=batch).predict_many(blocks)
        for a, block, out in zip(starts, blocks, served):
            assert np.array_equal(out, offline[a:a + len(block)])


@pytest.mark.cuda
def test_pca_on_the_card_matches_fp64_up_to_sign():
    _need_card()
    rng = np.random.default_rng(1)
    X = (rng.normal(size=(4096, 64)) + rng.normal(size=(8, 64))[np.arange(4096) % 8] * 3)
    model = PCA(n_components=4).fit(MLNumericTable.from_numpy(X.astype(np.float32),
                                                              num_shards=8))
    Xd = torch.as_tensor(X.astype(np.float32)).double()
    mean = Xd.mean(0)
    evals, evecs = torch.linalg.eigh((Xd - mean).T @ (Xd - mean) / len(X))
    ev64, comp64 = evals.flip(0)[:4], evecs.flip(1)[:, :4].T
    assert ((model.explained_variance.cpu().double() - ev64).abs().max()
            / ev64[0]).item() <= 1e-4
    c = model.components.cpu().double()
    c = c * torch.sign((c * comp64).sum(1, keepdim=True))
    assert (c - comp64).abs().max().item() <= 1e-3


# --------------------------------------------------------------------------- #
# streaming epochs, checkpoints and resume on the card
# --------------------------------------------------------------------------- #
def _pinned_pool(rows, cols, windows, seed):
    """A pool of windows in pinned host memory; a source hands out its
    read-only slices, so a non-blocking copy never races a rewrite."""
    rng = np.random.default_rng(seed)
    pool = torch.from_numpy(rng.normal(size=(windows, rows, cols)).astype(np.float32))
    pool[:, :, 0] = (pool[:, :, 1:5].sum(-1) > 0).float()
    return pool.pin_memory()


@pytest.mark.cuda
def test_streamed_fits_launch_the_kernels_and_match_the_cpu():
    """A streamed logreg and k-means fit on the card launch logreg_grad once
    a local batch and kernel 3 once a round, and agree with the same fits
    through the plain versions on the CPU."""
    _need_card()
    pool = _pinned_pool(256, 65, 3, 3)

    def source(step):
        return {"data": pool[step % 3]}

    tk.reset_launch_counts()
    lr = LogisticRegression(learning_rate=0.1, local_batch_size=8, use_kernel=True)
    card = lr.fit_stream(BatchIterator(source), num_epochs=3, num_shards=4,
                         chunks_per_epoch=2)
    got = tk.launch_counts()
    assert got["logreg_grad"] == 3 * 2 * (256 // 4 // 2 // 8)
    assert got["logreg_margin"] == got["logreg_xt_z"] == 0
    cpu = lr.fit_stream(BatchIterator(source, device="cpu"), num_epochs=3,
                        num_shards=4, chunks_per_epoch=2)
    err = (card.weights.cpu() - cpu.weights).abs().max() / cpu.weights.abs().max()
    assert card.weights.device.type == "cuda" and err.item() < 2e-4

    def km_source(step):
        return {"data": pool[step % 3, :, 1:]}

    tk.reset_launch_counts()
    km = KMeans(k=5, use_kernel=True)
    card = km.fit_stream(BatchIterator(km_source), num_epochs=3, num_shards=4,
                         chunks_per_epoch=2)
    assert tk.launch_counts()["kmeans_assign"] == 3 * 2
    cpu = KMeans(k=5).fit_stream(BatchIterator(km_source, device="cpu"), num_epochs=3,
                                 num_shards=4, chunks_per_epoch=2)
    torch.testing.assert_close(card.centroids.cpu(), cpu.centroids, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["logreg", "kmeans"])
def test_streamed_fit_resumes_bitwise_on_the_card(algo, tmp_path):
    _need_card()
    pool = _pinned_pool(512, 33, 2, 4)

    def source(step):
        window = pool[step % 2]
        return {"data": window if algo == "logreg" else window[:, 1:]}

    def fit(epochs, ckpt=None, resume=False):
        stream = BatchIterator(source)
        kw = dict(num_epochs=epochs, num_shards=8, chunks_per_epoch=4,
                  checkpoint=ckpt, resume=resume)
        if algo == "logreg":
            return LogisticRegression(learning_rate=0.05, local_batch_size=16,
                                      use_kernel=True).fit_stream(stream, **kw).weights
        return KMeans(k=6, use_kernel=True).fit_stream(stream, **kw).centroids

    straight = fit(6)
    fit(3, CheckpointPolicy(str(tmp_path)))
    assert latest_step(str(tmp_path)) == 3
    resumed = fit(6, CheckpointPolicy(str(tmp_path)), resume=True)
    assert resumed.device.type == "cuda" and torch.equal(resumed, straight)


@pytest.mark.cuda
def test_bf16_state_round_trips_the_store_on_the_card(tmp_path):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    tree = {"w": torch.randn(7, 33, generator=gen, device="cuda").to(torch.bfloat16),
            "step": torch.tensor(3, device="cuda"),
            "f8": torch.randn(5, generator=gen, device="cuda").to(torch.float8_e4m3fn)}
    save_checkpoint(str(tmp_path), 1, tree)
    got, _ = restore_checkpoint(str(tmp_path), tree)
    for k, v in tree.items():
        assert got[k].device.type == "cuda" and got[k].dtype == v.dtype
        assert torch.equal(got[k].view(torch.uint8) if v.dtype.itemsize == 1 and
                           v.is_floating_point() else got[k],
                           v.view(torch.uint8) if v.dtype.itemsize == 1 and
                           v.is_floating_point() else v)


# --------------------------------------------------------------------------- #
# model search (sixteenth slice): stacked == sequential bitwise on the card
# --------------------------------------------------------------------------- #
def _search_table(device, kind, rows=256, d=40, shards=4):
    rng = np.random.default_rng(9)
    X = rng.normal(size=(rows, d)).astype(np.float32)
    if kind == "kmeans":
        X[: rows // 2] += 3.0
        return MLNumericTable.from_numpy(X, num_shards=shards, device=device)
    y = (X @ np.linspace(-1, 1, d).astype(np.float32) > 0).astype(np.float32)
    return MLNumericTable.from_numpy(np.concatenate([y[:, None], X], 1),
                                     num_shards=shards, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["logreg", "kmeans"])
def test_search_stacked_equals_sequential_bitwise_on_the_card(kind):
    """A lane runs its trial's launches alone, so on the card too a stacked
    search equals the sequential one bit for bit — weights, scores and the
    winner — and no kernel of the port launches (the trial forms refuse the
    kernel paths, as the reference's do).  A logistic trial equals its
    estimator's fit on the train view bit for bit."""
    from repro_torch.tune import ModelSearch, fold_view, grid, holdout_split

    _need_card()
    table = _search_table("cuda", kind)
    configs = (grid({"learning_rate": [0.05, 0.1, 0.3], "l2": [0.0, 0.01],
                     "local_batch_size": [4]}) if kind == "logreg"
               else grid({"k": [2, 3], "seed": [0, 1, 2]}))
    tk.reset_launch_counts()
    runs = [ModelSearch(kind, configs, num_epochs=3, chunks_per_epoch=2, folds=2,
                        execution=mode, seed=0).run(table)
            for mode in ("stacked", "sequential")]
    assert all(v == 0 for v in tk.launch_counts().values())
    for a, b in zip(*(r.trials for r in runs)):
        assert a.state.device.type == "cuda"
        assert a.rung_scores == b.rung_scores and torch.equal(a.state, b.state)
    assert runs[0].best.index == runs[1].best.index
    if kind == "logreg":
        res = ModelSearch(kind, configs, num_epochs=3, seed=0).run(table)
        view = fold_view(table, holdout_split(table.num_rows, 0.25, 0)[0])
        for t in res.trials:
            solo = LogisticRegression(max_iter=3, schedule="allreduce", **t.config).fit(view)
            assert torch.equal(solo.weights, t.state)


@pytest.mark.cuda
def test_asha_stacked_equals_sequential_bitwise_on_the_card():
    from repro_torch.tune import AsyncSuccessiveHalving, ModelSearch, sample

    _need_card()
    table = _search_table("cuda", "logreg")
    configs = sample({"learning_rate": ("loguniform", 0.01, 1.0), "l2": [0.0, 0.01]},
                     12, seed=0)
    runs = [ModelSearch("logreg", configs, num_epochs=9, execution=mode, seed=0,
                        early_stop=AsyncSuccessiveHalving(3, 1, slots=4)).run(table)
            for mode in ("auto", "sequential")]
    assert [(t.index, t.stopped, t.rung_scores) for t in runs[0].trials] == \
           [(t.index, t.stopped, t.rung_scores) for t in runs[1].trials]
    for a, b in zip(*(r.trials for r in runs)):
        assert torch.equal(a.state, b.state)


@pytest.mark.cuda
def test_train_stacked_lane_matches_the_solo_fit_on_the_card():
    """``train_stacked``'s lanes share one batched solve: lane j is held to
    the solo fit from the same init at 1e-3 of max |U| (the ALS fit's
    tolerance); the lanes differ with λ; no kernel of the port launches."""
    from repro_torch.core.algorithms.als import ALSParameters

    _need_card()
    data, data_t, (r, c, v) = _als_tables("cuda", 4)
    ps = [ALSParameters(rank=10, lam=lam, max_iter=5, seed=s)
          for lam, s in ((0.01, 0), (0.1, 0), (0.03, 1))]
    tk.reset_launch_counts()
    models = BroadcastALS.train_stacked(data, ps, data_t)
    assert all(v == 0 for v in tk.launch_counts().values())
    for p, m in zip(ps, models):
        solo = BroadcastALS(p).fit(data, data_transposed=data_t)
        for a, b in ((m.U, solo.U), (m.V, solo.V)):
            assert a.device.type == "cuda"
            assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-3
    assert not torch.allclose(models[0].U, models[1].U)


# --------------------------------------------------------------------------- #
# mesh mode on the card (seventeenth slice)
# --------------------------------------------------------------------------- #
_CARD_HOST = r'''
import json, os
import torch
from repro_torch.core import collectives as coll, hostmesh
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.numeric_table import MLNumericTable

torch.backends.cuda.matmul.allow_tf32 = False
info = hostmesh.initialize_from_env("cuda", timeout=120)
mesh = hostmesh.make_mesh(4, "cuda")
g = torch.Generator(device="cuda").manual_seed(0)
parts = torch.randn(8, 3001, generator=g, device="cuda")
mine = parts[4 * mesh.host_id: 4 * mesh.host_id + 4]
out = {"backend": mesh.backend, "device": str(mesh.device)}
for s in ("gather_broadcast", "allreduce", "reduce_scatter"):
    out["mean/" + s] = coll.combine_mean(mine, mesh, s).cpu().numpy().tobytes().hex()
    out["sum/" + s] = coll.combine_sum(mine, mesh, s).cpu().numpy().tobytes().hex()
    out["concat/" + s] = coll.combine_concat(mine, mesh, s).cpu().numpy().tobytes().hex()
X = torch.randn(512, 2049, generator=g, device="cuda")
X[:, 0] = (X[:, 1] > 0).float()
rows = hostmesh.local_row_slice(512, mesh)
w = LogisticRegression(learning_rate=0.3, local_batch_size=16, max_iter=2,
                       schedule="gather_broadcast", use_kernel=True).fit(
    MLNumericTable(X[rows].clone(), mesh=mesh)).weights
out["fit"] = w.cpu().numpy().tobytes().hex()
print("RESULT::" + json.dumps(out))
hostmesh.shutdown()
'''


def _hex(t: torch.Tensor) -> str:
    return t.cpu().numpy().tobytes().hex()


@pytest.mark.cuda
def test_two_hosts_on_the_card_combine_cuda_partials_under_gloo_bitwise(tmp_path):
    """Two host processes share the one card (so gloo, CUDA partials staged
    through pinned buffers): gather_broadcast and concat bitwise the
    emulated combine, the reduction schedules within fp32 rounding, and a
    kernel fit on the 2 x 4 mesh bitwise the 8-partition emulated fit."""
    import json
    import os
    import sys

    from repro_torch.launch.elastic import ElasticController

    _need_card()
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    ctl = ElasticController([sys.executable, "-c", _CARD_HOST], 2,
                            env={"PYTHONPATH": src}, max_restarts=0, timeout=300,
                            rendezvous_dir=str(tmp_path))
    exits = sorted(ctl.run().final.exits, key=lambda e: e.host_id)
    res = []
    for e in exits:
        assert e.returncode == 0, e.stderr[-3000:]
        res.append(json.loads([ln for ln in e.stdout.splitlines()
                               if ln.startswith("RESULT::")][-1][8:]))
    assert res[0] == res[1] and res[0]["backend"] == "gloo"
    g = torch.Generator(device="cuda").manual_seed(0)
    parts = torch.randn(8, 3001, generator=g, device="cuda")
    assert res[0]["mean/gather_broadcast"] == _hex(parts.mean(0))
    assert res[0]["sum/gather_broadcast"] == _hex(parts.sum(0))
    for s in ("gather_broadcast", "allreduce", "reduce_scatter"):
        assert res[0]["concat/" + s] == _hex(parts.flatten(0, 1))
        for kind, want in (("mean", parts.mean(0)), ("sum", parts.sum(0))):
            got = np.frombuffer(bytes.fromhex(res[0][f"{kind}/{s}"]), np.float32)
            np.testing.assert_allclose(got, want.cpu().numpy(), rtol=1e-5, atol=1e-5)
    X = torch.randn(512, 2049, generator=g, device="cuda")
    X[:, 0] = (X[:, 1] > 0).float()
    w = LogisticRegression(learning_rate=0.3, local_batch_size=16, max_iter=2,
                           schedule="gather_broadcast", use_kernel=True).fit(
        MLNumericTable(X, num_shards=8)).weights
    assert res[0]["fit"] == _hex(w)


@pytest.mark.cuda
def test_nccl_at_a_world_of_one_is_bitwise_the_emulated_run(tmp_path):
    """One process, one card, an NCCL group of 1 with 8 local partitions:
    k-means and logistic regression through the kernels bitwise the
    8-partition emulated fits under every schedule."""
    from repro_torch.core import hostmesh

    _need_card()
    info = hostmesh.initialize(f"file://{tmp_path}/rdv", 1, 0, device="cuda",
                               timeout=120)
    try:
        assert info.backend == "nccl"
        mesh = hostmesh.make_mesh(8, "cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        X = torch.randn(4096, 1025, generator=g, device="cuda")
        X[:, 0] = (X[:, 1] > 0).float()
        L = torch.randint(0, 2, (4096, 256), generator=g, device="cuda").float()
        for s in ("gather_broadcast", "allreduce", "reduce_scatter"):
            lr = dict(learning_rate=0.3, local_batch_size=64, max_iter=2,
                      schedule=s, use_kernel=True)
            got = LogisticRegression(**lr).fit(MLNumericTable(X, mesh=mesh)).weights
            want = LogisticRegression(**lr).fit(MLNumericTable(X, num_shards=8)).weights
            assert torch.equal(got, want), s
            km = dict(k=8, seed=0, max_iter=3, schedule=s, use_kernel=True)
            got = KMeans(**km).fit(MLNumericTable(L, mesh=mesh)).centroids
            want = KMeans(**km).fit(MLNumericTable(L, num_shards=8)).centroids
            assert torch.equal(got, want), s
    finally:
        hostmesh.shutdown()


_CARD_API_HOST = r"""
import json
import numpy as np
import torch
from repro_torch.core import hostmesh
from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.serve.predictor import ModelPredictor
from repro_torch.tune import KFold, cv

torch.backends.cuda.matmul.allow_tf32 = False
info = hostmesh.initialize_from_env("cuda", timeout=120)
mesh = hostmesh.make_mesh(4, "cuda")
rng = np.random.default_rng(0)
data = rng.normal(size=(512, 33)).astype(np.float32)
t = MLNumericTable.from_numpy(data, mesh=mesh)
out = {"staged": mesh.staged(t.data), "backend": mesh.backend}
views = {"train": KFold(512, 2, seed=0).train_indices(0), "odd": np.arange(1, 512, 7),
         "reversed": np.arange(511, 0, -2)}
for name, idx in views.items():
    v = cv.fold_view(t, idx)
    out["view/" + name] = [v.data.device.type, v.num_shards, v.mesh is not None,
                           v.to_numpy().tobytes().hex()]
out["moved"] = [cv.fold_view.rows_moved, cv.fold_view.bytes_moved]
pool = rng.normal(size=(256, 257)).astype(np.float32)
labeled = np.concatenate([(pool[:, :1] > 0).astype(np.float32), pool], 1)
models = {"kmeans": KMeans(k=7, seed=0, max_iter=3, use_kernel=True).fit(
              MLNumericTable.from_numpy(pool, num_shards=4, device="cuda")),
          "logreg": LogisticRegression(learning_rate=0.3, local_batch_size=16, max_iter=2,
                                       use_kernel=True).fit(
              MLNumericTable.from_numpy(labeled, num_shards=4, device="cuda"))}
blocks = [pool[i:i + n] for i, n in ((0, 3), (3, 64), (67, 100), (167, 1))]
for name, model in models.items():
    svc = ModelPredictor(model, mesh=mesh, max_batch=64)
    served = np.concatenate(svc.predict_many(blocks))
    alone = np.concatenate(ModelPredictor(model, max_batch=64, device="cuda").predict_many(blocks))
    out["serve/" + name] = [served.tobytes().hex(), alone.tobytes().hex(), svc.report()["shards"]]
print("RESULT::" + json.dumps(out))
hostmesh.shutdown()
"""


def _card_hosts(program: str, tmp_path) -> list:
    """Each host's RESULT of ``program`` on two host processes sharing the
    card (gloo)."""
    import json
    import os
    import sys

    from repro_torch.launch.elastic import ElasticController

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    ctl = ElasticController([sys.executable, "-c", program], 2, env={"PYTHONPATH": src},
                            max_restarts=0, timeout=300, rendezvous_dir=str(tmp_path))
    exits = sorted(ctl.run().final.exits, key=lambda e: e.host_id)
    res = []
    for e in exits:
        assert e.returncode == 0, e.stderr[-3000:]
        res.append(json.loads([ln for ln in e.stdout.splitlines()
                               if ln.startswith("RESULT::")][-1][8:]))
    return res


@pytest.fixture(scope="module")
def card_api_hosts(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return _card_hosts(_CARD_API_HOST, tmp_path_factory.mktemp("card_api"))


@pytest.mark.cuda
def test_fold_view_of_a_cuda_mesh_table_through_gloo_staging(card_api_hosts):
    """Two hosts share the card (gloo): a CUDA mesh table's fold views cross
    hosts through pinned host buffers and hold the view's rows bitwise, on
    the card; a view whose rows do not divide 8 partitions is one partition
    held whole; rows moved are counted."""
    _need_card()
    h0, h1 = card_api_hosts
    assert h0["staged"] and h0["backend"] == "gloo"
    from repro_torch.tune import KFold

    data = np.random.default_rng(0).normal(size=(512, 33)).astype(np.float32)
    views = {"train": KFold(512, 2, seed=0).train_indices(0),
             "odd": np.arange(1, 512, 7), "reversed": np.arange(511, 0, -2)}
    for name, idx in views.items():
        for h in (h0, h1):
            device, shards, meshed, rows = h["view/" + name]
            assert device == "cuda" and rows == data[idx].tobytes().hex(), name
            assert (shards, meshed) == ((8, True) if len(idx) % 8 == 0 else (1, False))
    assert h0["moved"] == h1["moved"] and h0["moved"][0] > 0
    assert h0["moved"][1] == h0["moved"][0] * 33 * 4


@pytest.mark.cuda
def test_mesh_predictor_on_the_card_is_bitwise_its_one_process_service(card_api_hosts):
    """ModelPredictor(mesh=) on two hosts sharing the card: every served row
    of a k-means and a logistic model (through kernels 3 and 1) bitwise the
    one-process service in each host and here."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    h0, h1 = card_api_hosts
    rng = np.random.default_rng(0)
    rng.normal(size=(512, 33))
    pool = rng.normal(size=(256, 257)).astype(np.float32)
    labeled = np.concatenate([(pool[:, :1] > 0).astype(np.float32), pool], 1)
    models = {"kmeans": KMeans(k=7, seed=0, max_iter=3, use_kernel=True).fit(
                  MLNumericTable.from_numpy(pool, num_shards=4, device="cuda")),
              "logreg": LogisticRegression(learning_rate=0.3, local_batch_size=16,
                                           max_iter=2, use_kernel=True).fit(
                  MLNumericTable.from_numpy(labeled, num_shards=4, device="cuda"))}
    blocks = [pool[i:i + n] for i, n in ((0, 3), (3, 64), (67, 100), (167, 1))]
    for name, model in models.items():
        here = np.concatenate(ModelPredictor(model, max_batch=64, device="cuda")
                              .predict_many(blocks)).tobytes().hex()
        for h in (h0, h1):
            served, alone, shards = h["serve/" + name]
            assert served == alone == here and shards == "mesh", name


@pytest.mark.cuda
def test_kernel_partials_do_not_depend_on_the_partition_count():
    """A partition's margin, gradient (the two kernels and the one-pass
    logreg_grad) and k-means picks are bitwise the same in a launch of 8
    partitions and of 4 (L = 4 on each of 2 hosts against P = 8 in one
    process)."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(2)
    X = torch.randn(8, 256, 160_001, generator=g, device="cuda")
    y = (X[..., 0] > 0).float()
    W = torch.randn(8, 160_000, generator=g, device="cuda") * 1e-3
    F = X[..., 1:]
    z = tlg.logreg_margin(F, y, W)
    halves = [tlg.logreg_margin(F[i:i + 4], y[i:i + 4], W[i:i + 4]) for i in (0, 4)]
    assert torch.equal(z, torch.cat(halves))
    gr = tlg.logreg_xt_z(F, z)
    assert torch.equal(gr, torch.cat([tlg.logreg_xt_z(F[i:i + 4], z[i:i + 4])
                                      for i in (0, 4)]))
    one = tlg.logreg_grad(F, y, W)
    assert torch.equal(one, torch.cat([tlg.logreg_grad(F[i:i + 4], y[i:i + 4], W[i:i + 4])
                                       for i in (0, 4)]))
    K = torch.randn(8, 2048, 4096, generator=g, device="cuda")
    C = torch.randn(50, 4096, generator=g, device="cuda")
    a = tka.kmeans_assign(K, C)
    assert torch.equal(a, torch.cat([tka.kmeans_assign(K[i:i + 4], C) for i in (0, 4)]))


# ---- the one-pass gradient, logreg_grad ----------------------------------- #

# ragged (P, n, d): d = 1, each form's slice widths and the form boundaries
# ± 1 (4,096, 10,240, 32,768), slices too narrow for the loop without a
# test on every column (10,241: 3,414 wide; 33,000: 8,250), a ragged last
# slice (150,001), the widest one-pass width and the next (the chain
# route), and the paper's widths
_GRAD_SHAPES = [(3, 77, 1031), (1, 1, 1), (2, 40, 1), (1, 3, 7), (2, 300, 4095),
                (2, 300, 4096), (2, 300, 4097), (3, 70, 10239), (3, 70, 10240),
                (3, 70, 10241), (2, 33, 30000), (2, 41, 32768), (2, 41, 32769),
                (2, 50, 33000), (2, 9, 150001), (2, 100, 163840), (1, 20, 163841),
                (2, 37, 160000)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logreg_grad_matches_plain_at_ragged_shapes(dtype):
    """logreg_grad against logreg_grad_plain within rel 2e-4 (max abs error
    over the largest entry) at ragged (P, n, d), in fp32 and bf16, with w
    shared and per partition, on the strided view after a label column;
    one launch a call on the one-pass route, the chain route only where no
    cluster holds d."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    tk.reset_launch_counts()
    calls = 0
    for P, n, d in _GRAD_SHAPES:
        table = torch.randn(P, n, d + 1, generator=gen, device="cuda").to(getattr(torch, dtype))
        X, y = table[..., 1:], (table[..., 0] > 0).float()
        for w in (torch.randn(d, generator=gen, device="cuda") * 0.05,
                  torch.randn(P, d, generator=gen, device="cuda") * 0.05):
            g, gp = tlg.logreg_grad(X, y, w), tlg.logreg_grad_plain(X, y, w)
            err = ((g - gp).abs().max() / gp.abs().max().clamp(min=1e-30)).item()
            assert g.shape == (P, d) and err < 2e-4, (P, n, d, dtype, tuple(w.shape), err)
            calls += 1
    chain = 2 * sum(tlg.grad_plan(n, d) is None for _, n, d in _GRAD_SHAPES)
    assert chain == 2
    assert dict(tlg.logreg_grad.routes) == {"one_pass": calls - chain, "chain": chain}
    assert tk.launch_counts()["logreg_grad"] == calls - chain


@pytest.mark.cuda
@pytest.mark.parametrize("P,n,d", [(8, 256, 160000), (8, 4, 30000), (3, 77, 1031)])
def test_logreg_grad_strided_view_is_bitwise_its_copy(P, n, d):
    """A partition's gradient is bitwise the same from the table's strided
    view, from its contiguous copy, and alone as a 2-D X."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(12)
    table = torch.randn(P, n, d + 1, generator=gen, device="cuda").clamp_(min=0.0)
    X, y = table[..., 1:], (table[..., 0] > 0.5).float()
    W = torch.randn(P, d, generator=gen, device="cuda") * 0.01
    g = tlg.logreg_grad(X, y, W)
    assert torch.equal(g, tlg.logreg_grad(X.contiguous(), y, W))
    assert torch.equal(g, tlg.logreg_grad(X, table[..., 0].gt(0.5).float().contiguous(), W))
    assert torch.equal(g[P - 1], tlg.logreg_grad(X[P - 1], y[P - 1], W[P - 1]))


@pytest.mark.cuda
@pytest.mark.parametrize("P,n,d", [(8, 256, 160000), (8, 4, 30000)])
def test_logreg_grad_is_bitwise_over_repeated_launches(P, n, d):
    """300 launches give the first launch's bits: the exchange of partial
    margins between a cluster's blocks and the reuse of the ring's stages
    leave no race that would show as rare wrong bits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(13)
    table = torch.randn(P, n, d + 1, generator=gen, device="cuda").clamp_(min=0.0)
    X, y = table[..., 1:], (table[..., 0] > 0.5).float()
    W = torch.randn(P, d, generator=gen, device="cuda") * 0.01
    g = tlg.logreg_grad(X, y, W)
    differ = sum(not torch.equal(tlg.logreg_grad(X, y, W), g) for _ in range(300))
    assert differ == 0


@pytest.mark.cuda
@pytest.mark.parametrize("P,n,d", [(8, 256, 4096), (8, 4, 30000), (4, 128, 160000)])
def test_logreg_grad_replays_in_a_cuda_graph(P, n, d):
    """A step is one launch with nothing beside it (the chunk tickets are
    left at zero by the kernel), so it captures into a CUDA graph whose
    replays give the eager launch's bits."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(14)
    table = torch.randn(P, n, d + 1, generator=gen, device="cuda").clamp_(min=0.0)
    X, y = table[..., 1:], (table[..., 0] > 0.5).float()
    W = torch.randn(P, d, generator=gen, device="cuda") * 0.01
    want = tlg.logreg_grad(X, y, W)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    tk.reset_launch_counts()
    with torch.cuda.graph(graph):
        outs = [tlg.logreg_grad(X, y, W) for _ in range(3)]
    assert tk.launch_counts()["logreg_grad"] == 3
    for _ in range(5):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
def test_served_logreg_is_one_margin_launch_and_no_fill():
    """predict_proba through the kernel is one logreg_margin launch and no
    fill (no zero labels, no ticket reset beside it): torch.profiler sees
    one margin_kernel and no FillFunctor kernel in a served call.  A
    profiler window that lost the kernel's record is taken again, up to 3
    windows."""
    _need_card()
    rng = np.random.default_rng(15)
    data = rng.normal(size=(512, 65)).astype(np.float32)
    data[:, 0] = data[:, 1:] @ rng.normal(size=64) > 0
    model = LogisticRegression(learning_rate=0.1, max_iter=2, local_batch_size=8,
                               use_kernel=True).fit(MLNumericTable.from_numpy(data, num_shards=4))
    x = torch.from_numpy(data[:16, 1:]).cuda()
    model.predict_proba(x)
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        tk.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model.predict_proba(x)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
        if any("margin_kernel" in k for k in names):
            break
    assert tk.launch_counts()["logreg_margin"] == 1
    assert sum("margin_kernel" in k for k in names) == 1
    assert not any("Fill" in k for k in names), names


@pytest.mark.cuda
def test_logreg_grad_refuses_a_plan_its_kernel_cannot_run(monkeypatch):
    """The C launcher checks the plan it is handed: more cluster ranks than
    warp 0's lanes for a row (slices of the 8-column form in a cluster of
    15) or a ring of 2 stages raise instead of running."""
    _need_card()
    import dataclasses

    gen = torch.Generator(device="cuda").manual_seed(16)
    X = torch.randn(8, 4, 30000, generator=gen, device="cuda")
    y, w = torch.zeros(8, 4, device="cuda"), torch.zeros(30000, device="cuda")
    plan = tlg.grad_plan(4, 30000)
    for bad in (dataclasses.replace(plan, clusters=15, width=2000),
                dataclasses.replace(plan, stages=2)):
        monkeypatch.setattr(tlg, "grad_plan", lambda n, d, bad=bad: bad)
        with pytest.raises(RuntimeError, match="logreg_grad launch failed"):
            tlg.logreg_grad(X, y, w)


# ------------------------------------------------------------------------- #
# the model zoo's slice: rglru_scan, kernel 6's decode at 16 heads a kv
# head, and the hybrid stack on the card
# ------------------------------------------------------------------------- #
@pytest.mark.cuda
@pytest.mark.parametrize("B,S,r,with_h0", [(1, 1, 64, False), (1, 1999, 4096, True),
                                            (3, 37, 130, True), (8, 300, 4096, False),
                                            (2, 9, 1, True)])
def test_rglru_scan_kernel_is_bitwise_its_plain_version(B, S, r, with_h0):
    """The scan's order is the plain loop's (a multiply, then an add, in time
    order): every h_t and the final state bitwise, at ragged widths and a
    prompt's length, from zero and from a given state."""
    from repro_torch.kernels import rglru_scan as trs

    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(S)
    a = torch.rand(B, S, r, generator=gen, device="cuda") * 0.2 + 0.8
    b = torch.randn(B, S, r, generator=gen, device="cuda")
    h0 = torch.randn(B, r, generator=gen, device="cuda") if with_h0 else None
    tk.reset_launch_counts()
    hs, last = trs.rglru_scan(a, b, h0)
    want, want_last = trs.rglru_scan_plain(a, b, h0)
    torch.cuda.synchronize()
    assert tk.launch_counts()["rglru_scan"] == 1
    assert torch.equal(hs, want) and torch.equal(last, want_last)
    for row in range(B):     # a row alone is the same row in the batch
        alone, _ = trs.rglru_scan(a[row:row + 1], b[row:row + 1],
                                  None if h0 is None else h0[row:row + 1])
        assert torch.equal(alone[0], hs[row]), row


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,slots,hd,kw", [
    (8, 40, 40, 2048, 128, dict()),                  # Qwen1.5-32B: group 1
    (8, 32, 8, 2048, 128, dict()),                   # Granite-3-8B: group 4
    (8, 56, 8, 3072, 128, dict()),                   # LLaVA-NeXT-34B: group 7, one set of 8
    (8, 12, 12, 1500, 64, dict()),                   # Whisper-small: 1,500 slots, hd 64
    (8, 16, 1, 2048, 256, dict(window=2048)),        # RecurrentGemma-9B: group 16
    (3, 12, 1, 300, 64, dict(window=100)),           # group 12 of 8 + 4 below hd 256
    (2, 10, 1, 64, 256, dict(chunk=16))])            # group 10 at hd 256: 4 + 4 + 2
def test_flash_decode_takes_groups_up_to_16(B, H, KV, slots, hd, kw):
    """Kernel 6's decode form at the zoo's groups against its plain version
    (positions spread over two rings, wrapped), bf16 within one bf16 step;
    every head bitwise the same as the same head in a group of 1 (its sums
    are its own, whatever the set it falls in)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(H)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, kc, vc = randn(B, H, hd), randn(B, slots, KV, hd), randn(B, slots, KV, hd)
    pos = torch.linspace(0, 2 * slots - 1, B, device="cuda").long()
    got = tfa.flash_attention_decode(q, kc, vc, pos, **kw)
    want = tfa.flash_attention_decode_plain(q, kc, vc, pos, **kw)
    torch.testing.assert_close(got.float(), want.float(), **_flash_tol(torch.bfloat16))
    G = H // KV
    for h in range(0, H, max(1, H // 5)):
        kvh = h // G
        one = tfa.flash_attention_decode(q[:, h:h + 1], kc[:, :, kvh:kvh + 1],
                                         vc[:, :, kvh:kvh + 1], pos, **kw)
        assert torch.equal(one[:, 0], got[:, h]), h


@pytest.mark.cuda
def test_flash_decode_at_16_heads_is_the_same_bits_over_300_launches():
    """RecurrentGemma-9B's local decode (8, 16, 1, 2,048 slots, hd 256),
    launched 300 times on the same inputs: every launch the first one's
    bits (no race between the head sets' blocks or the span merge)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(300)
    q = torch.randn(8, 16, 256, generator=gen, device="cuda").bfloat16()
    kc = torch.randn(8, 2048, 1, 256, generator=gen, device="cuda").bfloat16()
    vc = torch.randn(8, 2048, 1, 256, generator=gen, device="cuda").bfloat16()
    pos = torch.linspace(100, 4000, 8, device="cuda").long()
    first = tfa.flash_attention_decode(q, kc, vc, pos, window=2048)
    differ = 0
    for _ in range(300):
        differ += not torch.equal(tfa.flash_attention_decode(q, kc, vc, pos, window=2048),
                                  first)
    torch.cuda.synchronize()
    assert differ == 0, f"{differ} of 300 launches differ"


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_hybrid_engine_on_card_matches_slot_at_a_time(quantize):
    """RecurrentGemma's SMOKE stack in bf16 at a width the kernels take (16
    q heads on one kv head of 64, rnn width 256): per-request prefill
    through rglru_scan, decode steps as CUDA graph replays (RG-LRU state
    updated in place inside the graph), and every stream equal to the
    slot-at-a-time oracle's; the oracle's reused batch-1 cache starts each
    request from a zero RG-LRU state."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import Request, ServeEngine

    _need_card()
    cfg = dataclasses.replace(
        get_smoke("recurrentgemma-9b").scaled(d_model=256, num_heads=16, num_kv_heads=1,
                                             d_ff=512, head_dim=64),
        dtype="bfloat16", quantize=quantize)
    assert cfg.rnn_width == 256
    params = init_model(torch.Generator(device="cuda").manual_seed(0), cfg)
    eng = ServeEngine(cfg, params, batch_size=4, max_seq=96)

    def reqs():
        r = np.random.default_rng(5)
        return [Request(prompt=r.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=m)
                for n, m in zip((5, 40, 12, 33, 3, 21), (20, 8, 25, 6, 9, 14))]

    tk.reset_launch_counts()
    served = eng.run(reqs())
    counts = tk.launch_counts()
    recurrent = sum(k.value == "rglru" for k in cfg.pattern) * cfg.num_periods
    assert counts["rglru_scan"] == recurrent * eng.calls["prefills"] > 0
    assert eng.calls["decode_graph_replays"] == eng.calls["decode_steps"] - 1 > 0
    solo = [eng._run_one(r) for r in reqs()]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


@pytest.mark.cuda
def test_layernorm_kernel_matches_plain_version():
    """Whisper's rows (encoder 8 x 1,500 and a decode step's 8, d = 768),
    fp32 and bf16 x with bf16 and fp32 scale and bias, ragged widths (not a
    multiple of a 16-byte chunk, one wider than a pass of 256 chunks), an
    unaligned row base; a row the same bits alone as in the batch, one
    launch a call."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [((8, 1500, 768), torch.bfloat16, torch.bfloat16), ((8, 1, 768), torch.bfloat16,
              torch.bfloat16), ((8, 768), torch.float32, torch.float32),
             ((5, 37), torch.float32, torch.bfloat16), ((3, 2100), torch.bfloat16,
                                                        torch.float32), ((4, 1), torch.float32,
                                                                         torch.float32)]
    tk.reset_launch_counts()
    for shape, dtype, wdtype in cases:
        x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
        s = (1 + 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        b = (0.1 * torch.randn(shape[-1], generator=gen, device="cuda")).to(wdtype)
        got, want = tln.layernorm(x, s, b), tln.layernorm_plain(x, s, b)
        assert got.dtype == dtype and got.shape == x.shape
        tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
            else dict(rtol=2.0 ** -7, atol=1e-6)
        torch.testing.assert_close(got.float(), want.float(), **tol)
        rows = x.reshape(-1, shape[-1])
        alone = tln.layernorm(rows[-1:].clone(), s, b)
        assert torch.equal(alone[0], got.reshape(-1, shape[-1])[-1])
    flat = torch.randn(9 * 768, generator=gen, device="cuda").to(torch.bfloat16)
    x = flat[3:3 + 8 * 768].view(8, 768)
    s, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    assert torch.equal(tln.layernorm(x, s, b), tln.layernorm(x.clone(), s, b))
    torch.cuda.synchronize()
    assert tk.launch_counts()["layernorm"] == 2 * len(cases) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,Se,hd", [(8, 12, 12, 1500, 64), (3, 4, 2, 64, 32)])
def test_cross_decode_admits_every_slot(B, H, KV, Se, hd):
    """Cross-attention's decode: the decode form with every row at position
    Se - 1 and causal=False admits all Se slots, so it is the prefill form
    at Sq = 1 over all keys (against both plain versions, bf16 within one
    bf16 step), and a row gives the same bits alone."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(Se)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, kc, vc = randn(B, H, hd), randn(B, Se, KV, hd), randn(B, Se, KV, hd)
    at = torch.full((B,), Se - 1, dtype=torch.long, device="cuda")
    got = tfa.flash_attention_decode(q, kc, vc, at, causal=False)
    tol = _flash_tol(torch.bfloat16)
    torch.testing.assert_close(got.float(), tfa.flash_attention_decode_plain(
        q, kc, vc, at, causal=False).float(), **tol)
    every = tfa.flash_attention_plain(q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
                                      causal=False)[:, :, 0]
    torch.testing.assert_close(got.float(), every.float(), **tol)
    one = tfa.flash_attention_decode(q[1:2], kc[1:2], vc[1:2], at[1:2], causal=False)
    assert torch.equal(one[0], got[1])


def _moe_smoke(arch):
    """A MoE smoke config in bf16 on the card, weights from a seed (the
    plain projections stacked in kernel_layout, the experts with them)."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.models.transformer import init_model

    cfg = dataclasses.replace(get_smoke(arch), dtype="bfloat16")
    return cfg, init_model(torch.Generator(device="cuda").manual_seed(0), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-16e"])
def test_moe_decode_rows_are_bitwise_alone_at_1_and_8_slots(arch):
    """moe_apply at a decode step: each of 8 rows (one token each, capacity
    8, so nothing is dropped) gives the bits it gives alone at 1 slot, on
    the kernels (the router's SIMT route, the experts' decode form)."""
    from repro_torch.kernels import fixed_linear as kfl
    from repro_torch.models.layers import moe as tmoe
    from repro_torch.models.transformer import layer_slice

    _need_card()
    cfg, params = _moe_smoke(arch)
    bp = layer_slice(params["blocks"], 0)["b0"]["moe"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(8, 1, cfg.d_model, generator=gen, device="cuda").bfloat16()
    before = kfl.fixed_linear.launches
    whole, _ = tmoe.moe_apply(bp, x, cfg, aux=False)
    assert kfl.fixed_linear.launches - before == 1 + 2 * cfg.num_experts + 2 * cfg.shared_expert
    route = tmoe.moe_route(bp, x, cfg)
    assert route.capacity == 8 and bool((route.dest != route.drop).all())
    for i in range(8):
        alone, _ = tmoe.moe_apply(bp, x[i:i + 1], cfg, aux=False)
        assert torch.equal(alone[0], whole[i]), i


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "llama4-scout-17b-16e"])
def test_moe_decode_step_captured_gives_the_eager_bits(arch):
    """A decode step of a MoE stack (routing, dispatch and combine inside)
    captured as a CUDA graph, as the engine captures it, gives the eager
    step's logits bit for bit, at 8 slots past the window or the chunk."""
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.serve.engine import _GraphStep

    _need_card()
    cfg, params = _moe_smoke(arch)
    model = TransformerLM(cfg)
    cache = model.init_cache(8, 128)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for b in range(8):
        for k in cache.values():
            for t in k["attn"].values():
                t[:, b].copy_(torch.randn(t[:, b].shape, generator=gen, device="cuda"))
    tokens = torch.randint(0, cfg.vocab_size, (8, 1), generator=gen, device="cuda")
    pos = torch.tensor([3, 40, 70, 90, 65, 100, 33, 120], device="cuda")
    twin = {k: {"attn": {n: t.clone() for n, t in v["attn"].items()}} for k, v in cache.items()}
    eager, _ = model.decode_step(params, tokens, pos, twin)
    side = torch.cuda.Stream()                  # the engine's warm-up before a capture
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        model.decode_step(params, tokens, pos, cache)
    torch.cuda.current_stream().wait_stream(side)
    step = _GraphStep(model, params, cache, tokens, pos, 8)
    got = step.replay(tokens, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, eager)
    for k in cache:
        for n in ("k", "v"):
            assert torch.equal(cache[k]["attn"][n], twin[k]["attn"][n]), (k, n)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV", [(1, 40, 8), (8, 40, 8)])
def test_flash_decode_chunk_mask_on_a_ring_past_8192_slots(B, H, KV):
    """Llama4's chunked layers at a decode step: a ring of 8,192 slots, rows
    at positions past 8,192 (the chunk boundary, where a row sees only its
    own chunk's slots), held against the plain version (bf16 within one
    bf16 step) and bitwise alone."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(8192)
    slots, hd, chunk = 8192, 128, 8192

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, kc, vc = randn(B, H, hd), randn(B, slots, KV, hd), randn(B, slots, KV, hd)
    pos = torch.tensor([8192, 8193, 10239, 12000, 16383, 16384, 20000, 8191][:B],
                       device="cuda")
    got = tfa.flash_attention_decode(q, kc, vc, pos, chunk=chunk)
    want = tfa.flash_attention_decode_plain(q, kc, vc, pos, chunk=chunk)
    torch.testing.assert_close(got.float(), want.float(), **_flash_tol(torch.bfloat16))
    # the chunk admits only slots of the row's own chunk: at 8,192 one slot
    one = tfa.flash_attention_decode(q[:1], kc[:1], vc[:1], pos[:1], chunk=chunk)
    assert torch.equal(one[0], got[0])
    first = (vc[0, int(pos[0]) % slots].float().repeat_interleave(H // KV, 0))
    torch.testing.assert_close(got[0].float(), first, **_flash_tol(torch.bfloat16))
