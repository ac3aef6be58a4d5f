"""The port on the CUDA card: kernels against their plain versions, the
fitted path against the same fit on the CPU, and launch counts.

This file imports neither ``jax`` nor ``repro``, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tests marked ``cuda`` decide inside the test whether a card is present and
skip without one.  Tolerances are ``tests/test_kernels.py``'s fp32 2e-4
(for the gradient: max abs error over the largest entry); k-means
assignments are compared exactly on random data, where fp32 ties do not
occur; ``quant_matmul`` is bitwise (its sum is integer), and greedy token
streams are compared exactly.  ``rmsnorm`` is held at rtol = atol = 1e-5
in fp32 and within one bf16 step (rtol 2⁻⁷) in bf16 (only the order of a
row's sum of squares differs), and bitwise between a row alone and in a
batch; ``ssd_chunk_scan`` at rtol = atol = 1e-4, ``tests/test_kernels.py``'s
own tolerance for that kernel.  ``flash_attention`` (both forms) is held at
``tests/test_kernels.py``'s fp32 2e-4 and, in bf16, within one bf16 step
of each value (rtol 2⁻⁷, atol 1e-6: the kernel sums in fp32 where the plain
version sums in fp64, and the output rounds to bf16 either side of a
boundary); a row's output is bitwise the same alone and in a batch, and at
its exact length and padded.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.core.algorithms.kmeans import KMeans
from repro_torch.core.algorithms.logistic_regression import LogisticRegression
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import kmeans_assign as tka
from repro_torch.kernels import logreg_grad as tlg
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tss
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
                                  "kmeans_assign": 6, "quant_matmul": 0,
                                  "rmsnorm": 0, "ssd_chunk_scan": 0,
                                  "flash_attention": 0, "flash_attention_decode": 0}


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
    served = eng.run(reqs())
    forwards = eng.calls["prefill_waves"] + eng.calls["decode_steps"]
    assert tk.launch_counts()["quant_matmul"] == 7 * cfg.num_layers * forwards > 0
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
    """Mamba2-2.7B's widths (P = 64, N = 128) at L = 256 over several
    chunks and at one ragged chunk L = S, L = 37, L = 1, and the SMOKE
    widths (P = 16, N = 16)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [(1, 80, 512, 64, 128, 256), (1, 80, 301, 64, 128, 301),
             (2, 3, 74, 64, 128, 37), (2, 2, 5, 16, 16, 1), (1, 16, 40, 16, 16, 40)]
    tk.reset_launch_counts()
    for B, H, S, P, N, L in cases:
        la = -torch.rand(B, H, S, generator=gen, device="cuda") * 0.2
        dx = torch.randn(B, H, S, P, generator=gen, device="cuda")
        Bm = torch.randn(B, S, N, generator=gen, device="cuda") * 0.3
        Cm = torch.randn(B, S, N, generator=gen, device="cuda") * 0.3
        h0 = torch.randn(B, H, P, N, generator=gen, device="cuda") * 0.1 \
            if with_h0 else None
        y, h = tss.ssd_chunk_scan(la, dx, Bm, Cm, h0, chunk=L)
        yp, hp = tss.ssd_chunk_scan_plain(la, dx, Bm, Cm, h0, chunk=L)
        torch.testing.assert_close(y, yp, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(h, hp, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="P ≤ 64"):
        tss.ssd_chunk_scan(la, torch.zeros(B, H, S, 65, device="cuda"), Bm, Cm,
                           chunk=L)
    torch.cuda.synchronize()
    assert tk.launch_counts()["ssd_chunk_scan"] == len(cases)


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
    forwards = eng.calls["prefills"] + eng.calls["decode_steps"]
    assert eng.calls["prefill_waves"] == 0 and eng.calls["prefills"] == 5
    counts = tk.launch_counts()
    assert counts["ssd_chunk_scan"] == cfg.num_layers * 5
    assert counts["rmsnorm"] == (2 * cfg.num_layers + 1) * forwards
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
    the 32-key tile, and rings that have wrapped (pos ≥ slots)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    tk.reset_launch_counts()
    prefill = [((2, 12, 2, 100, 100, 128), dict()),
               ((1, 4, 1, 37, 600, 256), dict(window=512)),
               ((2, 4, 1, 64, 64, 256), dict(chunk=16)),
               ((3, 4, 4, 33, 33, 32), dict(causal=False)),
               ((1, 8, 2, 1, 77, 64), dict(window=20))]
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
    with pytest.raises(ValueError, match="at most 8"):
        tfa.flash_attention_decode(randn(1, 16, 32), randn(1, 8, 1, 32),
                                   randn(1, 8, 1, 32), torch.zeros(1, device="cuda"))
    torch.cuda.synchronize()
    assert tk.launch_counts()["flash_attention"] == len(prefill)
    assert tk.launch_counts()["flash_attention_decode"] == len(decode)


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
    for H, KV, hd, kw in ((4, 1, 256, dict(window=512)), (12, 2, 128, dict())):
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
