"""Kernel 6, flash attention, on the CPU: the port's plain versions of its
two forms against the reference's Pallas kernel in interpret mode.

The prefill form is held against ``repro.kernels.flash_attention.
flash_attention(..., interpret=True)`` on the same seeded inputs, for the
causal, sliding-window and chunked masks, GQA 1:1, 2:1 and 4:1, Sq < Sk,
and hd 32 and 256.  The decode form has no Pallas counterpart: it is held
against the Pallas kernel run on the same keys in position order (one
query at the last position), over ring caches that have wrapped.

Tolerances: fp32 inputs, and the two sides sum in different orders (the
plain versions in fp64, rounded to fp32; the Pallas kernel in fp32, online
over 32-key blocks), so outputs agree at rtol = atol = 1e-5; in bf16 within
one bf16 step of the output (rtol 2⁻⁷) plus 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch import kernels as tk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
MASKS = {"causal": dict(causal=True),
         "window": dict(causal=True, window=24),
         "chunk": dict(causal=True, chunk=16),
         "window, not causal": dict(causal=False, window=24)}


def _qkv(B, H, KV, Sq, Sk, hd, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, Sq, hd)).astype(np.float32)
    k = rng.normal(size=(B, KV, Sk, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, Sk, hd)).astype(np.float32)
    return [a.astype(dtype) for a in (q, k, v)]


def _pallas(q, k, v, block=16, **mask):
    Sq, Sk = q.shape[2], k.shape[2]
    return np.asarray(pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   block_q=min(block, Sq), block_k=min(block, Sk),
                                   interpret=True, **mask))


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_prefill_plain_matches_pallas(mask, groups):
    """hd 32, Sq = Sk = 64, every mask and GQA group size."""
    q, k, v = _qkv(2, 4, 4 // groups, 64, 64, 32, seed=groups)
    want = _pallas(q, k, v, **MASKS[mask])
    got = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **MASKS[mask])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mask", list(MASKS))
def test_prefill_plain_matches_pallas_hd256_queries_at_the_end(mask):
    """hd 256 (Gemma3's), GQA 4:1, 32 queries at the last positions of 80
    keys (Sq < Sk, and Sk not a multiple of 32)."""
    q, k, v = _qkv(1, 4, 1, 32, 80, 256, seed=7)
    want = _pallas(q, k, v, **MASKS[mask])
    got = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **MASKS[mask])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_prefill_plain_matches_pallas_in_bf16():
    import ml_dtypes

    q, k, v = _qkv(2, 4, 2, 32, 32, 32, seed=3, dtype=ml_dtypes.bfloat16)
    want = _pallas(q, k, v, window=12).astype(np.float32)
    tq, tk_, tv = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   for a in (q, k, v))
    got = tfa.flash_attention_plain(tq, tk_, tv, window=12)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_fully_masked_rows_are_zero_as_in_the_kernel():
    """A window of 0 admits no key: the Pallas kernel returns 0 there (and
    so does the port), where the oracle flash_attention_ref averages V."""
    q, k, v = _qkv(1, 2, 1, 16, 16, 32, seed=4)
    want = _pallas(q, k, v, window=0)
    got = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), window=0)
    assert np.all(want == 0) and np.all(got.numpy() == 0)
    oracle = np.asarray(jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                                 jnp.asarray(v), window=0))
    assert np.abs(oracle).max() > 0.01


def _ring(k_seq, slots):
    """A ring cache of ``slots`` slots after writing positions 0..P-1 of
    ``k_seq`` (KV, P, hd) in order: slot s holds the last position ≡ s."""
    KV, P, hd = k_seq.shape
    ring = np.zeros((slots, KV, hd), np.float32)
    for p in range(P):
        ring[p % slots] = k_seq[:, p]
    return ring


@pytest.mark.parametrize("mask,slots", [("global", 96), ("local", 24), ("chunk", 16),
                                        ("global ring", 40)])
def test_decode_plain_on_a_wrapped_ring_matches_pallas(mask, slots):
    """Three rows at their own positions (one before the ring wraps, two
    after, pos ≥ slots), GQA 4:1 at hd 32 and 2:1 at hd 256: each row
    against the Pallas kernel on that row's keys 0..pos in position order,
    one query at the last position."""
    kw = {"global": dict(causal=True), "local": dict(causal=True, window=24),
          "chunk": dict(causal=True, chunk=16), "global ring": dict(causal=True)}[mask]
    for H, KV, hd in ((4, 1, 32), (4, 2, 256)):
        rng = np.random.default_rng(slots + hd)
        positions = [min(slots - 5, 20), 47, 95]
        P = max(positions) + 1
        q = rng.normal(size=(3, H, hd)).astype(np.float32)
        k_seq = rng.normal(size=(3, KV, P, hd)).astype(np.float32)
        v_seq = rng.normal(size=(3, KV, P, hd)).astype(np.float32)
        kc = np.stack([_ring(k_seq[b][:, :p + 1], slots) for b, p in enumerate(positions)])
        vc = np.stack([_ring(v_seq[b][:, :p + 1], slots) for b, p in enumerate(positions)])
        got = tfa.flash_attention_decode_plain(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.tensor(positions), **kw)
        for b, p in enumerate(positions):
            n = p + 1
            # the global ring's window is its slot count: keys it evicted are
            # gone from the cache, so the Pallas side sees the same window
            extra = dict(window=slots) if mask == "global ring" else {}
            want = _pallas(q[b][None, :, None], k_seq[b][None, :, :n],
                           v_seq[b][None, :, :n], block=n, **kw, **extra)
            np.testing.assert_allclose(got[b].numpy(), want[0, :, 0], **TOL)


def test_decode_form_is_the_prefill_form_at_one_query():
    """Before the ring wraps, a decode row equals the prefill form's last
    query over the same keys in position order."""
    rng = np.random.default_rng(11)
    q, k, v = _qkv(1, 4, 2, 1, 40, 64, seed=11)
    kc = np.zeros((1, 64, 2, 64), np.float32)
    vc = np.zeros_like(kc)
    kc[0, :40] = k[0].transpose(1, 0, 2)
    vc[0, :40] = v[0].transpose(1, 0, 2)
    vc[0, 40:] = rng.normal(size=(24, 2, 64))      # stale slots past pos
    for kw in (dict(), dict(window=9), dict(chunk=32)):
        want = tfa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), **kw)
        got = tfa.flash_attention_decode_plain(
            torch.from_numpy(q[:, :, 0]), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.tensor([39]), **kw)
        np.testing.assert_allclose(got.numpy(), want[:, :, 0].numpy(), **TOL)


def test_bf16_terms_sum_back_exactly():
    """Three bf16 terms hold an fp32 value's 24 significant bits: their sum
    is the value, over a wide range of magnitudes; one or two terms are
    not."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy((rng.normal(size=4096) * 2.0 ** rng.integers(-60, 60, 4096))
                         .astype(np.float32))
    for terms in (1, 2, 3):
        parts = tfa.bf16_terms(x, terms)
        assert len(parts) == terms and all(t.dtype == torch.bfloat16 for t in parts)
        exact = sum(t.double() for t in parts) == x.double()
        if terms == 3:
            assert bool(exact.all())
        else:
            assert exact.float().mean() < 0.1
    assert not tfa.flash_attention.routes     # a CPU tensor takes no route


def _attention_in_terms(q, k, v, terms):
    """The tensor-core prefill kernel's arithmetic, causal: bf16 scores'
    products exact and summed in fp32, an fp32 softmax, and P · V with each
    probability in ``terms`` bf16 terms, every product with bf16 V exact
    and the sums in fp32."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, Sq, hd)
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * hd ** -0.5
    pq = torch.arange(Sq)[:, None] + (Sk - Sq)
    valid = tfa._admitted(pq, torch.arange(Sk)[None, :], True, None, None)
    s = torch.where(valid, s, torch.full((), tfa.NEG_INF))
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), torch.zeros(()))
    acc = sum(torch.einsum("bkgqs,bksd->bkgqd", t.float(), v.float())
              for t in tfa.bf16_terms(p, terms))
    out = acc / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return out.to(torch.bfloat16).reshape(B, H, Sq, hd)


def test_three_bf16_terms_of_p_keep_the_bf16_tolerance():
    """The precision choice of the tensor-core prefill kernel, at (1, 4, 1,
    512, 512, 256) causal in bf16: P · V with p in three bf16 terms stays
    within the card's bf16 tolerance of the plain version (one bf16 step of
    each value, rtol 2⁻⁷, + 1e-6); with p rounded to one bf16 term it does
    not."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 4, 1, 512, 512, 256, seed=13))
    want = tfa.flash_attention_plain(q, k, v).float()
    allowed = BF16_TOL["atol"] + BF16_TOL["rtol"] * want.abs()
    ratio = {terms: ((_attention_in_terms(q, k, v, terms).float() - want).abs()
                     / allowed).max().item() for terms in (1, 3)}
    assert ratio[3] <= 1.0, ratio
    assert ratio[1] > 1.0, ratio


def test_wrappers_validate_like_the_reference():
    """ops.flash_attention raises the reference wrapper's errors, with its
    texts; no launch is counted for a CPU tensor."""
    tk.reset_launch_counts()
    q = torch.zeros(1, 6, 8, 32)
    for k, v in ((torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 9, 32)),
                 (torch.zeros(1, 4, 8, 32), torch.zeros(1, 4, 8, 32))):
        with pytest.raises(ValueError) as t_err:
            ops.flash_attention(q, k, v)
        with pytest.raises(ValueError) as j_err:
            jops.flash_attention(*(jnp.zeros(tuple(t.shape)) for t in (q, k, v)))
        assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="pos"):
        ops.flash_attention_decode(torch.zeros(2, 4, 32), torch.zeros(2, 8, 1, 32),
                                   torch.zeros(2, 8, 1, 32), torch.zeros(3))
    with pytest.raises(ValueError, match="chunk"):
        ops.flash_attention(q, torch.zeros(1, 2, 8, 32), torch.zeros(1, 2, 8, 32), chunk=0)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.flash_attention(*(torch.zeros(1, 2, 8, 32, device="meta") for _ in range(3)))
    out = ops.flash_attention(q, torch.ones(1, 2, 8, 32), torch.ones(1, 2, 8, 32))
    assert out.shape == q.shape and tk.launch_counts()["flash_attention"] == 0
    assert tk.launch_counts()["flash_attention_decode"] == 0
