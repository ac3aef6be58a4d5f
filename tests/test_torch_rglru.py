"""The RG-LRU block (``models/layers/rglru.py``) and its scan
(``kernels/rglru_scan.py``) against the JAX reference, on the CPU.

RecurrentGemma-9B's ``SMOKE`` configuration (rnn width 128, conv width 4,
fp32), the reference's block weights carried across as numpy arrays, the
inputs drawn with numpy from a seed.  The port's prefill walks the
recurrence in time order, a multiply then an add a step (the decode step's
arithmetic); the reference pairs the terms in ``jax.lax.associative_scan``
and sums its products in XLA's order, so the two agree within fp32
rounding: outputs and states are held at rtol = atol = 1e-5 (the largest
difference read 8.3e-7 on outputs of about 1.8).  Within the port a
prefilled state and output are bitwise what token-by-token decode steps
give.  The scan's plain version runs here; its CUDA kernel is held on the
card (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models.layers import rglru as jr
from repro_torch import kernels as tk
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as trs
from repro_torch.models.layers import rglru as tr

ARCH = "recurrentgemma-9b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = jget_smoke(ARCH), get_smoke(ARCH)
    params, _ = jr.rglru_init(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    return jcfg, params, tcfg, tparams


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_init_matches_the_reference_layout(block):
    jcfg, params, tcfg, _ = block
    mine = tr.rglru_init(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in mine.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in params.items()}
    assert {k: tuple(v.shape) for k, v in mine.items()} == tr.rglru_shapes(tcfg)
    # Λ gives decays a = σ(Λ)^8 in (0.9, 0.999), as the reference draws them
    a = torch.sigmoid(mine["lam"]) ** 8
    assert float(a.min()) > 0.9 - 1e-6 and float(a.max()) < 0.999 + 1e-6
    full = tr.init_rglru_cache(get_config(ARCH), 8, torch.bfloat16)
    assert tuple(full["h"].shape) == (8, 4096) and full["h"].dtype == torch.float32
    assert tuple(full["conv"].shape) == (8, 3, 4096) and full["conv"].dtype == torch.bfloat16


@pytest.mark.parametrize("with_cache", [False, True])
def test_prefill_matches_the_reference(block, with_cache):
    jcfg, params, tcfg, tparams = block
    x = np.random.default_rng(0).standard_normal((2, 20, 128)).astype(np.float32)
    jc = jr.init_rglru_cache(jcfg, 2, jnp.float32) if with_cache else None
    tc = tr.init_rglru_cache(tcfg, 2, torch.float32) if with_cache else None
    want, jc = jr.rglru_apply(params, jnp.asarray(x), cfg=jcfg, mode="prefill", cache=jc)
    got, tc = tr.rglru_apply(tparams, torch.from_numpy(x), cfg=tcfg, mode="prefill", cache=tc)
    _close(got, want)
    assert (tc is None) == (jc is None)
    if with_cache:
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])


def test_decode_steps_match_the_reference(block):
    """A prefill from a nonzero cache, then 10 decode steps, outputs and
    states held at every step."""
    jcfg, params, tcfg, tparams = block
    rng = np.random.default_rng(1)
    h0 = rng.standard_normal((3, 128)).astype(np.float32)
    jc = {"h": jnp.asarray(h0), "conv": jnp.zeros((3, 3, 128), jnp.float32)}
    tc = {"h": torch.from_numpy(h0.copy()), "conv": torch.zeros(3, 3, 128)}
    x = rng.standard_normal((3, 7, 128)).astype(np.float32)
    want, jc = jr.rglru_apply(params, jnp.asarray(x), cfg=jcfg, mode="prefill", cache=jc)
    got, tc = tr.rglru_apply(tparams, torch.from_numpy(x), cfg=tcfg, mode="prefill", cache=tc)
    _close(got, want)
    for _ in range(10):
        xs = rng.standard_normal((3, 1, 128)).astype(np.float32)
        want, jc = jr.rglru_apply(params, jnp.asarray(xs), cfg=jcfg, mode="decode", cache=jc)
        got, tc = tr.rglru_apply(tparams, torch.from_numpy(xs), cfg=tcfg, mode="decode",
                                 cache=tc)
        _close(got, want)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])


def test_prefill_equals_token_by_token_decode_bitwise(block):
    """The scan's order is the decode step's: one prefill of 20 tokens gives
    the same outputs, state and conv taps, bit for bit, as a 1-token prefill
    and 19 decode steps."""
    _, _, tcfg, tparams = block
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 20, 128))
                         .astype(np.float32))
    whole = tr.init_rglru_cache(tcfg, 2, torch.float32)
    steps = tr.init_rglru_cache(tcfg, 2, torch.float32)
    out, _ = tr.rglru_apply(tparams, x, cfg=tcfg, mode="prefill", cache=whole)
    outs = [tr.rglru_apply(tparams, x[:, :1], cfg=tcfg, mode="prefill", cache=steps)[0]]
    for t in range(1, 20):
        outs.append(tr.rglru_apply(tparams, x[:, t:t + 1], cfg=tcfg, mode="decode",
                                   cache=steps)[0])
    assert torch.equal(out, torch.cat(outs, 1))
    assert torch.equal(whole["h"], steps["h"]) and torch.equal(whole["conv"], steps["conv"])


def _reference_scan(a, b, h0):
    """The reference's recurrence: rglru_apply's associative scan."""
    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, b1 * a2 + b2

    hs_a, hs_b = jax.lax.associative_scan(combine, (a, b), axis=1)
    return hs_b + hs_a * h0[:, None, :]


@pytest.mark.parametrize("B,S,r", [(1, 1, 8), (2, 37, 64), (3, 300, 16)])
def test_plain_scan_matches_the_reference_scan(B, S, r):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(B, S, r)).astype(np.float32)
    b = rng.standard_normal((B, S, r)).astype(np.float32)
    h0 = rng.standard_normal((B, r)).astype(np.float32)
    want = np.asarray(_reference_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)))
    hs, last = trs.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b),
                                    torch.from_numpy(h0))
    np.testing.assert_allclose(hs.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(last, hs[:, -1])
    zero, _ = trs.rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        zero.numpy(), np.asarray(_reference_scan(jnp.asarray(a), jnp.asarray(b),
                                                 jnp.zeros((B, r), jnp.float32))),
        rtol=1e-5, atol=1e-5)


def test_scan_wrapper_takes_the_plain_version_on_the_cpu_and_checks_shapes():
    tk.reset_launch_counts()
    a, b = torch.rand(2, 5, 4), torch.randn(2, 5, 4)
    hs, last = ops.rglru_scan(a, b, torch.ones(2, 4))
    want, _ = trs.rglru_scan_plain(a, b, torch.ones(2, 4))
    assert torch.equal(hs, want) and torch.equal(last, want[:, -1])
    assert trs.rglru_scan.launches == 0
    with pytest.raises(ValueError, match="must both be"):
        ops.rglru_scan(a, b[:, :3])
    with pytest.raises(ValueError, match="h0"):
        ops.rglru_scan(a, b, torch.ones(3, 4))
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.rglru_scan(a.to("meta"), b.to("meta"))


def test_decode_needs_a_cache(block):
    _, _, tcfg, tparams = block
    with pytest.raises(ValueError, match="cache"):
        tr.rglru_apply(tparams, torch.zeros(1, 1, 128), cfg=tcfg, mode="decode")
