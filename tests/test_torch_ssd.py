"""The port's ``ssd_chunk_scan`` and ``rmsnorm`` against the JAX Pallas
kernels and oracles, on the CPU.

On the CPU each port wrapper runs its plain PyTorch version; it is held
against the Pallas kernel in interpret mode and against the reference's
oracle in ``src/repro/kernels/ref.py``, on the same seeded numpy inputs.
Tolerances: the scan at rtol = atol = 1e-4, ``tests/test_kernels.py``'s own
for this kernel (fp32 throughout, sums over up to 64 steps and 32 state
entries in different orders); rmsnorm in fp32 at rtol = atol = 1e-5 (only
the order of one row's sum of squares differs), in bf16 within one bf16
step of the value (rtol 2⁻⁷: both round the same fp32 value to bf16, and
an fp32 difference of an ulp can move it across a rounding boundary).
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rmsnorm import rmsnorm_pallas
from repro.kernels.ssd_scan import ssd_chunk_scan as j_ssd
from repro.models.layers import norms as jnorms
from repro_torch import kernels as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import rmsnorm as trn
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models.layers import norms as tnorms

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=0.0)


def _scan_inputs(B=2, H=3, S=128, P=16, N=32, seed=0):
    """tests/test_kernels.py's inputs: decays in (−∞, 0], unit dx, B and C
    at 0.3, a small initial state."""
    rng = np.random.default_rng(seed)
    return (-np.abs(rng.normal(size=(B, H, S))).astype(np.float32) * 0.1,
            rng.normal(size=(B, H, S, P)).astype(np.float32),
            rng.normal(size=(B, S, N)).astype(np.float32) * 0.3,
            rng.normal(size=(B, S, N)).astype(np.float32) * 0.3,
            rng.normal(size=(B, H, P, N)).astype(np.float32) * 0.1)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# --------------------------------------------------------------------------- #
# ssd_chunk_scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ssd_plain_matches_pallas_and_oracle(chunk, with_h0):
    la, dx, Bm, Cm, h0 = _scan_inputs()
    h0 = h0 if with_h0 else None
    y, h = tops.ssd_chunk_scan(_t(la), _t(dx), _t(Bm), _t(Cm), _t(h0), chunk=chunk)
    for want_y, want_h in (
            j_ssd(_j(la), _j(dx), _j(Bm), _j(Cm), _j(h0), chunk=chunk, interpret=True),
            jref.ssd_chunk_scan_ref(_j(la), _j(dx), _j(Bm), _j(Cm), _j(h0),
                                    chunk=chunk)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)
    assert y.dtype == h.dtype == torch.float32


@pytest.mark.parametrize("S,chunk", [(37, 37), (37, 64), (1, 64), (96, 1)])
def test_ssd_ragged_chunks_match_the_oracle(S, chunk):
    """L = S (one ragged chunk, as the SSD layer picks when S is not a
    multiple of its chunk), S shorter than the chunk, and L = 1."""
    la, dx, Bm, Cm, h0 = _scan_inputs(B=1, H=2, S=S, P=8, N=16, seed=1)
    L = min(chunk, S)
    y, h = tss.ssd_chunk_scan(_t(la), _t(dx), _t(Bm), _t(Cm), _t(h0), chunk=chunk)
    want_y, want_h = jref.ssd_chunk_scan_ref(_j(la), _j(dx), _j(Bm), _j(Cm), _j(h0),
                                             chunk=L)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **SCAN_TOL)


def test_ssd_chunk_that_does_not_divide_s_raises():
    """The reference falls back to its oracle with L = S; the port raises,
    and its caller picks L = S itself (the reference's fallback gives the
    same numbers)."""
    la, dx, Bm, Cm, _ = _scan_inputs(S=40)
    with pytest.raises(ValueError, match="must divide chunk"):
        tops.ssd_chunk_scan(_t(la), _t(dx), _t(Bm), _t(Cm), chunk=32)
    y, _ = tops.ssd_chunk_scan(_t(la), _t(dx), _t(Bm), _t(Cm), chunk=40)
    want, _ = jops.ssd_chunk_scan(_j(la), _j(dx), _j(Bm), _j(Cm), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **SCAN_TOL)


def test_ssd_shape_errors_match_reference():
    la, dx, Bm, Cm, _ = _scan_inputs(S=32)
    bad = la[:, :, :16]
    with pytest.raises(ValueError) as t_err:
        tops.ssd_chunk_scan(_t(bad), _t(dx), _t(Bm), _t(Cm), chunk=32)
    with pytest.raises(ValueError) as j_err:
        jops.ssd_chunk_scan(_j(bad), _j(dx), _j(Bm), _j(Cm), chunk=32)
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(ValueError, match="h0"):
        tops.ssd_chunk_scan(_t(la), _t(dx), _t(Bm), _t(Cm), torch.zeros(1, 2, 3, 4),
                            chunk=32)


def test_ssd_zero_decay_state_is_the_running_sum_of_outer_products():
    """With log_a = 0 the final state is Σ_s dx_s ⊗ B_s whatever the chunk."""
    la, dx, Bm, Cm, _ = _scan_inputs(B=1, H=2, S=64, P=8, N=16, seed=2)
    la[:] = 0.0
    want = np.einsum("bhsp,bsn->bhpn", dx, Bm)
    for chunk in (8, 64):
        _, h = tss.ssd_chunk_scan(_t(la), _t(dx), _t(Bm), _t(Cm), chunk=chunk)
        np.testing.assert_allclose(h.numpy(), want, **SCAN_TOL)


# --------------------------------------------------------------------------- #
# rmsnorm
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 7, 128), (3, 1536), (2, 37), (1, 2560)])
def test_rmsnorm_plain_matches_pallas_and_oracle(shape, dtype):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=shape) * 3.0, getattr(jnp, dtype))
    w = jnp.asarray(1.0 + rng.normal(size=shape[-1]) * 0.1, jnp.float32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tops.rmsnorm(xt, _t(w))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for want in (rmsnorm_pallas(x, w, interpret=True), jref.rmsnorm_ref(x, w)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)), **tol)


def test_rmsnorm_shape_error_matches_reference():
    with pytest.raises(ValueError) as t_err:
        tops.rmsnorm(torch.zeros(4, 8), torch.zeros(9))
    with pytest.raises(ValueError) as j_err:
        jops.rmsnorm(jnp.zeros((4, 8)), jnp.zeros((9,)))
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_norm_is_the_kernel_form_with_one_plus_scale(dtype):
    """The reference's model RMSNorm is rmsnorm_ref(x, 1 + scale): the
    same function with the products in the same order, so it is bitwise
    equal there; the port's model norm (through ops.rmsnorm) agrees."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(size=(3, 5, 64)), getattr(jnp, dtype))
    scale = jnp.asarray(rng.normal(size=64) * 0.1, getattr(jnp, dtype))
    model = jnorms.rmsnorm({"scale": scale}, x)
    kernel_form = jref.rmsnorm_ref(x, 1.0 + scale.astype(jnp.float32))
    np.testing.assert_array_equal(np.asarray(model.astype(jnp.float32)),
                                  np.asarray(kernel_form.astype(jnp.float32)))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(getattr(torch, dtype))
    st = torch.from_numpy(np.array(scale.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tnorms.rmsnorm({"scale": st}, xt)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(model.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
def test_rmsnorm_plus_one_takes_one_plus_the_stored_weight(wdtype):
    """``plus_one`` with a stored fp32 or bf16 scale is the norm with
    w = 1 + scale in fp32, bitwise, and agrees with the Pallas kernel given
    that w."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(5, 2560)) * 3.0, jnp.bfloat16)
    scale = jnp.asarray(rng.normal(size=2560) * 0.1, getattr(jnp, wdtype))
    w = 1.0 + scale.astype(jnp.float32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    st = torch.from_numpy(np.array(scale.astype(jnp.float32))).to(getattr(torch, wdtype))
    got = tops.rmsnorm(xt, st, plus_one=True)
    assert torch.equal(got, tops.rmsnorm(xt, 1.0 + st.float()))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(
        rmsnorm_pallas(x, w, interpret=True).astype(jnp.float32)), **BF16_TOL)


def test_rmsnorm_rows_do_not_depend_on_the_batch():
    """A row's plain result is the same alone and among others (the
    kernel guarantees it on the card by its fixed order)."""
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(8, 1536)).astype(np.float32))
    w = torch.ones(1536)
    full = tops.rmsnorm(x, w)
    for i in (0, 5):
        assert torch.equal(tops.rmsnorm(x[i:i + 1], w), full[i:i + 1])


def test_new_wrappers_count_no_cpu_launch_and_refuse_other_devices():
    tk.reset_launch_counts()
    la, dx, Bm, Cm, h0 = _scan_inputs(S=32)
    tss.ssd_chunk_scan(_t(la), _t(dx), _t(Bm), _t(Cm), _t(h0), chunk=32)
    trn.rmsnorm(torch.ones(2, 8), torch.ones(8))
    assert tk.launch_counts()["rmsnorm"] == tk.launch_counts()["ssd_chunk_scan"] == 0
    meta = torch.ones(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        trn.rmsnorm(meta, torch.ones(8, device="meta"))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tss.ssd_chunk_scan(*(torch.from_numpy(a).to("meta") for a in (la, dx, Bm, Cm)),
                           chunk=32)
