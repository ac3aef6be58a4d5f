"""The LM head (``kernels/lm_head.py``) against the reference's
``logits_from`` (``src/repro/models/layers/embedding.py``) through JAX, on
the CPU, where the kernel's plain version runs.

The same seeded numpy inputs go to both, tied (the token table (V, D)) and
untied (a head (D, V)), in fp32 and bf16.  Each product of two bf16 values
is exact in fp32, so the two differ only in summation order: the reference
sums in fp32 in XLA's order, the plain version in fp64 rounded to fp32.
Tolerance: ``tests/test_kernels.py``'s fp32 2e-4 (rtol and atol), logits
being O(10) here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.embedding import logits_from as jlogits_from
from repro_torch.kernels import ops
from repro_torch.kernels.lm_head import lm_head, lm_head_plain, route
from repro_torch.models.layers.embedding import logits_from

TOL = dict(rtol=2e-4, atol=2e-4)
B, S, D, V = 2, 3, 128, 264


def _inputs(tied, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((V, D) if tied else (D, V)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    tx, tw = torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype)
    return (jx, jw), (tx, tw)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_head_matches_the_reference(tied, dtype):
    (jx, jw), (tx, tw) = _inputs(tied, dtype, seed=int(tied) + 2 * (dtype == torch.bfloat16))
    key = "tok" if tied else "head"
    jparams = {key: jw} if tied else {"tok": jnp.zeros((V, D), jw.dtype), key: jw}
    tparams = {key: tw} if tied else {"tok": torch.zeros(V, D, dtype=dtype), key: tw}
    want = np.asarray(jlogits_from(jparams, jx))
    got = logits_from(tparams, tx)
    assert got.dtype == torch.float32 and got.shape == (B, S, V)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    direct = ops.lm_head(tx.reshape(-1, D), tw, tied=tied)
    assert torch.equal(direct, lm_head_plain(tx.reshape(-1, D), tw, tied=tied))
    assert torch.equal(direct.reshape(B, S, V), got)


def test_lm_head_checks_shapes():
    x = torch.zeros(4, D)
    with pytest.raises(ValueError, match="does not match"):
        lm_head(x, torch.zeros(V, D + 8), tied=True)
    with pytest.raises(ValueError, match="does not match"):
        lm_head(x, torch.zeros(V, D), tied=False)
    with pytest.raises(ValueError, match="2-D"):
        lm_head(x[None], torch.zeros(V, D), tied=True)


@pytest.mark.parametrize("dtype,tied,want", [
    (torch.bfloat16, True, "mma_bf16"),    # every served model's head
    (torch.bfloat16, False, "fma"),
    (torch.float32, True, "fma"),          # fp32 stays off the tensor cores
    (torch.float32, False, "fma"),
])
def test_route_by_dtype_and_form(dtype, tied, want):
    """The route a CUDA call takes; a CPU call runs the plain version and
    counts no route."""
    assert route(dtype, tied) == want
    before = dict(lm_head.routes)
    lm_head(torch.zeros(2, D, dtype=dtype),
            torch.zeros((V, D) if tied else (D, V), dtype=dtype), tied=tied)
    assert dict(lm_head.routes) == before
