"""The port's int8 path against the JAX reference, on the CPU.

``quant_matmul`` sums int8 products in integers and applies the fp32
epilogue in the oracle's order, so its plain version (what the wrapper runs
for a CPU tensor) is held *bitwise* against ``quant_matmul_pallas`` in
interpret mode and ``ref.quant_matmul_ref`` — at K = 1536 and 8960 too,
where the reference's own off-TPU wrapper sums in fp32 and is no longer
exact (ROADMAP.md, Queue 3).  ``quantize_rows`` / ``quantize_weight`` are
bitwise as well: both sides divide in fp32 and round half to even.

Tolerances, where there are any: the plain-tensor (unquantized) branch of
``linear_or_quant`` is an fp32 einsum that XLA and PyTorch sum in different
orders, so it is held at rtol = atol = 1e-5.  The CUDA kernel itself is
checked on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.quant_matmul import quant_matmul_pallas
from repro.models.layers import quant as jquant
from repro_torch import kernels as tk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models.layers import quant as tquant


def _qpair(rng, m, k, n):
    xq = rng.integers(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    xs = rng.uniform(1e-3, 2e-2, size=(m,)).astype(np.float32)
    ws = rng.uniform(1e-3, 2e-2, size=(n,)).astype(np.float32)
    return xq, xs, wq, ws


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# --------------------------------------------------------------------------- #
# the kernel's plain version
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (8, 128, 128, 8, 128, 128),
    (16, 256, 512, 8, 256, 128),
    (32, 384, 256, 16, 128, 128),
    (8, 1536, 256, 8, 256, 512),       # Qwen2-1.5B's wk / wv, decode M
    (16, 1536, 512, 16, 256, 512),     # K = 1536: past the fp32 fallback's range
])
def test_plain_bitwise_vs_pallas_interpret_and_oracle(m, k, n, bm, bn, bk):
    rng = np.random.default_rng(m * 7 + k + n)
    xq, xs, wq, ws = _qpair(rng, m, k, n)
    got = tqm.quant_matmul_plain(*_torch(xq, xs, wq, ws)).numpy()
    pallas = quant_matmul_pallas(jnp.asarray(xq), jnp.asarray(xs), jnp.asarray(wq),
                                 jnp.asarray(ws), block_m=bm, block_n=bn,
                                 block_k=bk, interpret=True)
    oracle = jref.quant_matmul_ref(jnp.asarray(xq), jnp.asarray(xs),
                                   jnp.asarray(wq), jnp.asarray(ws))
    assert np.array_equal(got, np.asarray(pallas))
    assert np.array_equal(got, np.asarray(oracle))


@pytest.mark.parametrize("m,k,n", [(1, 1537, 255), (5, 8960, 33), (33, 100, 7),
                                   (8, 8960, 64)])
def test_plain_bitwise_vs_oracle_ragged(m, k, n):
    """Shapes the Pallas blocks cannot tile (and K = 8960, w_down's depth):
    the oracle has no tiling constraint."""
    rng = np.random.default_rng(m + k + n)
    xq, xs, wq, ws = _qpair(rng, m, k, n)
    got = tqm.quant_matmul_plain(*_torch(xq, xs, wq, ws)).numpy()
    oracle = jref.quant_matmul_ref(*map(jnp.asarray, (xq, xs, wq, ws)))
    assert np.array_equal(got, np.asarray(oracle))


def test_extreme_operands_at_full_depth():
    """±127 everywhere at K = 8960: |acc| = 8960·127² ≈ 1.4e8 < 2³¹, and the
    exact integer rounds once to fp32, as in the oracle."""
    m, k, n = 8, 8960, 128
    xq = np.full((m, k), 127, np.int8)
    wq = np.full((k, n), -127, np.int8)
    xs = np.ones(m, np.float32)
    ws = np.ones(n, np.float32)
    got = tqm.quant_matmul(*_torch(xq, xs, wq, ws)).numpy()
    oracle = jref.quant_matmul_ref(*map(jnp.asarray, (xq, xs, wq, ws)))
    assert np.array_equal(got, np.asarray(oracle))
    assert np.array_equal(got, np.full((m, n), np.float32(k * 127 * -127)))


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(3)
    xq, xs, wq, ws = _torch(*_qpair(rng, 4, 96, 40))
    tk.reset_launch_counts()
    assert torch.equal(tops.quant_matmul(xq, xs, wq, ws),
                       tqm.quant_matmul_plain(xq, xs, wq, ws))
    # a transposed (N, K) layout, as QTensor hands it over, gives the same
    wt = wq.t().contiguous()
    assert torch.equal(tops.quant_matmul(xq, xs, wt.t(), ws),
                       tqm.quant_matmul_plain(xq, xs, wq, ws))
    assert tk.launch_counts()["quant_matmul"] == 0
    assert "quant_matmul" in tk.KERNELS


def test_shape_validation_matches_the_reference():
    rng = np.random.default_rng(4)
    xq, xs, wq, ws = _qpair(rng, 8, 64, 32)
    for bad in ((xq, xs[:4], wq, ws), (xq, xs, wq[:32], ws), (xq, xs, wq, ws[:5])):
        with pytest.raises(ValueError, match="shape mismatch"):
            jops.quant_matmul(*map(jnp.asarray, bad))
        with pytest.raises(ValueError, match="shape mismatch"):
            tops.quant_matmul(*_torch(*bad))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.quant_matmul(*[t.to("meta") for t in _torch(xq, xs, wq, ws)])


# the served prefill shapes (M, N) of Qwen2-1.5B and Gemma3-1B: M = 8 slots x
# the wave's padded length
SERVED_PREFILL = [(M, N) for M in (7168, 8000) for N in (256, 1536, 8960)] + [
    (M, N) for M in (8192, 15680) for N in (256, 1024, 1152, 6912)]


@pytest.mark.parametrize("M,N,want", [
    (8, 8960, 0), (16, 256, 0),               # the decode form: no tile
    (17, 256, 128), (33, 8960, 128),          # one row of tiles: narrow ones
    (8000, 256, 128), (8192, 256, 128),       # one round either way: 128
    (8000, 1536, 256), (8000, 8960, 256),     # as many rounds: 256
    (15680, 1152, 256), (15680, 256, 256),
])
def test_prefill_tile_width_by_shape(M, N, want):
    assert tqm.tile_n(M, N, 132) == want


@pytest.mark.parametrize("M,N", SERVED_PREFILL)
def test_served_prefill_tiles_fill_the_card(M, N):
    """At every served prefill shape the chosen tile gives at least three
    quarters of the 132 SMs a tile (Qwen2's wk/wv at M = 7168: 112), and
    costs no more rounds x bytes than the other."""
    bn = tqm.tile_n(M, N, 132)
    tiles = -(-M // tqm.TILE_M) * -(-N // bn)
    assert tiles >= 0.75 * 132, (M, N, bn, tiles)
    other = 384 - bn
    cost = {b: -(-(-(-M // tqm.TILE_M) * -(-N // b)) // 132) * (tqm.TILE_M + b)
            for b in (bn, other)}
    assert cost[bn] <= cost[other]


# --------------------------------------------------------------------------- #
# quantizers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bitwise(dtype):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(16, 256)) * 3.0).astype(np.float32)
    x[3] = 0.0                                       # the 1e-8 floor
    x[5, :4] = [0.5, -0.5, 1.5, 2.5]                 # halves
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qj, sj = jops.quantize_rows(xj)
    qt, st = tops.quantize_rows(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("shape,n_contract,n_batch", [
    ((64, 4, 16), 1, 0), ((4, 16, 64), 2, 0),
    ((3, 64, 4, 16), 1, 1), ((3, 4, 16, 64), 2, 1), ((2, 96, 40), 1, 1)])
def test_quantize_weight_bitwise(shape, n_contract, n_batch):
    rng = np.random.default_rng(sum(shape))
    w = rng.normal(size=shape).astype(np.float32) / 8
    jq = jquant.quantize_weight(jnp.asarray(w), n_contract, n_batch)
    tq = tquant.quantize_weight(torch.from_numpy(w), n_contract, n_batch)
    assert tq.q.shape == tuple(shape) and tq.n_contract == n_contract
    assert np.array_equal(tq.q.numpy(), np.asarray(jq.q))
    assert np.array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    # the kernel's layout: (..., N, K) contiguous, the same bytes transposed
    K = int(np.prod(shape[n_batch:n_batch + n_contract]))
    assert tq.qt.is_contiguous() and tq.qt.shape[-1] == K


@pytest.mark.parametrize("eq,xshape,wshape,nc", [
    ("bsd,dhk->bshk", (2, 5, 64), (64, 4, 16), 1),   # wq
    ("bshk,hkd->bsd", (2, 5, 4, 16), (4, 16, 64), 2),  # wo
    ("bsd,df->bsf", (1, 7, 64), (64, 96), 1),         # mlp
])
def test_linear_or_quant_matches_reference(eq, xshape, wshape, nc):
    rng = np.random.default_rng(len(eq) + sum(xshape))
    x = rng.normal(size=xshape).astype(np.float32)
    w = (rng.normal(size=wshape) / 8).astype(np.float32)
    jw = jquant.quantize_weight(jnp.asarray(w), nc)
    tw = tquant.quantize_weight(torch.from_numpy(w), nc)
    got = tquant.linear_or_quant(torch.from_numpy(x), tw, eq)
    want = jquant.linear_or_quant(jnp.asarray(x), jw, eq)
    # K ≤ 128 here, so the reference's fp32 fallback is exact: bitwise
    assert got.shape == tuple(want.shape)
    assert np.array_equal(got.numpy(), np.asarray(want))
    plain = tquant.linear_or_quant(torch.from_numpy(x), torch.from_numpy(w), eq)
    np.testing.assert_allclose(plain.numpy(),
                               np.asarray(jquant.linear_or_quant(
                                   jnp.asarray(x), jnp.asarray(w), eq)),
                               rtol=1e-5, atol=1e-5)


def _reference_tree(mode):
    from repro.configs import get_smoke
    from repro.models.transformer import init_model

    cfg = get_smoke("qwen2-1.5b")
    params, _ = init_model(jax.random.PRNGKey(0), cfg)
    return params, jquant.quantize_model_params(params, mode)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, jquant.QTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.n_contract)
    return np.asarray(tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
def test_quantize_model_params_matches_reference_tree(mode):
    from repro_torch.weights import lm_from_reference

    params, jtree = _reference_tree(mode)
    ttree = tquant.quantize_model_params(
        lm_from_reference(_host(params), device="cpu"), mode)
    jflat, tflat = _flat(jtree), _flat(ttree)
    assert set(jflat) == set(tflat)
    quantized = 0
    for name, jleaf in jflat.items():
        tleaf = tflat[name]
        if isinstance(jleaf, jquant.QTensor):
            quantized += 1
            assert isinstance(tleaf, tquant.QTensor), name
            assert tleaf.n_contract == jleaf.n_contract
            assert np.array_equal(tleaf.q.numpy(), np.asarray(jleaf.q)), name
            assert np.array_equal(tleaf.scale.numpy(), np.asarray(jleaf.scale)), name
        else:
            assert str(tleaf.dtype).split(".")[-1] == str(jleaf.dtype), name
            assert np.array_equal(tleaf.float().numpy(),
                                  np.asarray(jleaf.astype(jnp.float32))), name
    assert quantized == (7 if mode == "int8" else 0)
    if mode == "int8":
        # a quantized reference tree carries across as QTensors, bit for bit
        carried = _flat(lm_from_reference(_host(jtree), device="cpu"))
        for name, jleaf in jflat.items():
            if isinstance(jleaf, jquant.QTensor):
                assert np.array_equal(carried[name].q.numpy(), np.asarray(jleaf.q))
                assert np.array_equal(carried[name].scale.numpy(),
                                      np.asarray(jleaf.scale))
    with pytest.raises(ValueError, match="quantize="):
        tquant.quantize_model_params(ttree, "fp8")


# --------------------------------------------------------------------------- #
# quant_linear: the reference's _quant_contract for a group of weights
# --------------------------------------------------------------------------- #
def _group(rng, k, ns):
    return [(rng.integers(-127, 128, size=(k, n)).astype(np.int8),
             rng.uniform(1e-3, 2e-2, size=(n,)).astype(np.float32)) for n in ns]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ns", [(96,), (160, 40), (128, 32, 32)])
def test_quant_linear_plain_bitwise_vs_reference_contract(ns, dtype):
    """Each output of a group of 1, 2 and 3 weights is bitwise the
    reference's ``_quant_contract`` of x with that weight alone (K ≤ 256:
    the reference's off-TPU fp32 product is exact only while K·127² < 2²⁴)."""
    rng = np.random.default_rng(len(ns) * 10 + len(dtype))
    k = 256
    x = (rng.normal(size=(7, k)) * 2).astype(np.float32)
    x[2] = 0.0                                       # the 1e-8 floor
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    group = _group(rng, k, ns)
    got = tqm.quant_linear_plain(xt, [(torch.from_numpy(q), torch.from_numpy(s))
                                      for q, s in group])
    assert len(got) == len(ns)
    for out, (q, s) in zip(got, group):
        want = jquant._quant_contract(xj, jquant.QTensor(jnp.asarray(q), jnp.asarray(s), 1))
        assert out.dtype == xt.dtype and out.shape == tuple(want.shape)
        assert np.array_equal(out.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # the wrapper on a CPU tensor is the plain version, and counts nothing
    tk.reset_launch_counts()
    same = tops.quant_linear(xt, [(torch.from_numpy(q), torch.from_numpy(s))
                                  for q, s in group])
    assert all(torch.equal(a, b) for a, b in zip(same, got))
    assert tk.launch_counts()["quant_linear"] == tk.launch_counts()["quantize_rows"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_plain_ties_and_zero_rows(dtype):
    """Rows whose max |x| is 127 have a scale of exactly 1 (1 + 1e-8 rounds
    to 1 in fp32), so values k + 0.5, which bf16 holds exactly, land on
    ties that must round half to even; all-zero rows take the 1e-8 floor."""
    k = np.arange(-126, 127, dtype=np.float32)
    row = np.concatenate([k + 0.5, [127.0, -127.0, 0.0]]).astype(np.float32)
    x = np.stack([row, -row[::-1], np.zeros_like(row), row / 64])
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    qj, sj = jops.quantize_rows(xj)
    qt, st = tqm.quantize_rows_plain(xt)
    assert np.array_equal(qt.numpy(), np.asarray(qj))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    assert st[0].item() == 1.0 and st[2].item() == np.float32(1e-8)
    # half to even: 0.5 → 0, 1.5 → 2, 2.5 → 2, -0.5 → 0, -1.5 → -2
    halves = dict(zip(row[:253].tolist(), qt[0, :253].tolist()))
    assert [halves[v] for v in (0.5, 1.5, 2.5, -0.5, -1.5)] == [0, 2, 2, 0, -2]
    assert qt[2].abs().max().item() == 0


def test_shape_validation_of_the_group_call():
    x = torch.zeros(4, 8)
    w = (torch.zeros(8, 3, dtype=torch.int8), torch.ones(3))
    for bad in ([], [w] * 4, [(w[0][:5], w[1])], [(w[0], w[1][:2])]):
        with pytest.raises(ValueError):
            tops.quant_linear(x, bad)
    with pytest.raises(ValueError, match="2-D"):
        tops.quant_linear(x[None], [w])
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.quant_linear(x.to("meta"), [w])
    with pytest.raises(ValueError, match="no kernel or plain version"):
        tops.quantize_rows(x.to("meta"))


@pytest.fixture
def grouped_calls(monkeypatch):
    """The sizes of the groups the layers hand to ``ops.quant_linear``."""
    sizes = []
    inner = tops.quant_linear

    def spy(x, weights):
        sizes.append(len(weights))
        return inner(x, weights)

    monkeypatch.setattr(tops, "quant_linear", spy)
    return sizes


@pytest.mark.parametrize("layer", ["attention", "mlp"])
def test_int8_layers_through_the_grouped_call_match_the_reference(layer, grouped_calls):
    """Qwen2's SMOKE attention and SwiGLU MLP with int8 weights: q/k/v and
    gate/up each go through one ``quant_linear`` call, and the layers match
    the reference's (held at the layer tolerance of tests/test_torch_lm.py,
    1e-5: the int8 products are exact on both sides and the fp32 around
    them sums in other orders)."""
    from repro.configs import get_smoke as jget_smoke
    from repro.models.config import BlockKind as JKind
    from repro.models.layers import attention as jattn
    from repro.models.layers import mlp as jmlp
    from repro_torch.configs import get_smoke
    from repro_torch.models.config import BlockKind
    from repro_torch.models.layers import attention as tattn
    from repro_torch.models.layers import mlp as tmlp

    jcfg, tcfg = jget_smoke("qwen2-1.5b"), get_smoke("qwen2-1.5b")
    if layer == "attention":
        jp, _ = jattn.attn_init(jax.random.PRNGKey(3), jcfg, jnp.float32)
        specs = {"wq": 1, "wk": 1, "wv": 1, "wo": 2}
    else:
        jp, _ = jmlp.mlp_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
        specs = {"w_gate": 1, "w_up": 1, "w_down": 1}
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    for name, nc in specs.items():
        jp[name] = jquant.quantize_weight(jp[name], nc)
        tp[name] = tquant.quantize_weight(tp[name], nc)
    x = np.random.default_rng(4).normal(size=(2, 12, jcfg.d_model)).astype(np.float32)
    if layer == "attention":
        want, _ = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=JKind.ATTN,
                                   mode="prefill", positions=jnp.arange(12))
        got, _ = tattn.attn_apply(tp, torch.from_numpy(x), cfg=tcfg, kind=BlockKind.ATTN,
                                  mode="prefill", positions=torch.arange(12))
        assert grouped_calls == [3, 1]
    else:
        want = jmlp.mlp_apply(jp, jnp.asarray(x))
        got = tmlp.mlp_apply(tp, torch.from_numpy(x))
        assert grouped_calls == [2, 1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_group_dispatch_keeps_plain_einsums():
    """Plain weights, or a group whose contractions differ, keep one
    ``linear_or_quant`` each: the same values as called one by one."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32))
    plain = [torch.from_numpy(rng.normal(size=(16, n)).astype(np.float32)) for n in (8, 4)]
    q = tquant.quantize_weight(plain[0], 1)
    eqs = ("bsd,df->bsf",) * 2
    for ws in (plain, [q, plain[1]]):
        got = tquant.linear_or_quant_group(x, ws, eqs)
        want = [tquant.linear_or_quant(x, w, eq) for w, eq in zip(ws, eqs)]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
