"""The decode step's fixed-order products (``kernels/fixed_linear.py``), the
SSD decode step (``kernels/ssd_scan.py``'s ``ssd_decode``) and the norms
folded into them, on the CPU, where the kernels' plain versions run.

Against the reference through JAX, with the same seeded numpy inputs:

* ``fixed_linear_plain`` against the reference layers' einsums
  (``preferred_element_type=float32``), with no prologue, behind the
  model's RMSNorm (``repro.models.layers.norms.rmsnorm``) and behind
  Mamba-2's gated norm (``repro.models.layers.ssd._gated_norm``: the port
  computes the gate y·silu(z) in ``ssd_decode`` and normalises it in the
  product's prologue).  Each
  product of two bf16 values is exact in fp32 and both sides sum fp32
  products, so they differ in summation order only (the plain version sums
  in fp64 and rounds once): fp32 outputs are held at rtol = atol = 2e-5 (K
  ≤ 256 terms of O(1), so the fp32 order moves a sum by ~1e-6), bf16
  outputs within one bf16 step (rtol 2⁻⁷, atol 1e-6), where the two sums
  can round to either side of a boundary.
* ``ssd_decode_plain`` against ``repro.models.layers.ssd.ssd_apply(mode=
  "decode")``: the new state at ``tests/test_torch_mamba2.py``'s
  rtol = atol = 1e-4 (the projections that feed it differ in summation
  order), and the whole decode layer through the port's kernels' plain
  versions against the reference's output at the same tolerance.

Each folded route against its composition, bitwise (the plain versions
compute the composition): ``fixed_linear(norm=)`` and ``rmsnorm`` then
``fixed_linear``; ``ssd_decode``'s gate through ``fixed_linear(norm=)`` and
the layer's gated norm then ``fixed_linear``; a decode block handed a
``PreNorm`` and the same block on the normed x.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke as jget_smoke
from repro.models.layers import norms as jnorms
from repro.models.layers import ssd as jssd
from repro.models.transformer import init_model as jinit
from repro_torch.configs import get_smoke
from repro_torch.kernels import fixed_linear as tfl
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models.layers import ssd as tssd
from repro_torch.models.layers.attention import attn_apply, init_kv_cache
from repro_torch.models.layers.mlp import mlp_apply
from repro_torch.models.layers.norms import PreNorm
from repro_torch.models.transformer import init_model, layer_slice
from repro_torch.weights import lm_from_reference

FP32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2.0 ** -7, atol=1e-6)
LAYER_TOL = dict(rtol=1e-4, atol=1e-4)
EPS = 1e-6


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(a, _jdt(dtype)), torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _close(got, want, dtype):
    tol = BF16_TOL if dtype == torch.bfloat16 else FP32_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _operands(seed, M, K, Ns, dtype):
    rng = np.random.default_rng(seed)
    x = _pair(rng.standard_normal((M, K)), dtype)
    ws = [_pair(rng.standard_normal((K, n)) / np.sqrt(K), dtype) for n in Ns]
    return rng, x, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,Ns", [(1, 64, (48,)), (8, 128, (256, 16, 16, 4)),
                                    (16, 256, (40, 8))])
def test_plain_products_match_the_reference_einsums(M, K, Ns, dtype):
    _, (jx, tx), ws = _operands(M + K, M, K, Ns, dtype)
    outs = [dtype] + [torch.float32] * (len(Ns) - 1)
    got = tfl.fixed_linear_plain(tx, [tw for _, tw in ws], outs)
    for g, (jw, _), dt in zip(got, ws, outs):
        want = jnp.einsum("md,dn->mn", jx, jw, preferred_element_type=jnp.float32)
        assert g.dtype == dt and g.shape == (M, jw.shape[1])
        _close(g, want.astype(_jdt(dt)), dt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_prologue_matches_the_reference_norm_then_einsum(dtype):
    rng, (jx, tx), ws = _operands(3, 8, 128, (64, 32), dtype)
    jscale, tscale = _pair(rng.standard_normal(128) * 0.1, dtype)
    normed = jnorms.rmsnorm({"scale": jscale}, jx, EPS)
    got = tfl.fixed_linear_plain(tx, [tw for _, tw in ws], norm=(tscale, EPS, True))
    for g, (jw, _) in zip(got, ws):
        want = jnp.einsum("md,dn->mn", normed, jw, preferred_element_type=jnp.float32)
        _close(g, want.astype(_jdt(dtype)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gated_norm_prologue_matches_the_reference_gated_norm_then_einsum(dtype):
    rng, (jy, ty), ws = _operands(4, 8, 128, (96,), dtype)
    jz, tz = _pair(rng.standard_normal((8, 128)), dtype)
    jscale, tscale = _pair(1.0 + rng.standard_normal(128) * 0.1, dtype)
    normed = jssd._gated_norm(jy, jz, jscale, EPS)
    gate = ty.float() * F.silu(tz.float())         # what ssd_decode hands over
    (got,) = tfl.fixed_linear_plain(gate, [ws[0][1]], norm=(tscale, EPS, False))
    want = jnp.einsum("md,dn->mn", normed, ws[0][0], preferred_element_type=jnp.float32)
    assert got.dtype == dtype
    _close(got, want.astype(_jdt(dtype)), dtype)


def test_plain_rows_do_not_depend_on_the_batch():
    _, (_, tx), ws = _operands(5, 8, 256, (128, 24), torch.float32)
    tws = [tw for _, tw in ws]
    whole = tfl.fixed_linear_plain(tx, tws, norm=(torch.ones(256), EPS, False))
    for m in range(8):
        alone = tfl.fixed_linear_plain(tx[m:m + 1], tws, norm=(torch.ones(256), EPS, False))
        assert all(torch.equal(a[0], w[m]) for a, w in zip(alone, whole))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_folded_routes_equal_their_compositions(dtype):
    rng, (_, tx), ws = _operands(6, 8, 64, (32, 16), dtype)
    tws = [tw for _, tw in ws]
    scale = torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 0.1).to(dtype)
    z = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).to(dtype)
    folded = ops.fixed_linear(tx, tws, norm=(scale, EPS, True))
    unfused = ops.fixed_linear(ops.rmsnorm(tx, scale, EPS, plus_one=True), tws)
    assert all(torch.equal(a, b) for a, b in zip(folded, unfused))
    folded = ops.fixed_linear(tx.float() * F.silu(z.float()), tws, norm=(scale, EPS, False))
    unfused = ops.fixed_linear(tssd._gated_norm(tx, z, scale, EPS), tws)
    assert all(torch.equal(a, b) for a, b in zip(folded, unfused))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_decode_blocks_handed_a_prenorm_equal_the_normed_input(quantize):
    """The attention and MLP layers of Qwen2's SMOKE model at a decode step:
    handed a ``PreNorm``, the same bits as on the normed x."""
    import dataclasses

    from repro_torch.models.layers.quant import quantize_model_params

    cfg = dataclasses.replace(get_smoke("qwen2-1.5b"), quantize=quantize)
    params = quantize_model_params(init_model(torch.Generator().manual_seed(0), cfg),
                                   quantize)
    bp = layer_slice(params["blocks"], 0)["b0"]
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 1, cfg.d_model)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(cfg.d_model).astype(np.float32) * 0.1)
    pre = PreNorm(x, scale, cfg.norm_eps)
    pos = torch.tensor([3, 9, 0, 17])
    outs = []
    for h in (pre, pre.apply()):
        cache = init_kv_cache(cfg, cfg.pattern[0], 4, 32, torch.float32)
        a, _ = attn_apply(bp["attn"], h, cfg=cfg, kind=cfg.pattern[0], mode="decode",
                          pos=pos, cache=cache)
        outs += [a, mlp_apply(bp["mlp"], h)]
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])


def _smoke_ssd():
    jcfg = jget_smoke("mamba2-2.7b")
    jparams, _ = jinit(jax.random.PRNGKey(0), jcfg)
    host = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = lm_from_reference(host, get_smoke("mamba2-2.7b"), device="cpu")
    layer = lambda tree: {k: v[0] for k, v in tree["blocks"]["b0"]["ssd"].items()}  # noqa: E731
    return jcfg, layer(jparams), layer(tparams)


def test_ssd_decode_plain_matches_the_reference_decode():
    jcfg, jp, tp = _smoke_ssd()
    cfg = get_smoke("mamba2-2.7b")
    rng = np.random.default_rng(8)
    B, H, P, N = 3, cfg.ssd_heads, cfg.ssd_head_dim, cfg.ssm_state
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    h0 = (rng.standard_normal((B, H, P, N)) * 0.5).astype(np.float32)
    conv = rng.standard_normal((B, cfg.conv_width - 1, cfg.d_inner_ssd)).astype(np.float32)
    jout, jcache = jssd.ssd_apply(jp, jnp.asarray(x), cfg=jcfg, mode="decode",
                                  cache={"h": jnp.asarray(h0), "conv": jnp.asarray(conv)})

    # the decode step's inputs as the port's layer makes them
    tx = torch.from_numpy(x)
    z, xin, Bm, Cm, dt_raw = tfl.fixed_linear_plain(
        tx[:, 0], [tp[k] for k in ("wz", "wx", "wB", "wC", "wdt")])
    xin, _ = tssd._causal_conv(xin[:, None], tp["conv_x"], tp["conv_b"],
                               torch.from_numpy(conv.copy()))
    h = torch.from_numpy(h0.copy())
    y = tss.ssd_decode_plain(h, dt_raw, xin.reshape(B, H, P), Bm, Cm, tp["dt_bias"],
                             tp["A_log"], tp["D"])
    assert y.shape == (B, H, P) and y.dtype == torch.float32
    np.testing.assert_allclose(h.numpy(), np.asarray(jcache["h"]), **LAYER_TOL)

    # ... and the whole decode layer against the reference's output
    cache = {"h": torch.from_numpy(h0.copy()), "conv": torch.from_numpy(conv.copy())}
    out, cache = tssd.ssd_apply(tp, tx, cfg=cfg, mode="decode", cache=cache)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **LAYER_TOL)
    assert torch.equal(cache["h"], h)
    np.testing.assert_allclose(cache["conv"].numpy(), np.asarray(jcache["conv"]), **LAYER_TOL)


def test_ssd_decode_wrapper_is_its_plain_version_on_the_cpu():
    rng = np.random.default_rng(9)
    B, H, P, N = 2, 3, 4, 8
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    args = [t(B, H), t(B, H, P), t(B, N), t(B, N), t(H), t(H), t(H)]
    h0 = t(B, H, P, N)
    ha, hb = h0.clone(), h0.clone()
    ya = ops.ssd_decode(ha, *args)
    yb = tss.ssd_decode_plain(hb, *args)
    assert torch.equal(ya, yb) and torch.equal(ha, hb) and not torch.equal(ha, h0)
    z = t(B, H, P)                        # the gate: y·silu(z) in fp32
    gate = ops.ssd_decode(h0.clone(), *args, z=z)
    assert gate.dtype == torch.float32 and torch.equal(gate, ya.float() * F.silu(z))
    for m in range(B):                     # a slot alone: the same bits
        hm = h0[m:m + 1].clone()
        ym = tss.ssd_decode_plain(hm, *[a[m:m + 1] if a.shape[0] == B and a.ndim > 1 else a
                                       for a in args])
        assert torch.equal(ym[0], ya[m]) and torch.equal(hm[0], ha[m])


def test_shape_errors():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="shape mismatch"):
        tfl.fixed_linear(x, [torch.ones(4, 3)])
    with pytest.raises(ValueError, match="1 to 5 weights"):
        tfl.fixed_linear(x, [torch.ones(8, 3)] * 6)
    with pytest.raises(ValueError, match="norm scale"):
        tfl.fixed_linear(x, [torch.ones(8, 3)], norm=(torch.ones(7), EPS, True))
    with pytest.raises(ValueError, match="shape mismatch"):
        tss.ssd_decode(torch.zeros(1, 2, 3, 4), torch.zeros(1, 2), torch.zeros(1, 2, 3),
                       torch.zeros(1, 5), torch.zeros(1, 4), torch.zeros(2), torch.zeros(2),
                       torch.zeros(2))


@pytest.mark.parametrize("shape,nc", [((3, 16, 40), 1), ((2, 4, 8, 24), 2)])
def test_kernel_layout_keeps_shape_and_values(shape, nc):
    """``kernel_layout`` stores a stacked weight with its contracted axes
    fastest, the same shape and values; ``place`` keeps a CPU tree's
    storage as it is (the layout is the card's)."""
    from repro_torch.models.params import in_kernel_layout, kernel_layout, place

    w = torch.from_numpy(np.random.default_rng(13).standard_normal(shape).astype(np.float32))
    k = kernel_layout(w, nc, n_batch=1)
    assert k.shape == w.shape and torch.equal(k, w)
    assert in_kernel_layout(k, nc, 1) and not in_kernel_layout(w, nc, 1)
    K = int(np.prod(shape[1:1 + nc]))
    assert k[0].reshape(K, -1).t().is_contiguous()
    tree = place({"blocks": {"b0": {"attn": {"wq" if nc == 1 else "wo": w}}}},
                 torch.device("cpu"))
    assert next(iter(tree["blocks"]["b0"]["attn"].values())).stride() == w.stride()
