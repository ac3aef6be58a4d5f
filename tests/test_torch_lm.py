"""The port's LM serving path against the JAX reference, on the CPU.

Qwen2-1.5B's ``SMOKE`` configuration (2 layers, d_model 128, fp32) with the
reference's weights carried across by ``lm_from_reference``: each layer,
all four attention masks, ``prefill``, ``prefill_ragged`` and
``decode_step`` are held against the JAX package, and the port's
``ServeEngine`` gives the same greedy streams as the JAX engine at
``quantize`` none and int8.

Tolerances: everything here is fp32, and XLA and PyTorch sum their
products in different orders, so layer outputs are held at rtol = atol =
1e-5 and logits after the whole stack at 1e-4 (a few ulps of the largest
logit, compounded over two layers).  The int8 products are exact on both
sides (K·127² < 2²⁴ at these widths, so the reference's fp32 fallback is
exact too); what remains is the fp32 arithmetic around them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models.config import BlockKind as JKind
from repro.models.layers import attention as jattn
from repro.models.layers import embedding as jemb
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro.models.layers import rope as jrope
from repro.models.layers.quant import QTensor as JQTensor
from repro.models.transformer import TransformerLM as JLM
from repro.models.transformer import init_model as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config, get_smoke
from repro_torch.models.config import BlockKind
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import embedding as temb
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import norms as tnorms
from repro_torch.models.layers import rope as trope
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import Request, ServeEngine, SlotScheduler
from repro_torch.weights import lm_from_reference

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ["attn", "attn_local", "attn_chunked", "attn_nope"]


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.n_contract)
    return np.asarray(tree)


def _port(tree):
    return lm_from_reference(_host(tree), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def smoke():
    """The JAX SMOKE config and weights, and the port's twins."""
    jcfg = jget_smoke("qwen2-1.5b")
    params, _ = jinit(jax.random.PRNGKey(1), jcfg)
    return jcfg, params, get_smoke("qwen2-1.5b"), _port(params)


def _mask_cfgs():
    """Configs whose masks all bite at S = 32 with q_chunk 8."""
    jcfg = dataclasses.replace(jget_smoke("qwen2-1.5b"), window=8, attn_chunk=16,
                               q_chunk=8)
    tcfg = dataclasses.replace(get_smoke("qwen2-1.5b"), window=8, attn_chunk=16,
                               q_chunk=8)
    return jcfg, tcfg


# --------------------------------------------------------------------------- #
# configs and registry
# --------------------------------------------------------------------------- #
def test_config_and_registry_match_the_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro_torch.configs import SHAPES

    assert dataclasses.asdict(get_config("qwen2-1.5b")) == dataclasses.asdict(
        jget_config("qwen2-1.5b"))
    assert dataclasses.asdict(get_smoke("qwen2-1.5b")) == dataclasses.asdict(
        jget_smoke("qwen2-1.5b"))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    # every configuration of the reference is registered (the MoE two since
    # their slice); none is pending
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro_torch.configs import ARCH_IDS, PENDING_IDS

    assert set(ARCH_IDS) == set(JARCH_IDS) and PENDING_IDS == ()
    for other in ("mixtral-8x22b", "llama4-scout-17b-16e", "llama4-scout-17b-a16e"):
        assert dataclasses.asdict(get_config(other)) == dataclasses.asdict(jget_config(other))
    with pytest.raises(KeyError):
        get_config("no-such-model")
    with pytest.raises(ValueError, match="quantize"):
        dataclasses.replace(get_smoke("qwen2-1.5b"), quantize="fp8")


def test_unported_blocks_raise():
    cfg = get_smoke("qwen2-1.5b")
    # MoE blocks and the vision prefix run since their slices (every block
    # kind is ported); the int8 KV cache runs since its slice: the
    # reference's tree, int8 codes with an fp32 scale a (slot, kv head)
    for ok in (dict(num_experts=4), dict(num_experts=4, vision_tokens=4)):
        model = TLM(dataclasses.replace(cfg, **ok), device="cpu")
        assert "moe" in tinit(torch.Generator().manual_seed(0), model.cfg)["blocks"]["b0"]
    mine = TLM(dataclasses.replace(cfg, cache_dtype="int8"), device="cpu").init_cache(2, 8)
    ref = JLM(dataclasses.replace(jget_smoke("qwen2-1.5b"), cache_dtype="int8")).init_cache(2, 8)
    for b in ref:
        attn = ref[b]["attn"]
        assert set(mine[b]["attn"]) == set(attn) == {"k", "v", "k_scale", "v_scale"}
        for name, leaf in attn.items():
            assert tuple(mine[b]["attn"][name].shape) == tuple(leaf.shape)
            assert str(mine[b]["attn"][name].dtype).split(".")[-1] == str(leaf.dtype)


def test_init_model_tree_matches_the_reference_layout(smoke):
    """Same keys, shapes and dtypes as the JAX tree, drawn from a
    torch.Generator with the same fan-in scaling."""
    jcfg, params, tcfg, _ = smoke
    mine = tinit(torch.Generator().manual_seed(0), tcfg)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]

    assert spec(mine) == spec(params)
    w = mine["blocks"]["b0"]["mlp"]["w_down"]
    assert abs(w.std().item() * np.sqrt(tcfg.d_ff) - 1.0) < 0.05


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def test_norms_rope_embedding_match(smoke):
    jcfg, params, tcfg, tparams = smoke
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 128)).astype(np.float32)
    scale = rng.normal(size=128).astype(np.float32) * 0.1
    _close(tnorms.rmsnorm({"scale": _t(scale)}, _t(x)),
           jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), LAYER_TOL)
    b = rng.normal(size=128).astype(np.float32)
    _close(tnorms.layernorm({"scale": _t(scale), "bias": _t(b)}, _t(x)),
           jnorms.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(b)},
                            jnp.asarray(x)), LAYER_TOL)
    for hd in (32, 33):                               # even and odd head_dim
        q = rng.normal(size=(2, 6, 4, hd)).astype(np.float32)
        pos = np.arange(3, 9, dtype=np.int32)
        _close(trope.apply_rope(_t(q), _t(pos)[None, :]),
               jrope.apply_rope(jnp.asarray(q), jnp.asarray(pos)[None, :]), LAYER_TOL)
    toks = rng.integers(0, 512, size=(2, 6)).astype(np.int32)
    xe = temb.embed_tokens(tparams["embed"], _t(toks))
    _close(xe, jemb.embed_tokens(params["embed"], jnp.asarray(toks)), LAYER_TOL)
    _close(temb.logits_from(tparams["embed"], _t(x)),
           jemb.logits_from(params["embed"], jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_mlp_matches(kind, quantize):
    from repro.models.layers.quant import quantize_weight as jqw
    from repro_torch.models.layers.quant import quantize_weight as tqw

    jcfg = dataclasses.replace(jget_smoke("qwen2-1.5b"), mlp_kind=kind)
    jp, _ = jmlp.mlp_init(jax.random.PRNGKey(2), jcfg, jnp.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    if quantize == "int8":           # one layer: no stacked axis
        jp = {k: jqw(v, 1) for k, v in jp.items()}
        tp = {k: tqw(v, 1) for k, v in tp.items()}
    x = np.random.default_rng(1).normal(size=(2, 5, 128)).astype(np.float32)
    _close(tmlp.mlp_apply(tp, _t(x)), jmlp.mlp_apply(jp, jnp.asarray(x)), LAYER_TOL)


def _attn_pair(jcfg, seed=3):
    jp, _ = jattn.attn_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    # the reference's biases start at zero; random ones exercise the adds
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        jp[name] = jnp.asarray(rng.normal(size=jp[name].shape) * 0.1, jnp.float32)
    return jp, lm_from_reference({"a": _host(jp)}, device="cpu")["a"]


@pytest.mark.parametrize("kind", KINDS)
def test_attention_prefill_all_masks(kind):
    """S = 32 in q_chunk 8 blocks: the key-span slicing of each mask."""
    jcfg, tcfg = _mask_cfgs()
    jp, tp = _attn_pair(jcfg)
    x = np.random.default_rng(4).normal(size=(2, 32, 128)).astype(np.float32)
    want, _ = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=JKind(kind),
                               mode="prefill", positions=jnp.arange(32))
    got, _ = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=BlockKind(kind),
                              mode="prefill", positions=torch.arange(32))
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_attention_ragged_prefill_then_per_slot_decode(kind):
    """Ragged prefill into a (ring) cache, then per-slot decode steps that
    wrap the ring: outputs and cache contents agree after every step."""
    jcfg, tcfg = _mask_cfgs()
    jp, tp = _attn_pair(jcfg, seed=5)
    B, S, max_seq = 3, 16, 24
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, 128)).astype(np.float32)
    lengths = np.asarray([16, 9, 3], np.int32)
    jc = jattn.init_kv_cache(jcfg, JKind(kind), B, max_seq, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, BlockKind(kind), B, max_seq, torch.float32)
    want, jc = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=JKind(kind),
                                mode="prefill", positions=jnp.arange(S), cache=jc,
                                lengths=jnp.asarray(lengths))
    got, tc = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=BlockKind(kind),
                               mode="prefill", positions=torch.arange(S), cache=tc,
                               lengths=_t(lengths))
    for b, n in enumerate(lengths):                  # real rows only
        _close(got[b, :n], np.asarray(want)[b, :n], LAYER_TOL)
    _close(tc["k"], jc["k"], LAYER_TOL)
    pos = lengths.copy()
    for _ in range(6):
        xd = rng.normal(size=(B, 1, 128)).astype(np.float32)
        want, jc = jattn.attn_apply(jp, jnp.asarray(xd), cfg=jcfg, kind=JKind(kind),
                                    mode="decode", pos=jnp.asarray(pos), cache=jc)
        got, tc = tattn.attn_apply(tp, _t(xd), cfg=tcfg, kind=BlockKind(kind),
                                   mode="decode", pos=_t(pos), cache=tc)
        _close(got, want, LAYER_TOL)
        _close(tc["v"], jc["v"], LAYER_TOL)
        pos += 1


def test_attention_scalar_position_decode_and_unported_paths():
    jcfg, tcfg = _mask_cfgs()
    jp, tp = _attn_pair(jcfg, seed=7)
    x = np.random.default_rng(8).normal(size=(2, 10, 128)).astype(np.float32)
    jc = jattn.init_kv_cache(jcfg, JKind.ATTN, 2, 16, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, BlockKind.ATTN, 2, 16, torch.float32)
    _, jc = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=JKind.ATTN,
                             mode="prefill", positions=jnp.arange(10), cache=jc)
    _, tc = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=BlockKind.ATTN,
                             mode="prefill", positions=torch.arange(10), cache=tc)
    xd = x[:, :1] * 0.5
    want, _ = jattn.attn_apply(jp, jnp.asarray(xd), cfg=jcfg, kind=JKind.ATTN,
                               mode="decode", pos=jnp.asarray(10, jnp.int32), cache=jc)
    got, _ = tattn.attn_apply(tp, _t(xd), cfg=tcfg, kind=BlockKind.ATTN,
                              mode="decode", pos=torch.tensor(10), cache=tc)
    _close(got, want, LAYER_TOL)
    # cross-attention over another sequence (kv_src=) is ported: the
    # reference's, q roped at positions 0..S-1 (use_rope defaults on)
    mem = np.random.default_rng(9).normal(size=(2, 7, 128)).astype(np.float32)
    want, _ = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=JKind.ATTN, mode="prefill",
                               kv_src=jnp.asarray(mem))
    got, _ = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=BlockKind.ATTN, mode="prefill",
                              kv_src=_t(mem))
    _close(got, want, LAYER_TOL)
    # the tail prefill over a restored prefix (start_pos=) runs since its
    # slice: row 0 restarts from position 0 (no prefix slot read), row 1
    # continues after the 10 positions a prefill left in the cache (fresh
    # caches: the port's decode above wrote its cache in place)
    jc = jattn.init_kv_cache(jcfg, JKind.ATTN, 2, 16, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, BlockKind.ATTN, 2, 16, torch.float32)
    _, jc = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=JKind.ATTN,
                             mode="prefill", positions=jnp.arange(10), cache=jc)
    _, tc = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=BlockKind.ATTN,
                             mode="prefill", positions=torch.arange(10), cache=tc)
    xt = np.random.default_rng(10).normal(size=(2, 4, 128)).astype(np.float32)
    starts, lens = np.asarray([0, 10], np.int32), np.asarray([4, 3], np.int32)
    want, jc = jattn.attn_apply(jp, jnp.asarray(xt), cfg=jcfg, kind=JKind.ATTN,
                                mode="prefill", cache=jc, lengths=jnp.asarray(lens),
                                start_pos=jnp.asarray(starts))
    got, tc = tattn.attn_apply(tp, _t(xt), cfg=tcfg, kind=BlockKind.ATTN, mode="prefill",
                               cache=tc, lengths=_t(lens), start_pos=_t(starts))
    for b, n in enumerate(lens):                     # real rows only
        _close(got[b, :n], np.asarray(want)[b, :n], LAYER_TOL)
    _close(tc["k"], jc["k"], LAYER_TOL)
    _close(tc["v"], jc["v"], LAYER_TOL)


# --------------------------------------------------------------------------- #
# the whole stack
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_forward_prefill_ragged_decode_match(smoke, quantize):
    from repro.models.layers.quant import quantize_model_params as jq
    from repro_torch.models.layers.quant import quantize_model_params as tq

    jcfg, params, tcfg, tparams = smoke
    jp, tp = jq(params, quantize), tq(tparams, quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 512, size=(3, 16)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, _t(toks))
    _close(got, want, LOGIT_TOL)

    jc, tc = jm.init_cache(3, 32), tm.init_cache(3, 32)
    want, jc = jm.prefill(jp, jnp.asarray(toks), jc)
    got, tc = tm.prefill(tp, _t(toks), tc)
    _close(got, want, LOGIT_TOL)

    lengths = np.asarray([16, 11, 4], np.int32)
    jc, tc = jm.init_cache(3, 32), tm.init_cache(3, 32)
    want, jc = jm.prefill_ragged(jp, jnp.asarray(toks), jnp.asarray(lengths), jc)
    got, tc = tm.prefill_ragged(tp, _t(toks), _t(lengths), tc)
    _close(got, want, LOGIT_TOL)
    _close(tc["b0"]["attn"]["k"], jc["b0"]["attn"]["k"], LOGIT_TOL)
    pos = lengths.copy()
    for step in range(4):
        tok = rng.integers(0, 512, size=(3, 1)).astype(np.int32)
        want, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        got, tc = tm.decode_step(tp, _t(tok), _t(pos), tc)
        _close(got, want, LOGIT_TOL)
        pos += 1


def test_int8_logit_error_grows_with_depth():
    """On random weights the int8 model's logits drift from the unquantized
    ones as layers stack, in the reference as much as in the port: the 20 %
    bound of tests/test_serve_router.py holds on its 2-layer model, not at
    Qwen2-1.5B's 28 layers.  Width cut to 256 (vocab 2,048) for the CPU;
    fp32, where the two packages' int8 paths agree to ~1e-4 of max |logit|
    (tolerance 1e-3)."""
    from repro.configs import get_config as jget_config
    from repro.models.layers.quant import quantize_model_params as jq
    from repro_torch.models.layers.quant import quantize_model_params as tq

    kw = dict(num_layers=28, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
              vocab_size=2048, dtype="float32", q_chunk=64)
    jcfg = jget_config("qwen2-1.5b").scaled(**kw)
    tcfg = get_config("qwen2-1.5b").scaled(**kw)
    params, _ = jinit(jax.random.PRNGKey(0), jcfg)
    tparams = _port(params)
    toks = np.random.default_rng(0).integers(0, 2048, size=(2, 64)).astype(np.int32)
    errs = {}
    for depth in (2, 28):
        jm = JLM(dataclasses.replace(jcfg, num_layers=depth))
        tm = TLM(dataclasses.replace(tcfg, num_layers=depth), device="cpu")
        jp = {**params, "blocks": jax.tree.map(lambda a: a[:depth], params["blocks"])}
        tp = {**tparams, "blocks": {"b0": {m: {k: v[:depth] for k, v in mod.items()}
                                           for m, mod in tparams["blocks"]["b0"].items()}}}
        ref, _ = jm.forward(jp, jnp.asarray(toks))
        got, _ = jm.forward(jq(jp, "int8"), jnp.asarray(toks))
        jerr = float(np.abs(np.asarray(got) - np.asarray(ref)).max()
                     / np.abs(np.asarray(ref)).max())
        tref, _ = tm.forward(tp, _t(toks))
        tgot, _ = tm.forward(tq(tp, "int8"), _t(toks))
        terr = ((tgot - tref).abs().max() / tref.abs().max()).item()
        assert abs(terr - jerr) < 1e-3, (depth, terr, jerr)
        errs[depth] = terr
    assert errs[2] < 0.20 < errs[28]


def _roll_layers(tree):
    from repro_torch.models.layers.quant import QTensor

    if isinstance(tree, dict):
        return {k: _roll_layers(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(torch.roll(tree.qt, -1, 0), torch.roll(tree.scale, -1, 0),
                       tree.n_contract, tree.shape)
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_deep_bound_sees_a_shifted_layer(dtype):
    """chip_smoke.py holds the 28-layer int8 logits to 100 % of max |logit|
    (the 2-layer 20 % bound does not carry to 28 random layers).  That limit
    must pass the sound int8 model and fail one whose int8 weights are
    shifted by one layer (layer i given layer i+1's): checked here at width
    256, 28 layers, on the port alone."""
    from repro_torch.models.layers.quant import quantize_model_params as tq

    cfg = get_config("qwen2-1.5b").scaled(
        num_layers=28, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
        vocab_size=2048, dtype=dtype, q_chunk=64)
    params = tinit(torch.Generator().manual_seed(0), cfg)
    q = tq(params, "int8")
    shifted = {**q, "blocks": _roll_layers(q["blocks"])}
    model = TLM(cfg, device="cpu")
    toks = _t(np.random.default_rng(0).integers(0, 2048, size=(2, 64)).astype(np.int32))
    ref, _ = model.forward(params, toks)
    errs = []
    for tree in (q, shifted):
        got, _ = model.forward(tree, toks)
        errs.append(((got - ref).abs().max() / ref.abs().max()).item())
    assert errs[0] <= 1.0 < errs[1], errs


def _requests(cls, lens, news, seed=42):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 512, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in zip(lens, news)]


LENS, NEWS = (5, 9, 12, 7, 14, 3), (3, 8, 5, 6, 4, 7)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_engine_streams_equal_the_jax_engine(smoke, quantize):
    """Six mixed-length requests through three slots: admission waves,
    staggered retirement, mid-decode backfill — the port's greedy streams
    equal the JAX engine's, token for token."""
    jcfg, params, tcfg, tparams = smoke
    jcfg = dataclasses.replace(jcfg, quantize=quantize)
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    jeng = JEngine(jcfg, params, batch_size=3, max_seq=64)
    teng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=64, device="cpu")
    want = jeng.run(_requests(JRequest, LENS, NEWS))
    sched = SlotScheduler(3)
    got = teng.run(_requests(Request, LENS, NEWS), scheduler=sched)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done for r in got) and sched.backfills > 0
    assert teng.calls["prefill_waves"] > 1 and teng.calls["decode_steps"] > 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_continuous_batching_equals_slot_at_a_time(smoke, quantize):
    _, _, tcfg, tparams = smoke
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    eng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=64, device="cpu")
    served = eng.run(_requests(Request, LENS, NEWS))
    solo = [eng._run_one(r) for r in _requests(Request, LENS, NEWS)]
    static = eng.run_static(_requests(Request, (6, 6, 6, 9), (4, 2, 5, 3)))
    static_solo = [eng._run_one(r) for r in _requests(Request, (6, 6, 6, 9), (4, 2, 5, 3))]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]
    assert [r.out_tokens for r in static] == [r.out_tokens for r in static_solo]


def test_engine_edge_cases_and_unported_options(smoke):
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, batch_size=2, max_seq=32, device="cpu")
    with pytest.raises(ValueError, match="advancing clock"):
        eng.run([Request(prompt=np.zeros(4, np.int32), arrival=1.0)])
    with pytest.raises(ValueError, match="max_seq"):
        eng.run([Request(prompt=np.zeros(30, np.int32), max_new_tokens=8)])
    zero = eng.run([Request(prompt=np.ones(5, np.int32), max_new_tokens=0)])
    assert zero[0].done and zero[0].out_tokens == []
    eng.warmup(prompt_lens=(5, 13))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(tcfg, tparams, batch_size=2, max_seq=32, device="cpu", mesh=object())
    # the prefix cache is served since its slice; over an int8 KV cache it
    # is refused, as the reference refuses it
    from repro_torch.serve import RadixPrefixCache

    pc = RadixPrefixCache(block_size=4, capacity_blocks=8)
    eng = ServeEngine(tcfg, tparams, batch_size=2, max_seq=32, device="cpu", prefix_cache=pc)
    assert eng.prefix_cache is pc and pc.bound
    with pytest.raises(ValueError, match="int8"):
        ServeEngine(dataclasses.replace(tcfg, cache_dtype="int8"), tparams, batch_size=2,
                    max_seq=32, device="cpu",
                    prefix_cache=RadixPrefixCache(block_size=4, capacity_blocks=8))


def test_dummy_wave_rows_are_dropped(smoke):
    """A two-request wave pads to the slot count with dummy rows routed to
    slot ``batch``: they must not land in any slot of the shared cache."""
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, batch_size=4, max_seq=32, device="cpu")
    cache = eng.init_shared_cache()
    reqs = _requests(Request, (5, 7), (1, 1))
    cache, first = eng._prefill_into(cache, [(1, reqs[0]), (3, reqs[1])])
    k = cache["b0"]["attn"]["k"]
    assert first.shape == (2,)
    assert k[:, [0, 2]].abs().sum().item() == 0.0
    assert k[:, 1, :5].abs().sum().item() > 0 and k[:, 3, :7].abs().sum().item() > 0


def test_launcher_on_cpu_and_arrival_traces():
    from repro.launch.serve import arrival_trace as jtrace
    from repro_torch.launch.serve import arrival_trace, main

    for kind in ("none", "poisson", "uniform", "burst"):
        np.testing.assert_array_equal(arrival_trace(kind, 7, 4.0, 3),
                                      jtrace(kind, 7, 4.0, 3))
    rep = main(["--engine", "lm", "--smoke", "--quantize", "int8", "--device", "cpu",
                "--requests", "5", "--slots", "2", "--max-new", "3"])
    assert rep["finished"] == 5 and rep["new_tokens"] == 15
    rep = main(["--engine", "model", "--algorithm", "kmeans", "--rows", "64",
                "--features", "8", "--batch", "16", "--device", "cpu"])
    assert rep["requests"] == 8
    # the router fleet and the prefix cache are served since their slice;
    # --mesh, still in Queue 1, raises
    rep = main(["--engine", "lm", "--smoke", "--device", "cpu", "--replicas", "2",
                "--slots", "2", "--requests", "6", "--max-new", "2",
                "--prefix-cache", "on", "--prefix-share", "1.0", "--prefix-len", "16",
                "--prefix-block", "8"])
    assert rep["finished"] == 6 and rep["new_tokens"] == 12 and rep["replicas"] == 2
    assert rep["cached_prefill_tokens"] > 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--engine", "lm", "--smoke", "--device", "cpu", "--mesh"])
