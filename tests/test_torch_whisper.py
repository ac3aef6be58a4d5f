"""Whisper-small's encoder-decoder on the port against the JAX reference, on
the CPU.

``SMOKE`` (2 encoder and 2 decoder layers, d_model 128, 4 heads, 64 frames,
a learned position table of 128 rows, LayerNorm, GELU, fp32), the
weights drawn from a seed by the port's ``init_model`` into the
reference's layout (held against the reference's own) and carried across
by ``lm_from_reference``; frames and tokens drawn with numpy from a
seed.  Held: the registry and configs, the
param tree and caches, the tree quantized as drawn, ``encode``,
``forward``, ``prefill(encoder_frames=)`` and 8 decode steps (logits, the
self and cross caches, greedy tokens), the plain ``layernorm`` against the
reference's, ``sinusoidal_positions``, cross-attention decode against the
reference's all-keys ``_sdpa``, decode rows bitwise alone and in a batch,
the checks of ``lm_from_reference``, and the refusals: the serving engine
and the launcher (the engine takes no encoder frames), a prefill without
frames, a position past the table.

Tolerances.  Logits, caches and activations at rtol = atol = 1e-4, as in
``tests/test_torch_zoo.py``: fp32 on both sides, summed in other orders.
The int8 variants run under the zoo's ``_CodeReplay`` (its docstring says
why).  The plain ``layernorm`` sums in the kernel's fixed fp32 order and
the reference in XLA's: held at rtol = atol = 1e-5 (fp32 on both sides;
at d = 768 the two differ by a few ulps of the output).
``sinusoidal_positions`` is not bitwise the reference's: both take exp, sin
and cos in fp32, PyTorch's and XLA's, neither correctly rounded, and they
round apart in the last bit.  At the SMOKE table (64, 128) the two lie
within 9.6e-7 of each other (held at 2e-6); at Whisper's (1,500, 768) an
ulp of a frequency grows with the position, to 1.2e-4 at position 1,499
(held at 2.5e-4).  The angles the frequencies multiply and the table's
shape (odd and tiny widths too) are held exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models.config import BlockKind as JKind
from repro.models.layers import attention as jattn
from repro.models.layers import embedding as jemb
from repro.models.layers import norms as jnorms
from repro.models.layers.quant import quantize_model_params as jq
from repro.models.transformer import TransformerLM as JLM
from repro.models.transformer import init_model as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS, PENDING_IDS, get_config, get_smoke
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import layernorm as kln
from repro_torch.models.config import BlockKind
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import embedding as temb
from repro_torch.models.layers.quant import QTensor
from repro_torch.models.layers.quant import quantize_model_params as tq
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import ServeEngine
from repro_torch.weights import lm_from_reference
from test_torch_zoo import _close, _host, _spec, _t, replay  # noqa: F401

ARCH = "whisper-small"
NORM_TOL = dict(rtol=1e-5, atol=1e-5)
_CACHE = {}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.detach().numpy()


def _smoke():
    """The SMOKE configs, a reference tree and the port's tree carried from
    it by ``lm_from_reference``.  The reference tree holds weights that the
    port's ``init_model`` draws from a seed (the reference's own draw is
    seconds of eager XLA on the CPU); its layout is the reference's, held
    against ``jax.eval_shape`` of the reference's ``init_model`` below."""
    if "smoke" not in _CACHE:
        jcfg, tcfg = jget_smoke(ARCH), get_smoke(ARCH)
        drawn = _numpy(tinit(torch.Generator().manual_seed(5), tcfg))
        params = jax.tree.map(jnp.asarray, drawn)
        _CACHE["smoke"] = (jcfg, params, tcfg,
                           lm_from_reference(_host(params), tcfg, device="cpu"))
    return _CACHE["smoke"]


def _quantized(quantize):
    """The reference's and the port's trees quantized, once a module."""
    if quantize not in _CACHE:
        _, params, _, tparams = _smoke()
        _CACHE[quantize] = (jq(params, quantize), tq(tparams, quantize))
    return _CACHE[quantize]


def _reference(quantize):
    """The reference model and its jitted prefill and decode_step: shared by
    the module's tests at quantize="none", made anew for int8 (each compile
    under the code replay calls that test's recorder)."""
    jm = JLM(_smoke()[0])
    fns = (jm, jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return _CACHE.setdefault("jit", fns) if quantize == "none" else fns


def _frames(cfg, B=2, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)


# --------------------------------------------------------------------------- #
# configs, trees, quantization as drawn
# --------------------------------------------------------------------------- #
def test_config_and_registry_match_the_reference():
    assert ARCH in ARCH_IDS and ARCH not in PENDING_IDS
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.encoder_layers, cfg.num_layers, cfg.encoder_seq, cfg.max_seq_len,
            cfg.norm_kind, cfg.learned_pos, cfg.use_rope) == (
        12, 12, 1500, 448, "layernorm", True, False)


def test_init_tree_and_caches_match_the_reference_layout():
    jcfg, params, tcfg, _ = _smoke()
    mine = tinit(torch.Generator().manual_seed(0), tcfg)
    ref = jax.eval_shape(lambda k: jinit(k, jcfg)[0], jax.random.PRNGKey(5))
    assert _spec(mine) == _spec(ref) == _spec(params)
    assert set(mine["encoder"]) == {"blocks", "final_norm"}
    assert set(mine["blocks"]["b0"]) == {"ln1", "attn", "ln_cross", "cross", "ln2", "mlp"}
    assert _spec(TLM(tcfg, device="cpu").init_cache(2, 32)) == \
        _spec(JLM(jcfg).init_cache(2, 32))


@pytest.mark.parametrize("quantize", ["int8", "bf16"])
def test_tree_quantized_as_drawn_is_bitwise_draw_then_quantize(quantize):
    """The encoder and the cross projections too: quantized a period at a
    time as drawn, bitwise the plain tree quantized after."""
    cfg = get_smoke(ARCH)
    drawn = tq(tinit(torch.Generator().manual_seed(4), cfg), quantize)
    asdrawn = tinit(torch.Generator().manual_seed(4), dataclasses.replace(cfg, quantize=quantize))

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (k,))
        elif isinstance(tree, QTensor):
            yield path + ("qt",), tree.qt
            yield path + ("scale",), tree.scale
        else:
            yield path, tree

    a, b = dict(flat(drawn)), dict(flat(asdrawn))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    if quantize == "int8":
        for tree in (asdrawn["blocks"]["b0"]["cross"], asdrawn["encoder"]["blocks"]["b0"]["attn"],
                     asdrawn["encoder"]["blocks"]["b0"]["mlp"]):
            assert all(isinstance(w, QTensor) for w in tree.values())


# --------------------------------------------------------------------------- #
# the model against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_encode_and_forward_match(quantize, replay):
    jcfg, params, tcfg, tparams = _smoke()
    jp, tp = _quantized(quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    fr = _frames(jcfg)
    want = jax.jit(jm.encode)(jp, jnp.asarray(fr))
    _close(tm.encode(tp, _t(fr)), want)
    toks = np.random.default_rng(9).integers(0, 512, size=(2, 12)).astype(np.int32)
    want, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks), encoder_frames=jnp.asarray(fr))
    got, _ = tm.forward(tp, _t(toks), encoder_frames=_t(fr))
    _close(got, want)


def test_forward_without_frames_skips_cross_attention_as_the_reference():
    jcfg, params, tcfg, tparams = _smoke()
    toks = np.random.default_rng(2).integers(0, 512, size=(2, 9)).astype(np.int32)
    want, _ = JLM(jcfg).forward(params, jnp.asarray(toks))
    got, _ = TLM(tcfg, device="cpu").forward(tparams, _t(toks))
    _close(got, want)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_prefill_and_eight_decode_steps_match(quantize, replay):
    """prefill(encoder_frames=) of a 6-token prompt at batch 2, then 8
    greedy decode steps at one position: logits at every step, the self
    and cross caches after the prefill and at the end, the greedy tokens."""
    jcfg, params, tcfg, tparams = _smoke()
    jp, tp = _quantized(quantize)
    jm, jprefill, jdecode = _reference(quantize)
    tm = TLM(tcfg, device="cpu")
    fr = _frames(jcfg)
    toks = np.random.default_rng(9).integers(0, 512, size=(2, 6)).astype(np.int32)
    want, jc = jprefill(jp, jnp.asarray(toks), jm.init_cache(2, 32),
                        encoder_frames=jnp.asarray(fr))
    got, tc = tm.prefill(tp, _t(toks), tm.init_cache(2, 32), encoder_frames=_t(fr))
    _close(got, want)
    for part in ("attn", "cross"):
        for kv in ("k", "v"):
            _close(tc["b0"][part][kv], jc["b0"][part][kv])
    cross_k = tc["b0"]["cross"]["k"].clone()
    pos = toks.shape[1]
    for _ in range(8):
        tj = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        tt = got[:, -1].argmax(-1)
        assert tt.tolist() == tj.tolist()
        want, jc = jdecode(jp, jnp.asarray(tj[:, None]), jnp.asarray(pos, jnp.int32), jc)
        got, tc = tm.decode_step(tp, tt[:, None], pos, tc)
        _close(got, want)
        pos += 1
    _close(tc["b0"]["attn"]["v"], jc["b0"]["attn"]["v"])
    assert torch.equal(tc["b0"]["cross"]["k"], cross_k)       # decode reads it only


def test_decode_rows_equal_their_own_batch_1_steps():
    """Bitwise: prefills of 8 rows with their own frames and prompts, then
    a decode step of the 8 at their own positions gives each row the logits
    of its own batch-1 step (plain weights through ``fixed_linear``, the
    LayerNorm rows in their fixed order, cross decode over all keys)."""
    cfg = get_smoke(ARCH)
    params = tinit(torch.Generator().manual_seed(0), cfg)
    model = TLM(cfg, device="cpu")
    rng = np.random.default_rng(11)
    frames = torch.from_numpy(_frames(cfg, B=8, seed=12))
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 17, 5, 30, 9, 26, 1, 11)]
    caches, first = [], []
    for i, p in enumerate(prompts):
        logits, cache = model.prefill(params, torch.as_tensor(p[None]), model.init_cache(1, 48),
                                      encoder_frames=frames[i:i + 1])
        caches.append(cache)
        first.append(int(logits[0, -1].argmax()))

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.cat(trees, dim=1)

    tokens = torch.tensor(first)[:, None]
    pos = torch.tensor([len(p) for p in prompts])
    batched, _ = model.decode_step(params, tokens, pos, stack(caches))
    for i in range(len(prompts)):
        alone, _ = model.decode_step(params, tokens[i:i + 1], pos[i:i + 1], caches[i])
        assert torch.equal(alone[0], batched[i]), f"row {i}"


# --------------------------------------------------------------------------- #
# layers: LayerNorm, positions, cross-attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,d", [(6, 128), (3, 768), (5, 33), (2, 2100)])
def test_plain_layernorm_matches_the_reference(rows, d):
    """The plain ``layernorm`` (the kernel's fixed fp32 order) against the
    reference's at NORM_TOL in fp32, and within one bf16 step of it in
    bf16; its rows bitwise alone and in the batch."""
    rng = np.random.default_rng(d)
    x = (rng.normal(size=(rows, d)) * 3 + 1.5).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=d)).astype(np.float32)
    bias = (0.1 * rng.normal(size=d)).astype(np.float32)
    want = jnorms.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                            jnp.asarray(x), 1e-5)
    got = kln.layernorm(_t(x), _t(scale), _t(bias), 1e-5)
    _close(got, want, NORM_TOL)
    for r in range(rows):
        assert torch.equal(kln.layernorm_plain(_t(x[r:r + 1]), _t(scale), _t(bias))[0], got[r])
    xb, sb, bb = (_t(a).bfloat16() for a in (x, scale, bias))
    wb = jnorms.layernorm({"scale": jnp.asarray(sb.float().numpy()),
                           "bias": jnp.asarray(bb.float().numpy())},
                          jnp.asarray(xb.float().numpy()), 1e-5)
    gb = kln.layernorm(xb, sb, bb, 1e-5).float().numpy()
    assert np.all(np.abs(gb - np.asarray(wb)) <= 2.0 ** -7 * np.abs(np.asarray(wb)) + 1e-6)


def test_layernorm_refuses_what_the_kernel_does_not_take():
    x = torch.ones(2, 8)
    with pytest.raises(ValueError, match="feature dim"):
        kln.layernorm(x, torch.ones(7), torch.zeros(7))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kln.layernorm(x.double(), torch.ones(8), torch.zeros(8))
    with pytest.raises(TypeError, match="scale and bias"):
        kln.layernorm(x, torch.ones(8), torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kln.layernorm(x.to("meta"), torch.ones(8, device="meta"), torch.zeros(8, device="meta"))


@pytest.mark.parametrize("seq,d,tol", [(64, 128, 2e-6), (1500, 768, 2.5e-4)])
def test_sinusoidal_positions_match_the_reference(seq, d, tol):
    want = np.asarray(jemb.sinusoidal_positions(seq, d))
    got = temb.sinusoidal_positions(seq, d).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= tol
    # the frequencies' argument, divisor max(half - 1, 1) included, exactly
    half = d // 2
    arg = np.asarray(-jnp.log(10000.0) * jnp.arange(half, dtype=jnp.float32) / max(half - 1, 1))
    mine = (-np.log(np.float32(10000.0), dtype=np.float32)
            * np.arange(half, dtype=np.float32) / np.float32(max(half - 1, 1)))
    assert np.array_equal(arg, mine.astype(np.float32))
    for w in (1, 2, 3, 7):                 # odd and tiny widths: the same shape
        ref = jax.eval_shape(lambda: jemb.sinusoidal_positions(5, w))
        assert temb.sinusoidal_positions(5, w).shape == ref.shape
    assert temb.sinusoidal_positions(4, 6, torch.bfloat16).dtype == torch.bfloat16


def test_cross_decode_is_the_reference_all_keys_sdpa():
    """The decode form at position Se - 1 with ``causal=False`` admits every
    cache slot: against the reference's ``_sdpa`` with an all-ones mask, at
    Se = 64 and Se = 1,500 (Whisper's, 11 spans of 128 and a ragged one of
    92), GQA 2:1 and 1:1; and the layer's cross decode against the
    reference's."""
    rng = np.random.default_rng(4)
    for B, H, KV, Se, hd in ((2, 4, 2, 64, 32), (2, 12, 12, 1500, 64)):
        q = rng.normal(size=(B, H, hd)).astype(np.float32)
        k, v = (rng.normal(size=(B, Se, KV, hd)).astype(np.float32) for _ in range(2))
        got = kfa.flash_attention_decode(_t(q), _t(k), _t(v), torch.full((B,), Se - 1),
                                         causal=False)
        want = jax.jit(jattn._sdpa)(jnp.asarray(q)[:, None],
                                    jnp.asarray(np.repeat(k, H // KV, axis=2)),
                                    jnp.asarray(np.repeat(v, H // KV, axis=2)),
                                    jnp.ones((1, 1, 1, Se), bool), hd ** -0.5)[:, 0]
        _close(got, want)
    jcfg, params, tcfg, tparams = _smoke()
    jp, tp = params["blocks"]["b0"]["cross"], tparams["blocks"]["b0"]["cross"]
    jp, tp = jax.tree.map(lambda a: a[0], jp), {k: w[0] for k, w in tp.items()}
    x = rng.normal(size=(2, 1, 128)).astype(np.float32)
    cache = {n: rng.normal(size=(2, jcfg.encoder_seq, 4, 32)).astype(np.float32)
             for n in ("k", "v")}
    want, _ = jax.jit(lambda p, x, pos, c: jattn.attn_apply(
        p, x, cfg=jcfg, kind=JKind.ATTN, mode="decode", pos=pos, cache=c, is_cross=True,
        use_rope=False))(jp, jnp.asarray(x), jnp.asarray([3, 40], jnp.int32),
                         {n: jnp.asarray(a) for n, a in cache.items()})
    got, _ = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=BlockKind.ATTN, mode="decode",
                              pos=torch.tensor([3, 40]),
                              cache={n: _t(a) for n, a in cache.items()},
                              is_cross=True, use_rope=False)
    _close(got, want)


# --------------------------------------------------------------------------- #
# refusals and the weight carrier
# --------------------------------------------------------------------------- #
def test_serving_engine_refuses_whisper_where_the_reference_fails():
    jcfg, params, tcfg, tparams = _smoke()
    with pytest.raises(ValueError, match="encoder frames"):
        ServeEngine(tcfg, tparams, batch_size=2, max_seq=32, device="cpu")
    # the reference's engine prefills with no frames and fails there
    with pytest.raises(ValueError, match="None"):
        JEngine(jcfg, params, batch_size=2, max_seq=32).run(
            [JRequest(prompt=np.arange(4, dtype=np.int32), max_new_tokens=2)])
    with pytest.raises(ValueError, match="encoder_frames"):
        m = TLM(tcfg, device="cpu")
        m.prefill(tparams, torch.zeros((1, 3), dtype=torch.long), m.init_cache(1, 8))


def test_launcher_exits_with_the_engine_error(capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit, match="encoder frames"):
        main(["--engine", "lm", "--arch", ARCH, "--smoke", "--device", "cpu"])
    assert "frontend is stubbed" in capsys.readouterr().out


def test_positions_past_the_table_raise():
    """The reference's ``jnp.take`` reads a position past its 128-row table
    as NaN; the port raises."""
    jcfg, params, tcfg, tparams = _smoke()
    toks = np.zeros((2, 1), np.int32)
    jm, _, jdecode = _reference("none")
    want, _ = jdecode(params, jnp.asarray(toks), jnp.asarray(128, jnp.int32), jm.init_cache(2, 32))
    assert np.isnan(np.asarray(want)).all()
    m = TLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="learned position table's 128 rows"):
        m.decode_step(tparams, _t(toks), 128, m.init_cache(2, 32))
    with pytest.raises(ValueError, match="position table"):
        m.forward(tparams, torch.zeros((1, 129), dtype=torch.long))


def test_weights_carrier_checks_the_frontend_leaves():
    jcfg, params, tcfg, _ = _smoke()
    tree = _host(params)
    no_pos = {**tree, "embed": {"tok": tree["embed"]["tok"]}}
    with pytest.raises(ValueError, match="embed/pos"):
        lm_from_reference(no_pos, tcfg, device="cpu")
    no_enc = {k: v for k, v in tree.items() if k != "encoder"}
    with pytest.raises(ValueError, match="encoder"):
        lm_from_reference(no_enc, tcfg, device="cpu")
    no_cross = {**tree, "blocks": {"b0": {k: v for k, v in tree["blocks"]["b0"].items()
                                          if "cross" not in k}}}
    with pytest.raises(ValueError, match="cross"):
        lm_from_reference(no_cross, tcfg, device="cpu")
    with pytest.raises(ValueError, match="encoder"):
        lm_from_reference(tree, dataclasses.replace(tcfg, encoder_layers=3), device="cpu")
    carried = lm_from_reference(_host(_quantized("int8")[0]), tcfg, device="cpu")
    assert isinstance(carried["encoder"]["blocks"]["b0"]["attn"]["wq"], QTensor)
    assert isinstance(carried["blocks"]["b0"]["cross"]["wo"], QTensor)
