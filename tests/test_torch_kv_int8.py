"""The port's int8 KV cache (``cache_dtype="int8"``) against the JAX
reference, on the CPU.

The cache holds int8 codes (B, slots, KV, hd) and an fp32 scale a (slot, kv
head); every write quantizes through ``quantize_rows`` (the reference's
``_quantize``), a prefill attends the raw K/V, and a decode step reads the
codes through kernel 6's int8 route, whose plain version dequantizes as the
reference's ``_cache_read`` does (bf16) before the decode form.

The reference's layer rounds the softmax probabilities to v's dtype before
their product with V (``_sdpa``), and ``_cache_read`` gives bf16 whatever the
model's dtype, so over an int8 cache it rounds them to bf16 even in an fp32
model.  Kernel 6 keeps them in fp32, as the Pallas kernel does, and its int8
route is bitwise its bf16 route over the dequantized caches (ROADMAP.md,
Queue 3).  So the layer is held twice: against the reference as it is,
within the bf16 rounding of each probability (max abs error at most 2⁻⁸ ·
max |v|, a relative error of 2⁻⁹ a probability, doubled), and against the
reference with the kernel's fp32 probabilities (``kernel_sdpa``) at the fp32
tolerances below; the stack and the streams are held against the latter.

Tolerances: the quantization itself is held bitwise (codes and scales) on
the same inputs.  Across the stack both sides are fp32 summed in different
orders, so layer outputs are held at rtol = atol = 1e-5 and logits at 1e-4,
as in ``tests/test_torch_lm.py``.  The K/V the two sides quantize then
differ by ulps, and a value within an ulp of a half-way point between two
codes can round apart, and so can a dequantized value near a bf16 half-way
point when the two scales differ by an ulp: ``_KVReplay`` (after
``_CodeReplay``, ``tests/test_torch_zoo.py``) holds each port quantization
against the reference's (inputs at 1e-4, at most 2 codes apart, each by one
code at a tie; scales at rtol 1e-5) and hands the port the reference's codes
and scales, so that what follows is held at the same tolerances and the
greedy streams are compared exactly.
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
from repro.models.transformer import TransformerLM as JLM
from repro.models.transformer import init_model as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels.quant_matmul import quantize_rows_plain
from repro_torch.models.config import BlockKind
from repro_torch.models.layers import attention as tattn
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import lm_cache_from_reference, lm_from_reference
from test_torch_lm import KINDS, LAYER_TOL, LOGIT_TOL, _attn_pair, _close, _host, _t
from test_torch_zoo import _CodeReplay

ARCHS = ("qwen2-1.5b", "gemma3-1b")
SCALE_TOL = dict(rtol=1e-5, atol=0)


class _KVReplay(_CodeReplay):
    """``_CodeReplay`` for the K/V cache's codes and their scales.  A scale
    is max|x|/127 + 1e-8 of inputs that differ by ulps, so the two sides'
    scales differ by ulps, and a dequantized value bf16(code · scale) near a
    bf16 half-way point rounds apart; so each port scale is held against
    the reference's (``SCALE_TOL``) and replaced by it, as a flipped code
    is."""

    def __init__(self):
        super().__init__()
        self.scales = []

    def record_kv(self, x, xq, xs):
        self.ref.append((np.asarray(x), np.asarray(xq)))
        self.scales.append(np.asarray(xs))

    def take_kv(self, x, xq, xs):
        self.take(x, xq)
        rs = self.scales.pop(0).reshape(tuple(xs.shape))
        np.testing.assert_allclose(xs.numpy(), rs, **SCALE_TOL)
        xs.copy_(torch.from_numpy(rs.copy()))


@pytest.fixture
def kv_replay(monkeypatch):
    """The reference's K/V codes and scales (its ``_quantize``), held
    against the port's (``ops.quantize_rows``, which only the KV cache
    calls) and handed to it."""
    rep = _KVReplay()
    ref_q = jattn._quantize

    def ref(x):
        xq, xs = ref_q(x)
        jax.debug.callback(rep.record_kv, x.astype(jnp.float32), xq, xs, ordered=True)
        return xq, xs

    def port(x):
        xq, xs = quantize_rows_plain(x)
        rep.take_kv(x, xq, xs)
        return xq, xs

    jax.clear_caches()
    monkeypatch.setattr(jattn, "_quantize", ref)
    monkeypatch.setattr(tops, "quantize_rows", port)
    yield rep
    jax.effects_barrier()
    jax.clear_caches()


@pytest.fixture
def kernel_sdpa(monkeypatch):
    """The reference's ``_sdpa`` with the probabilities kept in fp32 for
    their product with V: kernel 6's function (and the Pallas kernel's)."""
    def sdpa(q, k, v, mask, scale):
        logits = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                            preferred_element_type=jnp.float32) * scale
        probs = jax.nn.softmax(jnp.where(mask, logits, jattn.NEG_INF), axis=-1)
        out = jnp.einsum("bhqk,bkhd->bqhd", probs, v.astype(jnp.float32),
                         preferred_element_type=jnp.float32)
        return out.astype(q.dtype)

    jax.clear_caches()
    monkeypatch.setattr(jattn, "_sdpa", sdpa)
    yield
    jax.clear_caches()


def _int8(cfg):
    return dataclasses.replace(cfg, cache_dtype="int8")


# --------------------------------------------------------------------------- #
# the quantization and the cache's layout
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 7, 2, 32), (3, 1, 1, 256), (1, 33, 4, 64)])
def test_quantize_is_the_references_bitwise(shape, dtype):
    """``quantize_rows_plain`` over hd is the reference's ``_quantize`` on
    the same K/V: codes and scales bitwise, with all-zero rows, rows whose
    maximum is negative and values at half-way points."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    x[0, 0, 0] = 0.0                                        # an all-zero row
    x[-1, -1, -1] = -np.abs(x[-1, -1, -1])                  # a negative maximum
    x[-1, 0, 0, :4] = np.float32([1.0, 0.5, -0.5, 1.5]) / 127.0 * 3.0
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    jq, js = jattn._quantize(jx)
    tq, ts = quantize_rows_plain(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind", KINDS)
def test_int8_cache_layout_matches_the_reference(kind):
    jcfg = _int8(jget_smoke("gemma3-1b"))
    tcfg = _int8(get_smoke("gemma3-1b"))
    jc = jattn.init_kv_cache(jcfg, JKind(kind), 3, 40)
    tc = tattn.init_kv_cache(tcfg, BlockKind(kind), 3, 40)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jc.items()} == \
        {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in tc.items()}


def test_cache_read_is_the_references():
    rng = np.random.default_rng(1)
    codes = rng.integers(-127, 128, size=(2, 9, 2, 32)).astype(np.int8)
    scale = (rng.random(size=(2, 9, 2)) * 0.1).astype(np.float32)
    jk, _ = jattn._cache_read({"k": jnp.asarray(codes), "v": jnp.asarray(codes),
                               "k_scale": jnp.asarray(scale), "v_scale": jnp.asarray(scale)})
    got = tfa.cache_read(_t(codes), _t(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jk.astype(jnp.float32)))


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #
def _layer_run(kind, steps=7):
    """A ragged prefill into an int8 cache (ring on the local and chunked
    kinds), then per-slot decode steps past the ring's end, through both
    packages: each decode step's outputs, and the caches after it."""
    from test_torch_lm import _mask_cfgs

    jcfg, tcfg = (_int8(c) for c in _mask_cfgs())
    jp, tp = _attn_pair(jcfg, seed=5)
    B, S, max_seq = 3, 16, 24
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, 128)).astype(np.float32)
    lengths = np.asarray([16, 9, 3], np.int32)
    jc = jattn.init_kv_cache(jcfg, JKind(kind), B, max_seq)
    tc = tattn.init_kv_cache(tcfg, BlockKind(kind), B, max_seq)
    want, jc = jattn.attn_apply(jp, jnp.asarray(x), cfg=jcfg, kind=JKind(kind),
                                mode="prefill", positions=jnp.arange(S), cache=jc,
                                lengths=jnp.asarray(lengths))
    got, tc = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=BlockKind(kind),
                               mode="prefill", positions=torch.arange(S), cache=tc,
                               lengths=_t(lengths))
    for b, n in enumerate(lengths):
        _close(got[b, :n], np.asarray(want)[b, :n], LAYER_TOL)
    np.testing.assert_array_equal(tc["k"].numpy(), np.asarray(jc["k"]))
    pos = lengths.copy()
    out = []
    for _ in range(steps):
        xd = rng.normal(size=(B, 1, 128)).astype(np.float32)
        want, jc = jattn.attn_apply(jp, jnp.asarray(xd), cfg=jcfg, kind=JKind(kind),
                                    mode="decode", pos=jnp.asarray(pos), cache=jc)
        got, tc = tattn.attn_apply(tp, _t(xd), cfg=tcfg, kind=BlockKind(kind),
                                   mode="decode", pos=_t(pos), cache=tc)
        out.append((got, want, {k: t.clone() for k, t in tc.items()}, dict(jc)))
        pos += 1
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_int8_cache_decode_matches_the_kernels_function(kind, kv_replay, kernel_sdpa):
    """Against the reference with fp32 probabilities: every decode output
    at the layer tolerance, codes equal and scales close after every step.
    Each write quantizes K and V (one ``quantize_rows`` call each)."""
    for got, want, tc, jc in _layer_run(kind):
        _close(got, want, LAYER_TOL)
        for name in ("k", "v"):
            np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))
            _close(tc[f"{name}_scale"], jc[f"{name}_scale"], LAYER_TOL)
    assert kv_replay.flips <= 2


@pytest.mark.parametrize("kind", KINDS)
def test_int8_cache_decode_matches_reference(kind, kv_replay):
    """Against the reference as it is, which rounds the probabilities to
    bf16: every decode output within 2⁻⁸ · max |v| (the layer's output
    projection scales it; its largest weight row sum bounds that)."""
    for got, want, tc, jc in _layer_run(kind, steps=4):
        v = tfa.cache_read(tc["v"], tc["v_scale"]).float()
        bound = 2.0 ** -8 * float(v.abs().max()) * 3.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=bound)


def test_writes_quantize_k_and_v_once_each(monkeypatch):
    """2 ``quantize_rows`` calls a layer at a prefill and at a decode step
    (the launches on the card), none with a cache of the model's dtype."""
    cfg = _int8(get_smoke("qwen2-1.5b"))
    calls = []
    real = tops.quantize_rows
    monkeypatch.setattr(tops, "quantize_rows", lambda x: calls.append(x.shape) or real(x))
    from repro_torch.models.transformer import init_model

    params = init_model(torch.Generator().manual_seed(0), cfg)
    model = TLM(cfg, device="cpu")
    cache = model.init_cache(2, 16)
    toks = torch.randint(0, cfg.vocab_size, (2, 6))
    model.prefill_ragged(params, toks, torch.tensor([6, 4]), cache)
    assert len(calls) == 2 * cfg.num_layers
    model.decode_step(params, toks[:, :1], torch.tensor([6, 4]), cache)
    assert len(calls) == 4 * cfg.num_layers
    plain = TLM(get_smoke("qwen2-1.5b"), device="cpu")
    plain.prefill_ragged(params, toks, torch.tensor([6, 4]), plain.init_cache(2, 16))
    assert len(calls) == 4 * cfg.num_layers


# --------------------------------------------------------------------------- #
# the stack and the engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    arch = request.param
    jcfg = _int8(jget_smoke(arch))
    params, _ = jinit(jax.random.PRNGKey(4), jget_smoke(arch))
    tcfg = _int8(get_smoke(arch))
    return jcfg, params, tcfg, lm_from_reference(_host(params), tcfg, device="cpu")


def test_cache_carried_from_the_reference_decodes_the_same(smoke, kv_replay, kernel_sdpa):
    """Both packages start from the reference's int8 cache after its
    prefill (``lm_cache_from_reference``): a decode step's logits and the
    cache it leaves agree."""
    jcfg, params, tcfg, tparams = smoke
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, 512, size=(2, 40)).astype(np.int32)
    lengths = np.asarray([40, 23], np.int32)
    _, jc = jm.prefill_ragged(params, jnp.asarray(toks), jnp.asarray(lengths),
                              jm.init_cache(2, 48))
    jax.effects_barrier()
    kv_replay.ref.clear()            # the port starts from the reference's cache
    kv_replay.scales.clear()
    tc = lm_cache_from_reference(_host(jc), tcfg, device="cpu")
    assert tc["b0"]["attn"]["k"].dtype == torch.int8
    nxt = np.asarray([[5], [7]], np.int32)
    want, jc = jm.decode_step(params, jnp.asarray(nxt), jnp.asarray(lengths), jc)
    got, tc = tm.decode_step(tparams, _t(nxt), _t(lengths), tc)
    _close(got, want, LOGIT_TOL)
    for name, block in tc.items():
        np.testing.assert_array_equal(block["attn"]["k"].numpy(),
                                      np.asarray(jc[name]["attn"]["k"]))
    with pytest.raises(ValueError, match="cache_dtype"):
        lm_cache_from_reference(_host(jc), dataclasses.replace(tcfg, cache_dtype="bf16"),
                                device="cpu")


def _requests(cls, vocab):
    rng = np.random.default_rng(9)
    return [cls(prompt=rng.integers(0, vocab, size=n).astype(np.int32), max_new_tokens=m)
            for n, m in zip((5, 40, 13, 33, 8, 21), (6, 4, 12, 5, 9, 3))]


def test_engine_streams_equal_the_jax_engine(smoke, kv_replay, kernel_sdpa):
    """Qwen2 and Gemma3 SMOKE (a 32-slot ring on Gemma3's local layer,
    wrapped by prompts and decodes past it) with ``cache_dtype="int8"``:
    the port's engine gives the greedy streams of the JAX engine with the
    kernel's fp32 probabilities."""
    jcfg, params, tcfg, tparams = smoke
    want = JEngine(jcfg, params, batch_size=3, max_seq=64).run(
        _requests(JRequest, jcfg.vocab_size))
    jax.effects_barrier()
    got = ServeEngine(tcfg, tparams, batch_size=3, max_seq=64, device="cpu").run(
        _requests(Request, tcfg.vocab_size))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


def test_continuous_batching_equals_slot_at_a_time(smoke):
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=64, device="cpu")
    served = eng.run(_requests(Request, tcfg.vocab_size))
    solo = [eng._run_one(r) for r in _requests(Request, tcfg.vocab_size)]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]
    cache = eng.decode_cache(1)["b0"]["attn"]
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float32
