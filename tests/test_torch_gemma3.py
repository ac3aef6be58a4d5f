"""Gemma3-1B on the port against the JAX reference, on the CPU.

Gemma3's ``SMOKE`` configuration (2 layers, a sliding-window layer with a
32-slot ring cache and a global one; d_model 128, 4 q heads over 1 kv head
of 32, fp32) with the reference's weights carried across by
``lm_from_reference``: the registry, the param tree and the caches,
``forward``, ``prefill_ragged`` and per-slot ``decode_step`` past the point
where the ring wraps, and the greedy streams of the port's ``ServeEngine``
against the JAX engine's at ``quantize`` none and int8, and against its own
slot-at-a-time oracle.  Attention runs through kernel 6's plain versions
here (``kernels/flash_attention.py``).

Tolerances as in ``tests/test_torch_lm.py``: fp32 on both sides, summed in
different orders, so logits after the stack are held at rtol = atol = 1e-4;
the int8 products are exact on both sides at these widths.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models.layers.quant import QTensor as JQTensor
from repro.models.transformer import TransformerLM as JLM
from repro.models.transformer import init_model as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS, PENDING_IDS, get_config, get_smoke
from repro_torch.models.config import BlockKind
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import lm_from_reference

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "gemma3-1b"


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.n_contract)
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=LOGIT_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_smoke(ARCH)
    params, _ = jinit(jax.random.PRNGKey(3), jcfg)
    tcfg = get_smoke(ARCH)
    return jcfg, params, tcfg, lm_from_reference(_host(params), tcfg, device="cpu")


def test_config_and_registry_match_the_reference():
    assert ARCH in ARCH_IDS and ARCH not in PENDING_IDS
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke(ARCH)) == dataclasses.asdict(jget_smoke(ARCH))
    cfg = get_config(ARCH)
    kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.num_layers)]
    assert [i for i, k in enumerate(kinds) if k == BlockKind.ATTN] == [5, 11, 18, 24]
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.window) == \
        (4, 1, 256, 512)


def test_init_tree_and_caches_match_the_reference_layout(smoke):
    """Same keys, shapes and dtypes as the JAX tree; at full width the
    cache is a 512-slot ring on the 22 local layers and 2,048 slots on the
    4 global ones, as the reference's."""
    jcfg, params, tcfg, _ = smoke
    mine = tinit(torch.Generator().manual_seed(0), tcfg)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]

    assert spec(mine) == spec(params)
    full = get_config(ARCH)
    cache = TLM(full, device="cpu").init_cache(1, 2048)
    jcache = JLM(jget_config(ARCH)).init_cache(1, 2048)
    assert spec(cache) == spec(jcache)
    slots = [cache[f"b{i}"]["attn"]["k"].shape[2] for i in range(len(full.pattern))]
    per_layer = [slots[i % len(full.pattern)] for i in range(full.num_layers)]
    assert sorted(per_layer) == [512] * 22 + [2048] * 4


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_lm_from_reference_carries_the_tree(smoke, quantize):
    from repro.models.layers.quant import quantize_model_params as jq
    from repro_torch.models.layers.quant import QTensor

    jcfg, params, tcfg, _ = smoke
    tree = lm_from_reference(_host(jq(params, quantize)), tcfg, device="cpu")
    wq = tree["blocks"]["b0"]["attn"]["wq"]
    assert isinstance(wq, QTensor) == (quantize == "int8")
    assert tuple(wq.shape) == (1, 128, 4, 32)
    with pytest.raises(ValueError, match="does not match"):
        lm_from_reference(_host(params), get_config(ARCH), device="cpu")


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_forward_and_ragged_prefill_match(smoke, quantize):
    """Ragged prompts of 40, 29 and 7 tokens: the 40-token row overflows the
    32-slot ring of the local layer at prefill."""
    from repro.models.layers.quant import quantize_model_params as jq
    from repro_torch.models.layers.quant import quantize_model_params as tq

    jcfg, params, tcfg, tparams = smoke
    jp, tp = jq(params, quantize), tq(tparams, quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    toks = np.random.default_rng(9).integers(0, 512, size=(3, 40)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, _t(toks))
    _close(got, want)
    lengths = np.asarray([40, 29, 7], np.int32)
    jc, tc = jm.init_cache(3, 96), tm.init_cache(3, 96)
    want, jc = jm.prefill_ragged(jp, jnp.asarray(toks), jnp.asarray(lengths), jc)
    got, tc = tm.prefill_ragged(tp, _t(toks), _t(lengths), tc)
    _close(got, want)
    for b in ("b0", "b1"):
        _close(tc[b]["attn"]["k"], jc[b]["attn"]["k"])
        _close(tc[b]["attn"]["v"], jc[b]["attn"]["v"])


def test_per_slot_decode_past_the_ring_matches(smoke):
    """After the ragged prefill, 30 per-slot decode steps, which wrap the
    32-slot ring of every row, at quantize none.  (At int8 an activation
    that falls on a rounding boundary of the per-row quantization flips an
    int8 value between the two packages within these steps — the port's
    attention before kernel 6, summed in fp64, flipped one at step 3, the
    plain version of kernel 6 at step 10 — and the flipped K/V stays in the
    cache; int8 decode parity is held on greedy streams below.)"""
    jcfg, params, tcfg, tparams = smoke
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    toks = rng.integers(0, 512, size=(3, 40)).astype(np.int32)
    lengths = np.asarray([40, 29, 7], np.int32)
    jc, tc = jm.init_cache(3, 96), tm.init_cache(3, 96)
    _, jc = jm.prefill_ragged(params, jnp.asarray(toks), jnp.asarray(lengths), jc)
    _, tc = tm.prefill_ragged(tparams, _t(toks), _t(lengths), tc)
    pos = lengths.copy()
    for _ in range(30):
        tok = rng.integers(0, 512, size=(3, 1)).astype(np.int32)
        want, jc = jm.decode_step(params, jnp.asarray(tok), jnp.asarray(pos), jc)
        got, tc = tm.decode_step(tparams, _t(tok), _t(pos), tc)
        _close(got, want)
        pos += 1
    for b in ("b0", "b1"):
        _close(tc[b]["attn"]["k"], jc[b]["attn"]["k"])
        _close(tc[b]["attn"]["v"], jc[b]["attn"]["v"])


def _requests(cls, lens, news, seed=42):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 512, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in zip(lens, news)]


# prompts under, at and over the 32-slot ring, decodes that wrap it
LENS, NEWS = (5, 33, 12, 40, 31, 3), (30, 8, 25, 6, 20, 9)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_engine_streams_equal_the_jax_engine(smoke, quantize):
    jcfg, params, tcfg, tparams = smoke
    jcfg = dataclasses.replace(jcfg, quantize=quantize)
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    jeng = JEngine(jcfg, params, batch_size=3, max_seq=96)
    teng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, device="cpu")
    want = jeng.run(_requests(JRequest, LENS, NEWS))
    got = teng.run(_requests(Request, LENS, NEWS))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert teng.calls["prefill_waves"] > 1 and teng.calls["prefills"] == 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_continuous_batching_equals_slot_at_a_time(smoke, quantize):
    _, _, tcfg, tparams = smoke
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    eng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, device="cpu")
    served = eng.run(_requests(Request, LENS, NEWS))
    solo = [eng._run_one(r) for r in _requests(Request, LENS, NEWS)]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


def test_layers_call_kernel_6_once_a_layer(smoke, monkeypatch):
    """Every attention layer's prefill is one ops.flash_attention call with
    its mask (the window on the local layer), every decode step one
    ops.flash_attention_decode call a layer."""
    from repro_torch.kernels import ops

    _, _, tcfg, tparams = smoke
    seen = []
    for name in ("flash_attention", "flash_attention_decode"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _f=fn, _n=name, **kw: (
            seen.append((_n, kw["window"], kw["chunk"])), _f(*a, **kw))[1])
    tm = TLM(tcfg, device="cpu")
    cache = tm.init_cache(2, 64)
    _, cache = tm.prefill_ragged(tparams, _t(np.ones((2, 8), np.int32)),
                                 _t(np.asarray([8, 5], np.int32)), cache)
    tm.decode_step(tparams, _t(np.ones((2, 1), np.int32)), _t(np.asarray([8, 5])), cache)
    assert seen == [("flash_attention", 32, None), ("flash_attention", None, None),
                    ("flash_attention_decode", 32, None),
                    ("flash_attention_decode", None, None)]


def test_launcher_serves_gemma3_on_cpu():
    from repro_torch.launch.serve import main

    rep = main(["--engine", "lm", "--arch", ARCH, "--smoke", "--quantize", "int8",
                "--device", "cpu", "--requests", "4", "--slots", "2", "--max-new", "3"])
    assert rep["finished"] == 4 and rep["new_tokens"] == 12
