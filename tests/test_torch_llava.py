"""LLaVA-NeXT-34B's vision-prefixed decoder on the port against the JAX
reference, on the CPU.

``SMOKE`` (2 layers, d_model 128, GQA 4/2, 16 vision tokens, fp32), the
weights drawn from a seed by the port's ``init_model`` into the
reference's layout (held against the reference's own) and carried across
by ``lm_from_reference``; patch embeddings and tokens drawn with numpy
from a seed.  Held: the registry and
configs, the param tree, ``forward`` and ``prefill(vision_embeds=)`` and 8
decode steps (logits, caches, greedy tokens) at both ``quantize``
settings, a vision-prefixed prefill's rows bitwise alone and in a batch,
the ragged prefill refused in both packages, and the serving engine's
text-only streams (per-request prefill) equal to the JAX engine's and to
the slot-at-a-time ``_run_one``'s, and the launcher.

Tolerances: logits and caches at rtol = atol = 1e-4 (fp32 on both sides,
summed in other orders), the int8 variants under the zoo's ``_CodeReplay``
(``tests/test_torch_zoo.py`` says why); streams exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models.layers.quant import quantize_model_params as jq
from repro.models.transformer import TransformerLM as JLM
from repro.models.transformer import init_model as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS, PENDING_IDS, get_config, get_smoke
from repro_torch.models.layers.quant import quantize_model_params as tq
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import lm_from_reference
from test_torch_zoo import _close, _host, _spec, _t, replay  # noqa: F401

ARCH = "llava-next-34b"
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


def _vision(cfg, B=2, seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)


def test_config_and_registry_match_the_reference():
    assert ARCH in ARCH_IDS and ARCH not in PENDING_IDS
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        assert dataclasses.asdict(get(ARCH)) == dataclasses.asdict(jget(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_ff,
            cfg.vocab_size, cfg.vision_tokens) == (60, 7168, 56, 8, 20480, 64000, 2880)


def test_init_tree_and_caches_match_the_reference_layout():
    jcfg, params, tcfg, _ = _smoke()
    ref = jax.eval_shape(lambda k: jinit(k, jcfg)[0], jax.random.PRNGKey(5))
    assert _spec(tinit(torch.Generator().manual_seed(0), tcfg)) == _spec(ref) == _spec(params)
    assert _spec(TLM(tcfg, device="cpu").init_cache(2, 48)) == \
        _spec(JLM(jcfg).init_cache(2, 48))


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_forward_with_the_vision_prefix_matches(quantize, replay):
    jcfg, params, tcfg, tparams = _smoke()
    jp, tp = _quantized(quantize)
    ve = _vision(jcfg)
    toks = np.random.default_rng(9).integers(0, 512, size=(2, 10)).astype(np.int32)
    want, _ = jax.jit(JLM(jcfg).forward)(jp, jnp.asarray(toks), vision_embeds=jnp.asarray(ve))
    got, _ = TLM(tcfg, device="cpu").forward(tp, _t(toks), vision_embeds=_t(ve))
    assert got.shape == (2, jcfg.vision_tokens + 10, jcfg.vocab_size)
    _close(got, want)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_prefill_and_eight_decode_steps_match(quantize, replay):
    """prefill(vision_embeds=) of 16 patches and a 7-token prompt at batch
    2, then 8 greedy decode steps: logits at every step, the caches, the
    greedy tokens."""
    jcfg, params, tcfg, tparams = _smoke()
    jp, tp = _quantized(quantize)
    jm, jprefill, jdecode = _reference(quantize)
    tm = TLM(tcfg, device="cpu")
    ve = _vision(jcfg)
    toks = np.random.default_rng(9).integers(0, 512, size=(2, 7)).astype(np.int32)
    want, jc = jprefill(jp, jnp.asarray(toks), jm.init_cache(2, 48),
                        vision_embeds=jnp.asarray(ve))
    got, tc = tm.prefill(tp, _t(toks), tm.init_cache(2, 48), vision_embeds=_t(ve))
    _close(got, want)
    _close(tc["b0"]["attn"]["k"], jc["b0"]["attn"]["k"])
    pos = jcfg.vision_tokens + toks.shape[1]
    for _ in range(8):
        tj = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)
        tt = got[:, -1].argmax(-1)
        assert tt.tolist() == tj.tolist()
        want, jc = jdecode(jp, jnp.asarray(tj[:, None]), jnp.asarray(pos, jnp.int32), jc)
        got, tc = tm.decode_step(tp, tt[:, None], pos, tc)
        _close(got, want)
        pos += 1
    _close(tc["b0"]["attn"]["v"], jc["b0"]["attn"]["v"])


def test_vision_prefill_rows_are_bitwise_alone():
    """Plain weights: a vision-prefixed prefill of 3 rows gives each row the
    logits and caches of its own batch-1 prefill (the kernels' fixed
    orders)."""
    cfg = get_smoke(ARCH)
    params = tinit(torch.Generator().manual_seed(0), cfg)
    model = TLM(cfg, device="cpu")
    ve = torch.from_numpy(_vision(cfg, B=3, seed=5))
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 512, size=(3, 5)))
    logits, cache = model.prefill(params, toks, model.init_cache(3, 32), vision_embeds=ve)
    for i in range(3):
        one, c1 = model.prefill(params, toks[i:i + 1], model.init_cache(1, 32),
                                vision_embeds=ve[i:i + 1])
        assert torch.equal(one[0], logits[i])
        assert torch.equal(c1["b0"]["attn"]["k"][:, 0], cache["b0"]["attn"]["k"][:, i])


def test_ragged_prefill_refuses_the_vision_config_in_both_packages():
    jcfg, params, tcfg, tparams = _smoke()
    toks = np.zeros((2, 4), np.int32)
    lengths = np.asarray([4, 2], np.int32)
    with pytest.raises(ValueError, match="text-only"):
        JLM(jcfg).prefill_ragged(params, jnp.asarray(toks), jnp.asarray(lengths),
                                 JLM(jcfg).init_cache(2, 8))
    m = TLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="text-only"):
        m.prefill_ragged(tparams, _t(toks), _t(lengths), m.init_cache(2, 8))


def _requests(cls, lens=(5, 19, 12, 3), news=(6, 3, 5, 4), seed=42):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 512, size=n).astype(np.int32), max_new_tokens=m)
            for n, m in zip(lens, news)]


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_engine_serves_the_text_only_path(quantize):
    """Per-request prefill (``ragged_ok`` is False for a vision config):
    every stream equal to the JAX engine's and to ``_run_one``'s."""
    jcfg, params, tcfg, tparams = _smoke()
    jcfg = dataclasses.replace(jcfg, quantize=quantize)
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    eng = ServeEngine(tcfg, tparams, batch_size=2, max_seq=48, device="cpu")
    assert not eng.ragged_ok
    served = eng.run(_requests(Request))
    assert eng.calls["prefill_waves"] == 0 and eng.calls["prefills"] == 4
    solo = [eng._run_one(r) for r in _requests(Request)]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]
    if quantize == "none":           # int8 codes may round apart (_CodeReplay)
        want = JEngine(jcfg, params, batch_size=2, max_seq=48).run(_requests(JRequest))
        assert [r.out_tokens for r in served] == [r.out_tokens for r in want]


def test_launcher_serves_llava_text_only(capsys):
    from repro_torch.launch.serve import main

    rep = main(["--engine", "lm", "--arch", ARCH, "--smoke", "--quantize", "int8",
                "--device", "cpu", "--requests", "3", "--slots", "2", "--max-new", "2"])
    assert rep["finished"] == 3 and rep["new_tokens"] == 6
    assert "frontend is stubbed; serving text-only path" in capsys.readouterr().out
