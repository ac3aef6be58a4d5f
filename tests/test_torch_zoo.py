"""Granite-3-8B, Qwen1.5-32B and RecurrentGemma-9B on the port against the
JAX reference, on the CPU.

Each configuration's ``SMOKE`` (2 or 3 layers, d_model 128, fp32): Granite
GQA 4/2, Qwen1.5 MHA 4/4 with QKV bias, RecurrentGemma two RG-LRU blocks
and a local-attention block (window 32) with one kv head, each block with
its MLP.  The reference's weights are carried across by
``lm_from_reference``; token inputs are drawn with numpy from a seed.
Held: the registry and configs field by field, the param tree and caches,
``forward``, the ragged prefill (the dense two) and the per-request
prefill (all three), 30 decode steps, the greedy streams of ``ServeEngine``
against the JAX engine's, continuous batching against the slot-at-a-time
oracle, a reused slot's RG-LRU state, decode rows bitwise alone and in a
batch, the tree quantized a period at a time as it is drawn bitwise the
tree drawn then quantized, and the launcher.

Tolerances.  Logits, K/V caches and activations are held at rtol = atol =
1e-4 at both ``quantize`` settings, as in ``tests/test_torch_lm.py``: fp32
on both sides, summed in other orders (and the RG-LRU scan sequential here,
associative there).  Greedy streams are held exactly.  At int8 each
activation row is rounded to int8 after fp32 arithmetic that differs
between the packages in the last ulp, and a value that lies that close to
the half-way point between two codes rounds apart in the two; one such
code moves these random 2-layer models' logits by up to 1.7 % of max
|logit| (``forward`` at three seeds).  So the int8 tests run under ``_CodeReplay``: each port
quantization is held against the reference's (inputs at 1e-4, at most
``FLIPS_MAX`` = 2 codes apart, each by one code and within ``BOUNDARY`` =
2e-4 of the half-way point; these tests read one code at a time, at most
6.5e-5 from it) and takes the reference's code where the two differ, so
that everything after it is held at 1e-4 as well.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.kernels import ops as jops
from repro.models.layers.quant import QTensor as JQTensor
from repro.models.layers.quant import quantize_model_params as jq
from repro.models.transformer import TransformerLM as JLM
from repro.models.transformer import init_model as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS, PENDING_IDS, get_config, get_smoke
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models.config import BlockKind
from repro_torch.models.layers.quant import QTensor, quantize_model_params as tq
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import lm_from_reference

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
FLIPS_MAX = 2
BOUNDARY = 2e-4
ARCHS = ("granite-3-8b", "qwen1.5-32b", "recurrentgemma-9b")
DENSE = ("granite-3-8b", "qwen1.5-32b")


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


class _CodeReplay:
    """The reference's int8 activation codes, held against the port's and
    handed to it where the two round a value apart.

    Each reference ``quantize_rows`` call records its fp32 input and codes
    (the calls of one input, one per weight of a group, count once); each
    port ``quantize_rows_plain`` call takes the next record in order.  Its
    input must equal the reference's within ``LOGIT_TOL``; its codes may
    differ from the reference's in at most ``FLIPS_MAX`` places, each by
    one code, at a value within ``BOUNDARY`` of the half-way point between
    the two codes (a tie the last ulp decides).  There the port takes the
    reference's code, so everything downstream is held at ``LOGIT_TOL``."""

    def __init__(self):
        self.ref = collections.deque()
        self.flips = 0

    def record(self, x, xq):
        x, xq = np.asarray(x), np.asarray(xq)
        if not (self.ref and self.ref[-1][0].shape == x.shape
                and np.array_equal(self.ref[-1][0], x)):
            self.ref.append((x, xq))

    def take(self, x, xq):
        jax.effects_barrier()
        assert self.ref, "the port quantized rows the reference did not"
        rx, rq = self.ref.popleft()
        xn, qn = x.float().numpy(), xq.numpy()
        assert rx.size == xn.size and rx.shape[-1] == xn.shape[-1], (rx.shape, xn.shape)
        rx, rq = rx.reshape(xn.shape), rq.reshape(xn.shape)
        np.testing.assert_allclose(xn, rx, **LOGIT_TOL)
        d = qn.astype(np.int32) - rq.astype(np.int32)
        flip = d != 0
        assert np.abs(d).max() <= 1 and flip.sum() <= FLIPS_MAX, (np.abs(d).max(), flip.sum())
        if flip.any():
            v = rx / (np.abs(rx).max(axis=-1, keepdims=True) / np.float32(127.0)
                      + np.float32(1e-8))
            half = (np.minimum(qn, rq) + 0.5)[flip]
            assert np.abs(v[flip] - half).max() <= BOUNDARY, v[flip] - half
            self.flips += int(flip.sum())
            xq[torch.from_numpy(flip)] = torch.from_numpy(rq[flip])


@pytest.fixture
def replay(monkeypatch):
    rep = _CodeReplay()
    ref_rows, port_rows = jops.quantize_rows, tqm.quantize_rows_plain

    def ref(x):
        xq, xs = ref_rows(x)
        jax.debug.callback(rep.record, x.astype(jnp.float32), xq, ordered=True)
        return xq, xs

    def port(x):
        xq, xs = port_rows(x)
        rep.take(x, xq)
        return xq, xs

    jax.clear_caches()             # no reference trace without the callback
    monkeypatch.setattr(jops, "quantize_rows", ref)
    monkeypatch.setattr(tqm, "quantize_rows_plain", port)
    yield rep
    jax.effects_barrier()
    jax.clear_caches()
    print(f"{rep.flips} port codes rounded apart from the reference's, replaced")
    assert not rep.ref, f"{len(rep.ref)} reference quantize calls the port did not make"


_SMOKES = {}


def _smoke(arch):
    if arch not in _SMOKES:
        jcfg = jget_smoke(arch)
        params, _ = jinit(jax.random.PRNGKey(5), jcfg)
        tcfg = get_smoke(arch)
        _SMOKES[arch] = (jcfg, params, tcfg,
                         lm_from_reference(_host(params), tcfg, device="cpu"))
    return _SMOKES[arch]


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_registry_match_the_reference(arch):
    assert arch in ARCH_IDS and arch not in PENDING_IDS
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    if arch == "recurrentgemma-9b":
        cfg = get_config(arch)
        kinds = [cfg.pattern[i % len(cfg.pattern)] for i in range(cfg.num_layers)]
        assert kinds.count(BlockKind.ATTN_LOCAL) == 12 and kinds.count(BlockKind.RGLRU) == 26
        assert len(cfg.pattern) == 19 and cfg.probe_pattern == (
            BlockKind.RGLRU, BlockKind.RGLRU, BlockKind.ATTN_LOCAL)
        assert (cfg.num_heads // cfg.num_kv_heads, cfg.resolved_head_dim, cfg.window,
                cfg.rnn_width) == (16, 256, 2048, 4096)
        # the smoke config keeps the period's kinds after scaled()
        assert get_smoke(arch).pattern == cfg.probe_pattern


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_caches_match_the_reference_layout(arch):
    jcfg, params, tcfg, _ = _smoke(arch)
    assert _spec(tinit(torch.Generator().manual_seed(0), tcfg)) == _spec(params)
    assert _spec(TLM(tcfg, device="cpu").init_cache(2, 64)) == \
        _spec(JLM(jcfg).init_cache(2, 64))


@pytest.mark.parametrize("quantize", ["int8", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tree_quantized_as_drawn_is_bitwise_draw_then_quantize(arch, quantize):
    """``init_model`` quantizes each period as ``cfg.quantize`` says before
    the next one is drawn, and gives the same tree as drawing it whole with
    plain weights and quantizing it after, bit for bit (same generator
    order)."""
    cfg = get_smoke(arch)
    assert cfg.quantize == "none"
    drawn = tq(tinit(torch.Generator().manual_seed(4), cfg), quantize)
    asdrawn = tinit(torch.Generator().manual_seed(4),
                    dataclasses.replace(cfg, quantize=quantize))

    def flat(tree, path=()):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from flat(v, path + (k,))
        elif isinstance(tree, QTensor):
            yield path + ("qt",), tree.qt
            yield path + ("scale",), tree.scale
            yield path + ("n_contract",), tree.n_contract
            yield path + ("shape",), tree.shape
        else:
            yield path, tree

    a, b = dict(flat(drawn)), dict(flat(asdrawn))
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    if quantize == "int8":
        assert isinstance(asdrawn["blocks"]["b0"]["mlp"]["w_gate"], QTensor)
        assert tq(asdrawn, "int8")["blocks"]["b0"]["mlp"]["w_gate"] is \
            asdrawn["blocks"]["b0"]["mlp"]["w_gate"]


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_per_request_prefill_match(arch, quantize, replay):
    jcfg, params, tcfg, tparams = _smoke(arch)
    jp, tp = jq(params, quantize), tq(tparams, quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    toks = np.random.default_rng(9).integers(0, 512, size=(2, 40)).astype(np.int32)
    want, _ = jm.forward(jp, jnp.asarray(toks))
    got, _ = tm.forward(tp, _t(toks))
    _close(got, want)
    for n in (40, 13):
        jc, tc = jm.init_cache(1, 96), tm.init_cache(1, 96)
        want, jc = jm.prefill(jp, jnp.asarray(toks[:1, :n]), jc)
        got, tc = tm.prefill(tp, _t(toks[:1, :n]), tc)
        _close(got, want)


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_matches_or_refuses(arch, quantize, replay):
    """The dense stacks take the ragged wave as the reference does; the
    hybrid refuses it in both packages (its RG-LRU state would absorb the
    pad tail)."""
    jcfg, params, tcfg, tparams = _smoke(arch)
    jp, tp = jq(params, quantize), tq(tparams, quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    toks = np.random.default_rng(9).integers(0, 512, size=(3, 40)).astype(np.int32)
    lengths = np.asarray([40, 29, 7], np.int32)
    jc, tc = jm.init_cache(3, 96), tm.init_cache(3, 96)
    if arch not in DENSE:
        with pytest.raises(ValueError, match="attention-only"):
            jm.prefill_ragged(jp, jnp.asarray(toks), jnp.asarray(lengths), jc)
        with pytest.raises(ValueError, match="attention-only"):
            tm.prefill_ragged(tp, _t(toks), _t(lengths), tc)
        return
    want, jc = jm.prefill_ragged(jp, jnp.asarray(toks), jnp.asarray(lengths), jc)
    got, tc = tm.prefill_ragged(tp, _t(toks), _t(lengths), tc)
    _close(got, want)
    for b in ("k", "v"):
        _close(tc["b0"]["attn"][b], jc["b0"]["attn"][b])


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_thirty_decode_steps_match(arch, quantize, replay):
    """Per-request prefills of 40, 29 and 7 tokens into one batch of 3
    slots, then 30 per-slot decode steps (the hybrid's 32-slot ring wraps),
    logits held at every step."""
    jcfg, params, tcfg, tparams = _smoke(arch)
    jp, tp = jq(params, quantize), tq(tparams, quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    lens = (40, 29, 7)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in lens]
    jcs, tcs = [], []
    for p in prompts:
        _, jc = jm.prefill(jp, jnp.asarray(p[None]), jm.init_cache(1, 96))
        _, tc = tm.prefill(tp, _t(p[None]), tm.init_cache(1, 96))
        jcs.append(jc)
        tcs.append(tc)
    jc = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *jcs)

    def cat(trees):
        if isinstance(trees[0], dict):
            return {k: cat([t[k] for t in trees]) for k in trees[0]}
        return torch.cat(trees, dim=1)

    tc = cat(tcs)
    pos = np.asarray(lens, np.int32)
    for _ in range(30):
        tok = rng.integers(0, 512, size=(3, 1)).astype(np.int32)
        want, jc = jm.decode_step(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        got, tc = tm.decode_step(tp, _t(tok), _t(pos), tc)
        _close(got, want)
        pos += 1


def _requests(cls, lens, news, seed=42):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 512, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in zip(lens, news)]


LENS, NEWS = (5, 33, 12, 40, 31, 3), (30, 8, 25, 6, 20, 9)


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_the_jax_engine(arch, quantize, replay):
    jcfg, params, tcfg, tparams = _smoke(arch)
    jcfg = dataclasses.replace(jcfg, quantize=quantize)
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    jeng = JEngine(jcfg, params, batch_size=3, max_seq=96)
    teng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, device="cpu")
    want = jeng.run(_requests(JRequest, LENS, NEWS))
    got = teng.run(_requests(Request, LENS, NEWS))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    if arch in DENSE:
        assert teng.calls["prefill_waves"] > 1 and teng.calls["prefills"] == 0
    else:
        assert teng.calls["prefill_waves"] == 0 and teng.calls["prefills"] == len(LENS)


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_equals_slot_at_a_time(arch, quantize):
    _, _, tcfg, tparams = _smoke(arch)
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    eng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, device="cpu")
    served = eng.run(_requests(Request, LENS, NEWS))
    solo = [eng._run_one(r) for r in _requests(Request, LENS, NEWS)]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


def test_a_reused_slot_starts_from_a_zero_recurrent_state():
    """The engine's batch-1 cache is reused from request to request: after a
    request leaves a nonzero RG-LRU state in it, the next request's stream
    is the one it has on a fresh engine, and its prefill found h and the
    conv taps at zero."""
    _, _, tcfg, tparams = _smoke("recurrentgemma-9b")
    first, second = _requests(Request, (17, 9), (12, 12), seed=3)
    eng = ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, device="cpu")
    eng._run_one(first)
    block = eng.decode_cache(1)["b0"]["rglru"]
    assert float(block["h"].abs().max()) > 0 and float(block["conv"].abs().max()) > 0
    seen = []
    prefill = eng.model.prefill

    def spy(params, tokens, cache):
        seen.append([float(cache[b]["rglru"][k].abs().max())
                     for b in ("b0", "b1") for k in ("h", "conv")])
        return prefill(params, tokens, cache)

    eng.model.prefill = spy
    reused = eng._run_one(second).out_tokens
    fresh = ServeEngine(tcfg, tparams, batch_size=2, max_seq=96,
                        device="cpu")._run_one(_requests(Request, (17, 9), (12, 12),
                                                         seed=3)[1]).out_tokens
    assert seen == [[0.0] * 4]
    assert reused == fresh


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_rows_equal_their_own_batch_1_steps(arch):
    """Bitwise: a decode step of 8 slots at their own positions gives each
    row the logits of that row's own batch-1 step (plain weights, through
    ``fixed_linear``; the RG-LRU state update per row)."""
    cfg = get_smoke(arch)
    params = tinit(torch.Generator().manual_seed(0), cfg)
    model = TLM(cfg, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 17, 5, 40, 9, 26, 1, 33)]
    caches, first = [], []
    for p in prompts:
        logits, cache = model.prefill(params, torch.as_tensor(p[None]),
                                      model.init_cache(1, 64))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_each_on_the_cpu(arch):
    from repro_torch.launch.serve import main

    rep = main(["--engine", "lm", "--arch", arch, "--smoke", "--quantize", "int8",
                "--device", "cpu", "--requests", "4", "--slots", "2", "--max-new", "3"])
    assert rep["finished"] == 4 and rep["new_tokens"] == 12 and rep["arch"] == arch
