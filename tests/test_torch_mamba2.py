"""The port's Mamba-2 serving path against the JAX reference, on the CPU.

Mamba2-2.7B's ``SMOKE`` configuration (2 SSD layers, d_model 128, 16 heads
of P = 16, N = 16, chunk 32, fp32) with the reference's weights carried
across by ``lm_from_reference``: ``ssd_apply`` (prefill at an S that the
chunk divides and at one it does not, then decode steps from the
prefilled cache), the whole stack, and the port's ``ServeEngine`` (its
per-request prefill) against the JAX engine's greedy streams.

Tolerances: everything is fp32.  The layer's output, state and conv taps
are held at rtol = atol = 1e-4, the scan's own tolerance in
``tests/test_kernels.py`` (its sums run over up to 64 steps and 16 state
entries in another order than XLA's).  Logits after the whole stack are
held at 1e-3: with random weights a head's decay reaches cum ≈ −1000 over
a 48-step chunk, where one fp32 ulp is 6e-5, so exp(cum_t − cum_s) carries
a relative error of that size whose rounding depends on the order of the
running sum (XLA lowers cumsum to a reduce-window and picks its order, the
port sums in index order); after two layers the logits (up to ~8) differ
by up to ~4e-4.
Token streams are compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models.layers import ssd as jssd
from repro.models.transformer import TransformerLM as JLM
from repro.models.transformer import init_model as jinit
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import ARCH_IDS, PENDING_IDS, get_config, get_smoke
from repro_torch.kernels import ops as tops
from repro_torch.models.layers import ssd as tssd
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import Request, ServeEngine, SlotScheduler
from repro_torch.weights import lm_from_reference

TOL = dict(rtol=1e-4, atol=1e-4)
LOGIT_TOL = dict(rtol=1e-3, atol=1e-3)
ARCH = "mamba2-2.7b"


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return np.asarray(tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_smoke(ARCH)
    params, _ = jinit(jax.random.PRNGKey(1), jcfg)
    tcfg = get_smoke(ARCH)
    return jcfg, params, tcfg, lm_from_reference(_host(params), tcfg, device="cpu")


def test_config_registered_and_equal_to_the_reference():
    assert ARCH in ARCH_IDS and ARCH not in PENDING_IDS
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(get_smoke(ARCH)) == dataclasses.asdict(jget_smoke(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.d_model, cfg.d_inner_ssd, cfg.ssd_heads,
            cfg.ssd_head_dim, cfg.ssm_state, cfg.ssd_chunk, cfg.vocab_size) == (
        64, 2560, 5120, 80, 64, 128, 256, 50_280)


def test_init_model_tree_matches_the_reference_layout(smoke):
    jcfg, params, tcfg, _ = smoke
    mine = tinit(torch.Generator().manual_seed(0), tcfg)

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), str(tree.dtype).split(".")[-1]

    assert spec(mine) == spec(params)
    a = -torch.exp(mine["blocks"]["b0"]["ssd"]["A_log"])
    assert bool(((a <= -1.0) & (a > -16.0)).all())


def test_lm_from_reference_carries_every_ssd_leaf(smoke):
    jcfg, params, tcfg, tparams = smoke
    jb, tb = params["blocks"]["b0"]["ssd"], tparams["blocks"]["b0"]["ssd"]
    assert set(tb) == {"wz", "wx", "wB", "wC", "wdt", "dt_bias", "A_log", "D",
                       "conv_x", "conv_b", "norm_scale", "w_out"}
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    wrong = dataclasses.replace(tcfg, ssm_state=8)
    with pytest.raises(ValueError, match="ssd"):
        lm_from_reference(_host(params), wrong, device="cpu")


def _layer_params(params):
    return jax.tree.map(lambda a: a[0], params["blocks"]["b0"]["ssd"])


@pytest.mark.parametrize("S", [64, 40])
def test_ssd_apply_prefill_then_decode_matches(smoke, S, monkeypatch):
    """S = 64 runs two chunks of 32; S = 40 is not a multiple of 32, so both
    packages take one chunk of 40.  Then four decode steps from the
    prefilled state and conv taps."""
    jcfg, params, tcfg, _ = smoke
    jp = _layer_params(params)
    tp = lm_from_reference(_host(jp), device="cpu")
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 128)).astype(np.float32)
    chunks = []
    scan = tops.ssd_chunk_scan
    monkeypatch.setattr(tops, "ssd_chunk_scan",
                        lambda *a, chunk, **k: chunks.append(chunk) or scan(*a, chunk=chunk, **k))
    jc = jssd.init_ssd_cache(jcfg, 2, jnp.float32)
    tc = tssd.init_ssd_cache(tcfg, 2, torch.float32)
    want, jc = jssd.ssd_apply(jp, jnp.asarray(x), cfg=jcfg, mode="prefill", cache=jc)
    got, tc = tssd.ssd_apply(tp, _t(x), cfg=tcfg, mode="prefill", cache=tc)
    assert chunks == [32 if S % 32 == 0 else S]
    _close(got, want)
    _close(tc["h"], jc["h"])
    _close(tc["conv"], jc["conv"])
    for _ in range(4):
        xd = rng.normal(size=(2, 1, 128)).astype(np.float32)
        want, jc = jssd.ssd_apply(jp, jnp.asarray(xd), cfg=jcfg, mode="decode", cache=jc)
        got, tc = tssd.ssd_apply(tp, _t(xd), cfg=tcfg, mode="decode", cache=tc)
        _close(got, want)
        _close(tc["h"], jc["h"])
    # without a cache: the reference's zero state, and no cache returned
    want, none = jssd.ssd_apply(jp, jnp.asarray(x), cfg=jcfg, mode="prefill")
    got, tnone = tssd.ssd_apply(tp, _t(x), cfg=tcfg, mode="prefill")
    _close(got, want)
    assert none is None and tnone is None


def test_forward_prefill_decode_match(smoke):
    jcfg, params, tcfg, tparams = smoke
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, 512, size=(2, 48)).astype(np.int32)
    want, _ = jm.forward(params, jnp.asarray(toks))
    got, _ = tm.forward(tparams, _t(toks))
    _close(got, want, LOGIT_TOL)
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
    want, jc = jm.prefill(params, jnp.asarray(toks), jc)
    got, tc = tm.prefill(tparams, _t(toks), tc)
    _close(got, want, LOGIT_TOL)
    _close(tc["b0"]["ssd"]["h"], jc["b0"]["ssd"]["h"], LOGIT_TOL)
    pos = 48
    for step in range(3):
        tok = np.asarray([[step + 3], [step + 100]], np.int32)
        want, jc = jm.decode_step(params, jnp.asarray(tok), jnp.asarray(pos), jc)
        got, tc = tm.decode_step(tparams, _t(tok), torch.tensor(pos), tc)
        _close(got, want, LOGIT_TOL)
        pos += 1


def test_prefill_ragged_refuses_recurrent_stacks(smoke):
    _, _, tcfg, tparams = smoke
    model = TLM(tcfg, device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        model.prefill_ragged(tparams, torch.zeros(2, 8, dtype=torch.int32),
                             torch.tensor([4, 8]), model.init_cache(2, 32))


def _requests(cls, lens, news, seed=9):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 512, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in zip(lens, news)]


LENS, NEWS = (6, 11, 8, 40, 33), (4, 3, 5, 6, 2)


def test_engine_streams_equal_the_jax_engine(smoke):
    """Per-request prefill through two slots (admission waves, staggered
    retirement, backfill): the port's greedy streams equal the JAX
    engine's and the slot-at-a-time oracle's, token for token
    (tests/test_serve_continuous.py's recurrent-arch parity, across the
    two packages)."""
    jcfg, params, tcfg, tparams = smoke
    jeng = JEngine(jcfg, params, batch_size=2, max_seq=64)
    teng = ServeEngine(tcfg, tparams, batch_size=2, max_seq=64, device="cpu")
    assert not jeng.ragged_ok and not teng.ragged_ok
    want = jeng.run(_requests(JRequest, LENS, NEWS))
    sched = SlotScheduler(2)
    got = teng.run(_requests(Request, LENS, NEWS), scheduler=sched)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(r.done for r in got) and sched.backfills > 0
    assert teng.calls["prefill_waves"] == 0
    assert teng.calls["prefills"] == len(LENS)
    solo = [teng._run_one(r) for r in _requests(Request, LENS, NEWS)]
    assert [r.out_tokens for r in got] == [r.out_tokens for r in solo]


def test_per_request_prefill_scatters_each_state_into_its_slot(smoke):
    """Two admits into slots 1 and 3 of four: each slot holds the state of
    its own batch-1 prefill, and the other slots stay zero."""
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, batch_size=4, max_seq=64, device="cpu")
    reqs = _requests(Request, (5, 37), (1, 1))
    cache, first = eng._prefill_into(eng.init_shared_cache(), [(1, reqs[0]), (3, reqs[1])])
    h = cache["b0"]["ssd"]["h"]
    assert first.shape == (2,) and h[:, [0, 2]].abs().sum().item() == 0.0
    for slot, r in ((1, reqs[0]), (3, reqs[1])):
        sub = eng.model.init_cache(1, 64)
        logits, sub = eng.model.prefill(eng.params, _t(r.prompt[None]), sub)
        assert torch.equal(h[:, slot], sub["b0"]["ssd"]["h"][:, 0])
        assert int(torch.argmax(logits[0, -1])) == first[[1, 3].index(slot)]


def test_launcher_serves_mamba_on_cpu():
    from repro_torch.launch.serve import main

    rep = main(["--engine", "lm", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-new", "3",
                "--prompt-lens", "5,40"])
    assert rep["finished"] == 3 and rep["new_tokens"] == 9 and rep["arch"] == ARCH


def _first_layers(tree, depth):
    if isinstance(tree, dict):
        return {k: _first_layers(v, depth) for k, v in tree.items()}
    return tree[:depth]


def test_random_deep_stack_is_chaotic(monkeypatch):
    """On random weights the 64-layer stack amplifies one ulp: the same
    model with the norm's mean of squares summed in PyTorch's fp32 order
    instead of rounded from fp64 gives last-token prefill logits that
    differ by ~7e-7 of max |logit| at 2 layers, ~4e-4 at 8 and O(1) at 64
    (width 256, fp32).  chip_smoke.py therefore holds the kernels against
    their plain versions tightly at a 2-layer cut only.  The batched decode
    it holds against the slot-at-a-time oracle at full depth, stream for
    stream: every decode reduction (``fixed_linear``, ``ssd_decode``, the
    norms) sums in one order fixed by the widths, never by the batch, so no
    ulp differs between the two for the stack to amplify."""
    cfg = get_config(ARCH).scaled(d_model=256, vocab_size=4096, num_layers=64,
                                  dtype="float32")
    params = tinit(torch.Generator().manual_seed(0), cfg)
    toks = _t(np.random.default_rng(0).integers(0, 4096, size=(1, 300)))

    def fp32_order(x, w, eps=1e-6, plus_one=False):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        w = 1.0 + w.float() if plus_one else w.float()
        return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)

    errs = {}
    for depth in (2, 8, 64):
        model = TLM(dataclasses.replace(cfg, num_layers=depth), device="cpu")
        tree = {**params, "blocks": _first_layers(params["blocks"], depth)}
        a, _ = model.prefill(tree, toks, model.init_cache(1, 300))
        with monkeypatch.context() as m:
            m.setattr(tops, "rmsnorm", fp32_order)
            b, _ = model.prefill(tree, toks, model.init_cache(1, 300))
        errs[depth] = ((a - b).abs().max() / a.abs().max()).item()
    print("relative logit change by depth:", errs)
    assert errs[2] < 1e-5 and 1e-5 < errs[8] < 1e-2 and errs[64] > 0.1, errs
