"""The two MoE models, Mixtral-8x22B and Llama-4-Scout-17B-16E, on the port
against the JAX reference, on the CPU.

The layer (``models/layers/moe.py``) is held against the reference's
``moe_apply`` under each ``moe_dispatch`` value, each against the
reference's path of the same name (the reference's two paths differ from
each other by rounding: 1 element of 16,384 at 1.67e-6 at llama4's smoke
widths, which is why its own gather test fails): choices dropped by a small
capacity factor, 4,096 tokens in two groups, a token count above 2,048 that
groups do not divide (one group), exact router ties, top-1 with a shared
expert, and the aux loss.  Both ``SMOKE`` models (fp32; Mixtral 2 layers,
window 32, top-2 of 4 experts; Llama4 4 layers, 3 chunked (chunk 64) + 1
NoPE, top-1 of 4 and a shared expert) are held past the window and the
chunk through ``forward``, the per-request prefill and 30 decode steps;
``int8`` (attention quantized, every expert and the shared expert in the
config's dtype, as in the reference); ``lm_from_reference`` of the ``moe``
tree; the registry.  The engine and the launcher are in
``tests/test_torch_moe_engine.py``.

Tolerances are ``tests/test_torch_zoo.py``'s: rtol = atol = 1e-4 for the
fp32 models (sums in other orders on the two sides), streams exactly, and
at int8 the reference's activation codes replayed where a last-ulp tie
rounds apart (``_CodeReplay``).  Router choices: each port routing is held
against the reference's gates (1e-4) and choices; where the two packages'
gates lie within ``TIE_GAP`` = 1e-5 of a tie, the port takes the
reference's choice and counts the replay, as ``_CodeReplay`` does for
codes.  At the seeds used no such replay happens (asserted).
"""
import collections
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models.layers import moe as jmoe
from repro.models.layers.quant import QTensor as JQTensor
from repro.models.layers.quant import quantize_model_params as jq
from repro.models.transformer import TransformerLM as JLM
from repro_torch.configs import ARCH_IDS, PENDING_IDS, get_config, get_smoke
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.layers.quant import QTensor
from repro_torch.models.layers.quant import quantize_model_params as tq
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.weights import lm_from_reference
from test_torch_zoo import _close, _host, _smoke, _spec, _t, replay  # noqa: F401

ARCHS = ("mixtral-8x22b", "llama4-scout-17b-16e")
DISPATCH = ("einsum", "gather")
TOL = dict(rtol=1e-4, atol=1e-4)
TIE_GAP = 1e-5


class _RouteReplay:
    """The reference's router gates, held against the port's routing.

    Each reference dispatch records its gates (G, S, E); each port
    ``_top_k`` call takes the next record in order.  Its gates must equal
    the reference's within ``TOL``; where its choices differ from the
    reference's (``jax.lax.top_k``'s: descending, ties to the lowest index)
    the two must lie within ``TIE_GAP`` of a tie, and the port takes the
    reference's choices there (its own gates at them, renormalised)."""

    def __init__(self):
        self.ref = collections.deque()
        self.replays = 0
        self.calls = 0
        self.active = True

    @contextlib.contextmanager
    def paused(self):
        """Port routings made to inspect a result, which no reference call
        matches."""
        self.active = False
        try:
            yield
        finally:
            self.active = True

    def record(self, gates):
        self.ref.append(np.asarray(gates))

    def take(self, gates, k, top, idx):
        if not self.active:
            return top, idx
        jax.effects_barrier()
        assert self.ref, "the port routed tokens the reference did not"
        rg = self.ref.popleft().reshape(gates.shape)
        g = gates.numpy()
        np.testing.assert_allclose(g, rg, **TOL)
        want = np.argsort(-rg, axis=-1, kind="stable")[:, :k]
        differ = np.nonzero((idx.numpy() != want).any(axis=-1))[0]
        self.calls += 1
        if not len(differ):
            return top, idx
        ours = np.take_along_axis(g, idx.numpy(), -1)[differ]
        theirs = np.take_along_axis(g, want, -1)[differ]
        assert np.abs(ours - theirs).max() <= TIE_GAP, (ours, theirs)
        self.replays += len(differ)
        idx = torch.from_numpy(want)
        picked = torch.gather(gates, -1, idx)
        return picked / torch.clamp(picked.sum(-1, keepdim=True), min=1e-9), idx


@pytest.fixture
def route_replay(monkeypatch):
    rep = _RouteReplay()
    ref_dispatch, ref_gather = jmoe._top_k_dispatch, jmoe._gather_dispatch_apply
    port_top_k = tmoe._top_k

    def dispatch(gates, k, capacity):
        jax.debug.callback(rep.record, gates, ordered=True)
        return ref_dispatch(gates, k, capacity)

    def gather(params, xg, gates, k, capacity, act_dtype):
        jax.debug.callback(rep.record, gates, ordered=True)
        return ref_gather(params, xg, gates, k, capacity, act_dtype)

    def top_k(gates, k):
        top, idx = port_top_k(gates, k)
        return rep.take(gates, k, top, idx)

    jax.clear_caches()
    monkeypatch.setattr(jmoe, "_top_k_dispatch", dispatch)
    monkeypatch.setattr(jmoe, "_gather_dispatch_apply", gather)
    monkeypatch.setattr(tmoe, "_top_k", top_k)
    yield rep
    jax.effects_barrier()
    jax.clear_caches()
    print(f"{rep.replays} port routings replaced by the reference's at a near-tie, "
          f"of {rep.calls} calls")
    assert not rep.ref, f"{len(rep.ref)} reference routings the port did not make"


# --------------------------------------------------------------------------- #
# the layer
# --------------------------------------------------------------------------- #
def _layer(arch, dtype="float32", **kw):
    """The reference's and the port's config and one MoE block's params
    (drawn by the reference, carried across)."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype, **kw)
    tcfg = dataclasses.replace(get_smoke(arch), dtype=dtype, **kw)
    jparams, _ = jmoe.moe_init(jax.random.PRNGKey(3), jcfg, getattr(jnp, dtype))

    def carry(tree):
        if isinstance(tree, dict):
            return {k: carry(v) for k, v in tree.items()}
        a = np.asarray(tree)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    return jcfg, tcfg, jparams, carry(jparams)


def _x(shape, seed=0, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    return jx, torch.from_numpy(x).to(getattr(torch, dtype))


def _layer_case(arch, dispatch, shape, rep=None, seed=0, dtype="float32", tol=TOL, **kw):
    """The layer in both packages on one seeded input, held at ``tol``;
    returns the port's config, params, input and routing."""
    jcfg, tcfg, jp, tp = _layer(arch, dtype=dtype, moe_dispatch=dispatch, **kw)
    jx, tx = _x(shape, seed, dtype)
    want, waux = jmoe.moe_apply(jp, jx, jcfg)
    got, gaux = tmoe.moe_apply(tp, tx, tcfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5, atol=1e-6)
    with rep.paused() if rep is not None else contextlib.nullcontext():
        route = tmoe.moe_route(tp, tx, tcfg)
    return tcfg, tp, tx, route


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_layer_drops_past_capacity(dispatch, route_replay):
    """capacity_factor 0.5: each expert takes 16 of a 64-token group's 128
    choices, so most are dropped, in the reference's arrival order."""
    _, _, _, route = _layer_case("mixtral-8x22b", dispatch, (2, 32, 128), route_replay,
                                 capacity_factor=0.5)
    dropped = int((route.dest == route.drop).sum())
    assert (route.groups, route.capacity) == (1, 16) and dropped > 32, dropped
    assert route_replay.replays == 0


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_layer_two_groups_of_2048(dispatch, route_replay):
    _, _, _, route = _layer_case("mixtral-8x22b", dispatch, (2, 2048, 128), route_replay, seed=1)
    assert (route.groups, route.group, route.capacity) == (2, 2048, 1280)
    assert route_replay.replays == 0


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_layer_fallback_one_group(dispatch, route_replay):
    """3,000 tokens: 2,048 does not divide them, so they route as one group
    (the reference's fallback), with its capacity."""
    _, _, _, route = _layer_case("mixtral-8x22b", dispatch, (1, 3000, 128), route_replay, seed=2,
                                 capacity_factor=0.75)
    assert (route.groups, route.group, route.capacity) == (1, 3000, 1128)
    assert int((route.dest == route.drop).sum()) > 0
    assert route_replay.replays == 0


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_exact_router_ties_go_to_the_lowest_index(arch, dispatch):
    """Router columns 1 = 0 and 3 = 2: every token's gates tie exactly in
    pairs, and both packages pick the lower index of a tied pair."""
    jcfg, tcfg, jp, tp = _layer(arch, moe_dispatch=dispatch)
    r = np.asarray(jp["router"]).copy()
    r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.from_numpy(r))
    jx, tx = _x((2, 40, 128), seed=4)
    want, waux = jmoe.moe_apply(jp, jx, jcfg)
    got, gaux = tmoe.moe_apply(tp, tx, tcfg)
    _close(got, want, TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    route = tmoe.moe_route(tp, tx, tcfg)
    g = route.gates
    assert torch.equal(g[:, 0], g[:, 1]) and torch.equal(g[:, 2], g[:, 3])
    assert set(route.top_idx[:, 0].tolist()) <= {0, 2}
    if tcfg.top_k == 2:      # the second choice is the first's tied twin
        assert torch.equal(route.top_idx[:, 1], route.top_idx[:, 0] + 1)
    # the same gates through jax.lax.top_k
    _, jidx = jax.lax.top_k(jnp.asarray(g.numpy()), tcfg.top_k)
    assert np.array_equal(np.asarray(jidx), route.top_idx.numpy())


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_layer_top1_with_a_shared_expert(dispatch, route_replay):
    tcfg, tp, _, route = _layer_case("llama4-scout-17b-16e", dispatch, (3, 50, 128),
                                     route_replay, seed=5)
    assert "shared" in tp and tcfg.top_k == 1
    assert torch.equal(route.top_gates, torch.ones_like(route.top_gates))
    assert route_replay.replays == 0


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_layer_aux_loss(arch, dispatch):
    """The aux loss E·Σ f_e·p_e / k, and its value from the routing by
    hand."""
    tcfg, tp, tx, route = _layer_case(arch, dispatch, (2, 24, 128), seed=6)
    E, k = tcfg.num_experts, tcfg.top_k
    frac = np.bincount(route.top_idx.numpy().ravel(), minlength=E) / route.gates.shape[0]
    want = E * float((frac * route.gates.double().mean(0).numpy()).sum()) / k
    _, aux = tmoe.moe_apply(tp, tx, tcfg)
    assert abs(float(aux) - want) <= 1e-5 * want


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_layer_bf16(dispatch):
    """bf16 activations and experts (the served dtype) against the
    reference's fp32 layer on the same bf16-representable inputs and
    weights (this CPU's XLA has no bf16 x bf16 -> fp32 dot): within the
    bf16 roundings of h, the expert rows and the output (rtol = 2^-6, atol =
    2^-6 of max |out|); the router stays fp32."""
    jcfg, tcfg, jp, tp = _layer("mixtral-8x22b", moe_dispatch=dispatch)
    tp = {k: v if k == "router" else v.bfloat16() for k, v in tp.items()}
    jp = {k: jnp.asarray(v.float().numpy()) for k, v in tp.items()}
    jx, tx = _x((2, 40, 128), seed=7)
    tx = tx.bfloat16()
    want, _ = jmoe.moe_apply(jp, jnp.asarray(tx.float().numpy()), jcfg)
    got, _ = tmoe.moe_apply(tp, tx, dataclasses.replace(tcfg, dtype="bfloat16"))
    want = np.asarray(want)
    assert got.dtype == torch.bfloat16 and tp["router"].dtype == torch.float32
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -6,
                               atol=2 ** -6 * np.abs(want).max())


def test_layer_decode_rows_do_not_depend_on_the_batch():
    """At a decode step (one token a row, no more rows than the capacity)
    each row's output is bitwise the row alone."""
    _, tcfg, _, tp = _layer("mixtral-8x22b")
    _, tx = _x((8, 1, 128), seed=8)
    whole, _ = tmoe.moe_apply(tp, tx, tcfg, aux=False)
    assert tmoe.moe_route(tp, tx, tcfg).capacity == 8
    for i in range(8):
        alone, aux = tmoe.moe_apply(tp, tx[i:i + 1], tcfg, aux=False)
        assert aux is None and torch.equal(alone[0], whole[i]), i


# --------------------------------------------------------------------------- #
# the models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_registry_match_the_reference(arch):
    assert arch in ARCH_IDS and PENDING_IDS == ()
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        assert dataclasses.asdict(get(arch)) == dataclasses.asdict(jget(arch))
    assert get_config("llama4-scout-17b-a16e") == get_config("llama4-scout-17b-16e")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_caches_match_the_reference_layout(arch):
    jcfg, params, tcfg, tparams = _smoke(arch)
    mine = tinit(torch.Generator().manual_seed(0), tcfg)
    assert _spec(mine) == _spec(params) == _spec(tparams)
    assert ("shared" in mine["blocks"]["b0"]["moe"]) == tcfg.shared_expert
    assert "mlp" not in mine["blocks"]["b0"]
    assert _spec(TLM(tcfg, device="cpu").init_cache(2, 96)) == \
        _spec(JLM(jcfg).init_cache(2, 96))


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_from_reference_carries_the_moe_tree(arch):
    _, params, tcfg, tparams = _smoke(arch)
    for name, leaf in params["blocks"]["b0"]["moe"].items():
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                assert np.array_equal(tparams["blocks"]["b0"]["moe"][name][k].numpy(),
                                      np.asarray(v))
        else:
            assert np.array_equal(tparams["blocks"]["b0"]["moe"][name].numpy(), np.asarray(leaf))
    host = _host(params)
    for bad in (dataclasses.replace(tcfg, num_experts=8), dataclasses.replace(tcfg, d_ff=128),
                dataclasses.replace(tcfg, shared_expert=not tcfg.shared_expert),
                dataclasses.replace(tcfg, num_experts=0)):
        with pytest.raises(ValueError, match="blocks/b0"):
            lm_from_reference(host, bad, device="cpu")


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_per_request_prefill_match(arch, quantize, replay, route_replay):
    """80 tokens, past Mixtral's window (32) and Llama4's chunk (64); the
    aux loss summed over the layers."""
    jcfg, params, tcfg, tparams = _smoke(arch)
    jp, tp = jq(params, quantize), tq(tparams, quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    toks = np.random.default_rng(9).integers(0, 512, size=(2, 80)).astype(np.int32)
    want, waux = jm.forward(jp, jnp.asarray(toks))
    got, gaux = tm.forward(tp, _t(toks))
    _close(got, want, TOL)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)
    assert float(gaux) > 0
    for n in (80, 13):
        jc, tc = jm.init_cache(1, 128), tm.init_cache(1, 128)
        want, jc = jm.prefill(jp, jnp.asarray(toks[:1, :n]), jc)
        got, tc = tm.prefill(tp, _t(toks[:1, :n]), tc)
        _close(got, want, TOL)
    assert route_replay.replays == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_ragged_prefill_is_refused_as_the_reference_refuses_it(arch):
    jcfg, params, tcfg, tparams = _smoke(arch)
    toks = np.zeros((2, 8), np.int32)
    lengths = np.asarray([8, 5], np.int32)
    with pytest.raises(ValueError, match="dense text-only"):
        JLM(jcfg).prefill_ragged(params, jnp.asarray(toks), jnp.asarray(lengths),
                                 JLM(jcfg).init_cache(2, 16))
    with pytest.raises(ValueError, match="dense text-only"):
        TLM(tcfg, device="cpu").prefill_ragged(tparams, _t(toks), _t(lengths),
                                               TLM(tcfg, device="cpu").init_cache(2, 16))


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_thirty_decode_steps_match(arch, quantize, replay, route_replay):
    """Per-request prefills of 80, 45 and 7 tokens into one batch of 3
    slots, then 30 per-slot decode steps: Mixtral's 32-slot ring wraps, and
    Llama4's chunked layers cross their chunk boundary at 64 (two rows in
    their prefill, all three while decoding); logits held at every step."""
    jcfg, params, tcfg, tparams = _smoke(arch)
    jp, tp = jq(params, quantize), tq(tparams, quantize)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    rng = np.random.default_rng(9)
    lens = (80, 45, 7)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32) for n in lens]
    jcs, tcs = [], []
    for p in prompts:
        _, jc = jm.prefill(jp, jnp.asarray(p[None]), jm.init_cache(1, 128))
        _, tc = tm.prefill(tp, _t(p[None]), tm.init_cache(1, 128))
        jcs.append(jc)
        tcs.append(tc)
    jc = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=1), *jcs)

    def cat(trees):
        if isinstance(trees[0], dict):
            return {k: cat([t[k] for t in trees]) for k in trees[0]}
        return torch.cat(trees, dim=1)

    tc = cat(tcs)
    pos = np.asarray(lens, np.int32)
    decode = jax.jit(jm.decode_step)
    for _ in range(30):
        tok = rng.integers(0, 512, size=(3, 1)).astype(np.int32)
        want, jc = decode(jp, jnp.asarray(tok), jnp.asarray(pos), jc)
        got, tc = tm.decode_step(tp, _t(tok), _t(pos), tc)
        _close(got, want, TOL)
        pos += 1
    assert route_replay.replays == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_quantizes_attention_and_leaves_the_experts(arch):
    """Under ``quantize="int8"`` the attention projections are int8 and
    every routed expert, the router and the shared expert stay as they are,
    in both packages (the reference's int8 reaches a block's top-level
    ``attn`` and ``mlp`` only); drawn-as-quantized is bitwise
    draw-then-quantize."""
    _, params, tcfg, tparams = _smoke(arch)
    jmoe_q = jq(params, "int8")["blocks"]["b0"]
    tmoe_q = tq(tparams, "int8")["blocks"]["b0"]
    drawn = tinit(torch.Generator().manual_seed(4), dataclasses.replace(tcfg, quantize="int8"))
    plain = tq(tinit(torch.Generator().manual_seed(4), tcfg), "int8")
    for block, ref in ((tmoe_q, jmoe_q), (drawn["blocks"]["b0"], None)):
        assert all(isinstance(w, QTensor) for w in block["attn"].values())
        leaves = [v for k, v in block["moe"].items() if k != "shared"]
        leaves += list(block["moe"].get("shared", {}).values())
        assert leaves and all(isinstance(w, torch.Tensor) for w in leaves)
        assert block["moe"]["router"].dtype == torch.float32
        assert all(w.dtype == torch.float32 for w in leaves)    # the smoke config's dtype
        if ref is not None:
            assert all(isinstance(w, JQTensor) for w in ref["attn"].values())
            assert not any(isinstance(w, JQTensor) for w in jax.tree.leaves(ref["moe"]))
    assert ("shared" in drawn["blocks"]["b0"]["moe"]) == tcfg.shared_expert
    for k in ("router", "w_gate", "w_down"):
        assert torch.equal(drawn["blocks"]["b0"]["moe"][k], plain["blocks"]["b0"]["moe"][k])
    assert torch.equal(drawn["blocks"]["b0"]["attn"]["wq"].qt,
                       plain["blocks"]["b0"]["attn"]["wq"].qt)
