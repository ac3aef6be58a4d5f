"""The port's radix prefix KV cache and its tail prefill against the JAX
reference, on the CPU.

* The host trie (``serve/prefix_cache.py``, a copy of the reference's) under
  the random operation sequences of ``tests/test_prefix_cache.py``, run
  side by side with the reference's: the same matches, block ids, writes,
  evictions and statistics after every operation.
* ``_prefill_offset`` (``attn_apply(start_pos=)``) for every attention kind,
  against the reference's, and ``prefill_ragged(start_pos=)`` for the
  stack: outputs and the caches they leave.
* Greedy streams bit-identical with the cache on and off, mirroring
  ``tests/test_serve_prefix.py``: ragged global attention with hits,
  windowed hits and ring truncation, int8 and bf16 weights, warmup's probe
  blocks dropped, a fleet sharing one trie; and the streams of the JAX
  engine with its prefix cache.
* The engine's three refusals.

Tolerances as in ``tests/test_torch_lm.py``: fp32 on both sides, layer
outputs at rtol = atol = 1e-5 and logits at 1e-4.  Streams are compared
exactly, cache on against cache off within the port (the tail rows are the
full prefill's rows; kernel 6's plain tail form lays its keys out by
position as the full prefill's plain form does).
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
from repro.serve import RadixPrefixCache as JRadix
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.models.config import BlockKind
from repro_torch.models.layers import attention as tattn
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import RadixPrefixCache, ReplicaRouter, Request, ServeEngine
from repro_torch.weights import lm_from_reference
from test_torch_lm import (KINDS, LAYER_TOL, LOGIT_TOL, _attn_pair, _close, _host,
                           _mask_cfgs, _t)


# --------------------------------------------------------------------------- #
# the host trie, side by side with the reference's
# --------------------------------------------------------------------------- #
def _state(pc):
    """Everything observable of a trie: its nodes by token path (block id,
    start, valid_end, refs, last_used), the free list and the stats."""
    nodes = {}

    def walk(node, path):
        for key, child in node.children.items():
            p = path + (key,)
            nodes[p] = (child.block_id, child.start, child.valid_end, child.refs,
                        child.last_used)
            walk(child, p)

    walk(pc._root, ())
    return nodes, list(pc._free), pc.stats()


@pytest.mark.parametrize("seed", range(12))
def test_trie_matches_the_reference_under_random_operations(seed):
    """The reference's property-suite interleavings (match and pin,
    plan_insert, release, peek, reset) on both tries: every result and the
    whole state after every operation are the same."""
    rng = np.random.default_rng(seed)
    bs = int(rng.choice([2, 4]))
    cap = int(rng.choice([3, 6, 12]))
    rings = [(), (2 * bs,), (2 * bs, 64)][rng.integers(0, 3)]
    ours, ref = (cls(block_size=bs, capacity_blocks=cap, ring_sizes=rings)
                 for cls in (RadixPrefixCache, JRadix))
    bases = [rng.integers(0, 5, size=int(rng.integers(bs, 6 * bs))).astype(np.int32)
             for _ in range(3)]
    pinned = []
    for _ in range(80):
        op = rng.integers(0, 11)
        toks = bases[rng.integers(0, 3)].copy()
        if rng.random() < 0.3 and len(toks) > 1:
            toks[rng.integers(0, len(toks))] += 1
        if op < 4:
            a, b = ours.match(toks), ref.match(toks)
            assert (a.length, a.block_ids) == (b.length, b.block_ids)
            pinned.append((a, b))
        elif op < 7:
            assert ours.plan_insert(toks) == ref.plan_insert(toks)
        elif op < 9 and pinned:
            a, b = pinned.pop(rng.integers(0, len(pinned)))
            ours.release(a)
            ref.release(b)
        elif op == 9:
            assert ours.peek(toks) == ref.peek(toks)
        elif not pinned and rng.random() < 0.2:
            ours.reset()
            ref.reset()
        assert _state(ours) == _state(ref)
        assert ours.blocks <= cap
    for a, b in pinned:
        ours.release(a)
        ref.release(b)
    assert _state(ours) == _state(ref)


def test_trie_units_match_the_reference():
    """The reference's unit cases (tail token kept, block alignment, ring
    truncation, LRU eviction, pinned blocks kept, reset) on both tries."""
    for cls in (RadixPrefixCache, JRadix):
        pc = cls(block_size=4, capacity_blocks=16, ring_sizes=(8,))
        toks = np.random.default_rng(5).integers(0, 1000, size=17).astype(np.int32)
        pc.plan_insert(toks)
        assert pc.peek(toks) == 0
        pc.plan_insert(toks[:8])
        m = pc.match(toks)
        assert m.length == 8
        pc.release(m)
        pc = cls(block_size=4, capacity_blocks=2)
        a, b, c = (np.random.default_rng(s).integers(0, 1000, size=5).astype(np.int32)
                   for s in (7, 8, 9))
        pc.plan_insert(a)
        pc.plan_insert(b)
        pc.release(pc.match(b))
        pc.plan_insert(c)
        assert (pc.peek(a), pc.peek(b), pc.peek(c), pc.evictions) == (0, 4, 4, 1)
    pc = RadixPrefixCache(block_size=4, capacity_blocks=8)
    toks = np.arange(9, dtype=np.int32)
    pc.plan_insert(toks)
    m = pc.match(toks)
    pc.release(m)
    with pytest.raises(RuntimeError, match="release"):
        pc.release(m)
    with pytest.raises(ValueError):
        RadixPrefixCache(block_size=0)
    with pytest.raises(ValueError):
        RadixPrefixCache(capacity_blocks=0)
    with pytest.raises(RuntimeError, match="bind"):
        RadixPrefixCache().restore_into({}, [(0, 0, 0, 4)])


# --------------------------------------------------------------------------- #
# _prefill_offset and prefill_ragged(start_pos=)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", KINDS)
def test_prefill_offset_matches_the_reference(kind):
    """A ragged prefill of the prompts' heads, then the tail prefill over
    that cache (rows at start 0 read no prefix, as miss rows): the tail's
    outputs and the cache it leaves against the reference's, and each tail
    row against the full prefill's row at the same position."""
    jcfg, tcfg = _mask_cfgs()
    jp, tp = _attn_pair(jcfg, seed=9)
    B, S, max_seq = 4, 32, 40
    rng = np.random.default_rng(10)
    x = rng.normal(size=(B, S, 128)).astype(np.float32)
    lengths = np.asarray([32, 27, 19, 11], np.int32)
    starts = np.asarray([9, 20, 0, 5], np.int32)
    jk, tk = JKind(kind), BlockKind(kind)
    full, _ = tattn.attn_apply(tp, _t(x), cfg=tcfg, kind=tk, mode="prefill",
                               positions=torch.arange(S),
                               cache=tattn.init_kv_cache(tcfg, tk, B, max_seq, torch.float32),
                               lengths=_t(lengths))
    head = np.zeros_like(x)
    tail = np.zeros_like(x)
    for b, (s, n) in enumerate(zip(starts, lengths)):
        head[b, :s] = x[b, :s]
        tail[b, :n - s] = x[b, s:n]
    jc = jattn.init_kv_cache(jcfg, jk, B, max_seq, jnp.float32)
    tc = tattn.init_kv_cache(tcfg, tk, B, max_seq, torch.float32)
    hl = np.maximum(starts, 1)
    _, jc = jattn.attn_apply(jp, jnp.asarray(head), cfg=jcfg, kind=jk, mode="prefill",
                             positions=jnp.arange(S), cache=jc, lengths=jnp.asarray(hl))
    _, tc = tattn.attn_apply(tp, _t(head), cfg=tcfg, kind=tk, mode="prefill",
                             positions=torch.arange(S), cache=tc, lengths=_t(hl))
    tl = lengths - starts
    want, jc = jattn.attn_apply(jp, jnp.asarray(tail), cfg=jcfg, kind=jk, mode="prefill",
                                cache=jc, lengths=jnp.asarray(tl),
                                start_pos=jnp.asarray(starts))
    got, tc = tattn.attn_apply(tp, _t(tail), cfg=tcfg, kind=tk, mode="prefill", cache=tc,
                               lengths=_t(tl), start_pos=_t(starts))
    for b, (s, n) in enumerate(zip(starts, tl)):
        _close(got[b, :n], np.asarray(want)[b, :n], LAYER_TOL)
        _close(got[b, :n], full[b, s:s + n].numpy(), LAYER_TOL)
    # a start-0 row's cache holds its head's garbage nowhere: compare the
    # rows the tail wrote and the restored prefix
    _close(tc["k"], jc["k"], LAYER_TOL)
    _close(tc["v"], jc["v"], LAYER_TOL)
    with pytest.raises(ValueError, match="cache= and lengths="):
        tattn.attn_apply(tp, _t(tail), cfg=tcfg, kind=tk, mode="prefill",
                         start_pos=_t(starts))


@pytest.fixture(scope="module")
def qwen():
    jcfg = jget_smoke("qwen2-1.5b")                   # dense GQA, global attention
    params, _ = jinit(jax.random.PRNGKey(0), jcfg)
    tcfg = get_smoke("qwen2-1.5b")
    return jcfg, params, tcfg, lm_from_reference(_host(params), tcfg, device="cpu")


@pytest.fixture(scope="module")
def gemma():
    jcfg = jget_smoke("gemma3-1b")                    # sliding-window rings
    params, _ = jinit(jax.random.PRNGKey(1), jcfg)
    tcfg = get_smoke("gemma3-1b")
    return jcfg, params, tcfg, lm_from_reference(_host(params), tcfg, device="cpu")


@pytest.mark.parametrize("model", ["qwen", "gemma"])
def test_prefill_ragged_start_pos_matches_the_reference(model, request):
    jcfg, params, tcfg, tparams = request.getfixturevalue(model)
    jm, tm = JLM(jcfg), TLM(tcfg, device="cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, size=(3, 48)).astype(np.int32)
    starts = np.asarray([16, 40, 8], np.int32)
    lens = np.asarray([48, 45, 30], np.int32)
    head = np.where(np.arange(48)[None] < starts[:, None], toks, 0).astype(np.int32)
    jc, tc = jm.init_cache(3, 64), tm.init_cache(3, 64)
    _, jc = jm.prefill_ragged(params, jnp.asarray(head), jnp.asarray(starts), jc)
    _, tc = tm.prefill_ragged(tparams, _t(head), _t(starts), tc)
    tail = np.zeros((3, 32), np.int32)
    for b in range(3):
        tail[b, :lens[b] - starts[b]] = toks[b, starts[b]:lens[b]]
    want, jc = jm.prefill_ragged(params, jnp.asarray(tail), jnp.asarray(lens - starts), jc,
                                 start_pos=jnp.asarray(starts))
    got, tc = tm.prefill_ragged(tparams, _t(tail), _t(lens - starts), tc,
                                start_pos=_t(starts))
    _close(got, want, LOGIT_TOL)
    full, _ = tm.prefill_ragged(tparams, _t(toks), _t(lens), tm.init_cache(3, 64))
    _close(got, full.numpy(), LOGIT_TOL)
    for name in tc:
        _close(tc[name]["attn"]["k"], jc[name]["attn"]["k"], LOGIT_TOL)


# --------------------------------------------------------------------------- #
# the engine: streams with the cache on and off
# --------------------------------------------------------------------------- #
def _shared_trace(cls, cfg, *, prefix_len=24, n=6, lead_with_prefix=False, max_new=5,
                  seed=3):
    """The reference test's trace: requests sharing a ``prefix_len``-token
    prefix (1 in 3 fully random)."""
    rng = np.random.default_rng(seed)
    shared = np.random.default_rng(1000 + prefix_len).integers(
        0, cfg.vocab_size, size=prefix_len).astype(np.int32)
    reqs = []
    if lead_with_prefix:
        reqs.append(cls(prompt=shared.copy(), max_new_tokens=max_new))
    for i in range(n):
        tail = rng.integers(0, cfg.vocab_size, size=4 + i % 4).astype(np.int32)
        if i % 3 == 0 and not lead_with_prefix:
            p = rng.integers(0, cfg.vocab_size, size=prefix_len + 4 + i % 4).astype(np.int32)
        else:
            p = np.concatenate([shared, tail])
        reqs.append(cls(prompt=p, max_new_tokens=max_new))
    return reqs


def _streams(engine, reqs):
    return [list(r.out_tokens) for r in engine.run(reqs)]


def test_ragged_global_bit_identical_with_hits_and_the_jax_engine(qwen):
    jcfg, params, tcfg, tparams = qwen
    base = _streams(ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, device="cpu"),
                    _shared_trace(Request, tcfg))
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, prefix_cache=pc, device="cpu")
    served = on.run(_shared_trace(Request, tcfg))
    assert [list(r.out_tokens) for r in served] == base
    s = pc.stats()
    assert s["cached_tokens"] > 0 and s["hits"] > 0
    assert any(r.cached_prefill > 0 for r in served)
    assert on.calls["tail_waves"] > 0
    jpc = JRadix(block_size=8, capacity_blocks=64)
    jserved = JEngine(jcfg, params, batch_size=3, max_seq=96, prefix_cache=jpc).run(
        _shared_trace(JRequest, jcfg))
    assert [list(r.out_tokens) for r in jserved] == base
    assert [r.cached_prefill for r in jserved] == [r.cached_prefill for r in served]
    assert jpc.stats() == s


def test_second_identical_prefix_wave_hits(qwen):
    _, _, tcfg, tparams = qwen
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, prefix_cache=pc, device="cpu")
    base = _streams(ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, device="cpu"),
                    _shared_trace(Request, tcfg, seed=8))
    assert _streams(on, _shared_trace(Request, tcfg, seed=8)) == base
    first = pc.stats()["cached_tokens"]
    assert _streams(on, _shared_trace(Request, tcfg, seed=8)) == base
    assert pc.stats()["cached_tokens"] > first


def test_windowed_hit_parity(gemma):
    """Sliding-window rings reuse a prefix only where its blocks were
    extracted at a valid_end the window still sees; streams stay exact."""
    _, _, tcfg, tparams = gemma
    kw = dict(prefix_len=40, lead_with_prefix=True, n=5)
    base = _streams(ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, device="cpu"),
                    _shared_trace(Request, tcfg, **kw))
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, prefix_cache=pc, device="cpu")
    assert _streams(on, _shared_trace(Request, tcfg, **kw)) == base
    assert pc.stats()["cached_tokens"] > 0


def test_windowed_truncation_still_exact(gemma):
    """Blocks extracted from longer prompts hold ring garbage for the
    windowed layer; the match truncates (here to zero) and streams stay
    exact."""
    _, _, tcfg, tparams = gemma
    kw = dict(prefix_len=40, n=5)
    base = _streams(ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, device="cpu"),
                    _shared_trace(Request, tcfg, **kw))
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, prefix_cache=pc, device="cpu")
    assert _streams(on, _shared_trace(Request, tcfg, **kw)) == base
    assert pc.stats()["cached_tokens"] == 0


def test_windowed_hits_past_the_ring(gemma):
    """A shared prefix longer than the window (32 slots): the hit waves'
    sub-caches hold the full ring, so ``p mod ring`` addresses the shared
    cache's slots, and the streams stay exact."""
    _, _, tcfg, tparams = gemma
    kw = dict(prefix_len=48, lead_with_prefix=True, n=4, max_new=6)
    base = _streams(ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, device="cpu"),
                    _shared_trace(Request, tcfg, **kw))
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, prefix_cache=pc, device="cpu")
    assert _streams(on, _shared_trace(Request, tcfg, **kw)) == base
    assert pc.stats()["cached_tokens"] > 0


@pytest.mark.parametrize("q", ["int8", "bf16"])
def test_quantized_weights_parity(qwen, q):
    _, _, tcfg0, tparams = qwen
    tcfg = dataclasses.replace(tcfg0, quantize=q)
    base = _streams(ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, device="cpu"),
                    _shared_trace(Request, tcfg, n=5))
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ServeEngine(tcfg, tparams, batch_size=2, max_seq=96, prefix_cache=pc, device="cpu")
    assert _streams(on, _shared_trace(Request, tcfg, n=5)) == base
    assert pc.stats()["cached_tokens"] > 0


def test_warmup_drops_probe_blocks(qwen):
    _, _, tcfg, tparams = qwen
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    engine = ServeEngine(tcfg, tparams, batch_size=3, max_seq=96, prefix_cache=pc,
                         device="cpu")
    engine.warmup(prompt_lens=(9, 20))
    assert pc.stats()["requests"] == 0 and pc.blocks == 0


def test_fleet_parity_and_shared_trie(qwen):
    _, _, tcfg, tparams = qwen
    off = ReplicaRouter(tcfg, tparams, slots_per_replica=2, max_replicas=2, max_seq=96,
                        device="cpu")
    base = sorted(tuple(r.out_tokens) for r in off.run(_shared_trace(Request, tcfg, n=8)))
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ReplicaRouter(tcfg, tparams, slots_per_replica=2, max_replicas=2, max_seq=96,
                       prefix_cache=pc, device="cpu")
    on.warmup()
    assert pc.stats()["requests"] == 0
    got = sorted(tuple(r.out_tokens) for r in on.run(_shared_trace(Request, tcfg, n=8)))
    assert got == base
    rep = on.report()
    assert rep["prefix_cache"]["cached_tokens"] > 0 and rep["prefix_cache"]["hits"] > 0


def test_tenant_hit_rate_accounting(qwen):
    _, _, tcfg, tparams = qwen
    pc = RadixPrefixCache(block_size=8, capacity_blocks=64)
    on = ReplicaRouter(tcfg, tparams, slots_per_replica=2, max_replicas=1, max_seq=96,
                       prefix_cache=pc, device="cpu")
    reqs = _shared_trace(Request, tcfg, n=6)
    for r in reqs:
        r.tenant = "acme"
    on.run(reqs)
    t = on.report()["tenants"]["acme"]
    assert t["prefill_tokens"] == sum(len(r.prompt) for r in reqs)
    assert t["cached_prefill_tokens"] > 0 and 0.0 < t["prefix_hit_rate"] < 1.0


def test_restore_and_extract_are_the_blocks(qwen):
    """A pool round trip: blocks extracted from one sub-cache and restored
    into another land at the same positions, bitwise, on a global and a
    ring layer."""
    tcfg = get_smoke("gemma3-1b")
    model = TLM(tcfg, device="cpu")
    pc = RadixPrefixCache(block_size=4, capacity_blocks=8)
    pc.bind(model, 64)
    src = model.init_cache(2, 64)
    for leaf in (src["b0"]["attn"]["k"], src["b1"]["attn"]["k"]):
        leaf.copy_(torch.randn(leaf.shape))
    pc.extract_from(src, [(1, 3, 0), (1, 5, 4), (0, 2, 8)])
    dst = model.init_cache(1, 64)
    pc.restore_into(dst, [(0, 3, 0, 8), (0, 5, 4, 8)])
    for name in ("b0", "b1"):
        ring = src[name]["attn"]["k"].shape[2]
        for p in range(8):
            assert torch.equal(dst[name]["attn"]["k"][:, 0, p % ring],
                               src[name]["attn"]["k"][:, 1, p % ring])


# --------------------------------------------------------------------------- #
# refusals
# --------------------------------------------------------------------------- #
def test_int8_kv_storage_refused(qwen):
    _, _, tcfg0, tparams = qwen
    tcfg = dataclasses.replace(tcfg0, cache_dtype="int8")
    with pytest.raises(ValueError, match="cache_dtype"):
        ServeEngine(tcfg, tparams, batch_size=2, max_seq=96,
                    prefix_cache=RadixPrefixCache(), device="cpu")


def test_non_ragged_stack_refused():
    cfg = get_smoke("mamba2-2.7b")
    params = tinit(torch.Generator().manual_seed(2), cfg)
    with pytest.raises(ValueError, match="ragged"):
        ServeEngine(cfg, params, batch_size=2, max_seq=64, prefix_cache=RadixPrefixCache(),
                    device="cpu")


def test_rebind_different_layout_refused(qwen, gemma):
    _, _, tcfg_q, tparams_q = qwen
    _, _, tcfg_g, tparams_g = gemma
    pc = RadixPrefixCache(block_size=8, capacity_blocks=16)
    ServeEngine(tcfg_q, tparams_q, batch_size=2, max_seq=96, prefix_cache=pc, device="cpu")
    ServeEngine(tcfg_q, tparams_q, batch_size=3, max_seq=96, prefix_cache=pc, device="cpu")
    with pytest.raises(ValueError, match="already bound"):
        ServeEngine(tcfg_g, tparams_g, batch_size=2, max_seq=96, prefix_cache=pc,
                    device="cpu")
