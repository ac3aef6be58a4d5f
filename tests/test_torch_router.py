"""The port's replica router, autoscaler and predictor fleet against the
JAX reference's, on the CPU.

``QueueAutoscaler`` is plain Python in both packages: the same tick
sequences give the same targets and events.  ``ReplicaRouter`` runs
Qwen2-1.5B's ``SMOKE`` configuration (fp32) with the reference's weights
carried across by ``lm_from_reference``; both routers serve the same
requests under the same deterministic clock (one tick a ``now()`` call),
so every decision — dispatch, admission (reject, degrade), scale-up and
drain, the wave bucket ladder — and every latency stamp must agree
exactly, and every stream must equal the port engine's ``_run_one``.  The
port's span decode is a step over views of the shared cache, where the
reference slices, decodes and writes back; the streams are the same.
``PredictorFleet`` dispatches the same blocks to the same replicas,
reports the same counts and serves the same k-means assignments, exactly.
"""
import dataclasses
import itertools

import jax
import numpy as np
import pytest

from repro.configs import get_smoke as jget_smoke
from repro.core.algorithms.kmeans import KMeans as JKMeans
from repro.core.numeric_table import MLNumericTable as JTable
from repro.models.layers.quant import QTensor as JQTensor
from repro.models.transformer import init_model as jinit
from repro.serve import PredictorFleet as JFleet
from repro.serve import QueueAutoscaler as JAutoscaler
from repro.serve import ReplicaRouter as JRouter
from repro.serve import Request as JRequest
from repro.serve.predictor import ModelPredictor as JPredictor
from repro.serve.predictor import PredictRequest as JPredictRequest
from repro_torch.configs import get_smoke
from repro_torch.core.algorithms.kmeans import KMeansParameters
from repro_torch.serve import (PredictorFleet, QueueAutoscaler, RadixPrefixCache,
                               ReplicaRouter, Request, ServeEngine)
from repro_torch.serve.predictor import ModelPredictor, PredictRequest
from repro_torch.weights import from_reference, lm_from_reference

def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, JQTensor):
        return (np.asarray(tree.q), np.asarray(tree.scale), tree.n_contract)
    return np.asarray(tree)


def _ticking_clock(step=1e-3):
    c = itertools.count()
    return lambda: next(c) * step


def _reqs(cls, specs, vocab):
    """Requests from (tenant, prompt length, max_new, seed, slo_ms) specs,
    drawn with numpy: the same prompts for either package.  Request i
    arrives at i · 0.1 ms: the routers release equal arrivals in ``id()``
    order, which two runs need not share."""
    out = []
    for i, (tenant, n, max_new, seed, slo) in enumerate(specs):
        rng = np.random.default_rng(seed)
        out.append(cls(prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                       max_new_tokens=max_new, tenant=tenant, slo_ms=slo, arrival=i * 1e-4))
    return out


def _outcome(reqs):
    return [(r.out_tokens, r.done, r.rejected, r.degraded, r.max_new_tokens, r.admitted_at,
             r.finished_at, r.cached_prefill) for r in reqs]


def _summary(rep):
    """The report's decisions and stamps (every key but the prefix cache's
    device-free stats, compared on their own)."""
    keep = ("replicas", "active", "slots_per_replica", "finished", "rejected", "degraded",
            "latency_p50", "latency_p95", "latency_p99", "backfills", "ema_tok_s",
            "tenants", "autoscaler_events")
    return {k: rep[k] for k in keep}


# --------------------------------------------------------------------------- #
# the autoscaler
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", range(6))
def test_autoscaler_tick_sequences_equal_the_references(seed):
    rng = np.random.default_rng(seed)
    spr, lo, hi = int(rng.integers(1, 5)), int(rng.integers(1, 3)), int(rng.integers(3, 7))
    kw = dict(slots_per_replica=spr, min_replicas=lo, max_replicas=hi,
              hysteresis=int(rng.integers(1, 4)))
    mine, ref = QueueAutoscaler(**kw), JAutoscaler(**kw)
    active = lo
    for t in range(200):
        queued = int(rng.integers(0, 3 * spr * hi)) if rng.random() < 0.4 else 0
        busy = int(rng.integers(0, spr * active + 1))
        a = mine.tick(queued, busy, active, now=t * 0.01)
        b = ref.tick(queued, busy, active, now=t * 0.01)
        assert a == b
        active = a
    assert mine.events == ref.events
    assert any(k == "up" for _, k, _ in mine.events)


def test_autoscaler_validation_is_the_references():
    for bad in (dict(slots_per_replica=0), dict(slots_per_replica=2, min_replicas=3,
                                                max_replicas=2)):
        with pytest.raises(ValueError):
            JAutoscaler(**bad)
        with pytest.raises(ValueError):
            QueueAutoscaler(**bad)


# --------------------------------------------------------------------------- #
# the router
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def smoke():
    jcfg = jget_smoke("qwen2-1.5b")
    params, _ = jinit(jax.random.PRNGKey(3), jcfg)
    tcfg = get_smoke("qwen2-1.5b")
    return jcfg, params, tcfg, lm_from_reference(_host(params), tcfg, device="cpu")


def _pair(smoke, **kw):
    jcfg, jparams, tcfg, tparams = smoke
    jkw, tkw = dict(kw), dict(kw)
    for side, k in ((jkw, JAutoscaler), (tkw, QueueAutoscaler)):
        if "autoscaler" in side:
            side["autoscaler"] = k(**side["autoscaler"])
        if "prefix_cache" in side:
            side["prefix_cache"] = _prefix_cache(side is jkw, **side["prefix_cache"])
    return (JRouter(jcfg, jparams, max_seq=64, **jkw),
            ReplicaRouter(tcfg, tparams, max_seq=64, device="cpu", **tkw))


def _prefix_cache(ref: bool, **kw):
    if ref:
        from repro.serve import RadixPrefixCache as JPrefixCache
        return JPrefixCache(**kw)
    return RadixPrefixCache(**kw)


def _serve_both(smoke, specs, warm=None, **kw):
    """Run both routers on the same requests and clock; return (ref, port)
    routers and requests."""
    jr, tr = _pair(smoke, **kw)
    for r, w in ((jr, warm), (tr, warm)):
        if w is not None:
            r._ema_tok, r._completions = w
    vocab = smoke[2].vocab_size
    jreqs, treqs = _reqs(JRequest, specs, vocab), _reqs(Request, specs, vocab)
    jr.run(jreqs, now_fn=_ticking_clock())
    tr.run(treqs, now_fn=_ticking_clock())
    return jr, tr, jreqs, treqs


def _oracle_streams(smoke, treqs, specs):
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, batch_size=1, max_seq=64, device="cpu")
    for got, want in zip(treqs, _reqs(Request, specs, tcfg.vocab_size)):
        if got.done:
            want.max_new_tokens = got.max_new_tokens      # a degraded request
            assert got.out_tokens == eng._run_one(want).out_tokens


FLEET = [("default", n, 5, i, None) for i, n in enumerate((5, 9, 13, 7, 11, 6, 8, 10))]


@pytest.mark.parametrize("replicas,spr", [(2, 2), (3, 1), (1, 4)])
def test_fleet_decisions_and_streams_equal_the_references(smoke, replicas, spr):
    """A fixed fleet: the same dispatch, admissions, backfills and stamps
    as the reference, and every stream the port engine's ``_run_one``."""
    jr, tr, jreqs, treqs = _serve_both(smoke, FLEET, slots_per_replica=spr,
                                       max_replicas=replicas)
    assert _outcome(treqs) == _outcome(jreqs)
    assert _summary(tr.report()) == _summary(jr.report())
    assert [s.report() for s in tr.scheds] == [s.report() for s in jr.scheds]
    assert all(r.done for r in treqs)
    _oracle_streams(smoke, treqs, FLEET)


def test_skewed_tenants_are_served_as_the_reference_serves_them(smoke):
    specs = ([("heavy", 6, 3, i, None) for i in range(10)]
             + [("light", 6, 3, 100 + i, None) for i in range(3)])
    jr, tr, jreqs, treqs = _serve_both(smoke, specs, slots_per_replica=2, max_replicas=1)
    assert _outcome(treqs) == _outcome(jreqs)
    rep = tr.report()["tenants"]
    assert rep == jr.report()["tenants"]
    assert rep["light"]["latency_p50"] < rep["heavy"]["latency_p50"]


@pytest.mark.parametrize("admission,warm,specs", [
    # a warmed EMA of 10 s a token against a 1 ms SLO sheds every SLO request
    ("reject", (10.0, 5), [("slo", 5, 2, i, 1.0) for i in range(3)]
     + [("free", 5, 2, 10 + i, None) for i in range(2)]),
    # full length predicts 8.5 s, half 4.5 s: a 7 s deadline degrades
    ("degrade", (1.0, 5), [("default", 5, 8, 0, 7000.0)]),
    # per-token normalization: the long generation is shed, the short kept
    ("reject", (1.0, 5), [("long", 5, 40, 0, 10_000.0), ("short", 5, 4, 1, 10_000.0)]),
])
def test_admission_decisions_equal_the_references(smoke, admission, warm, specs):
    jr, tr, jreqs, treqs = _serve_both(smoke, specs, warm=warm,
                                       slots_per_replica=2, max_replicas=1,
                                       admission=admission)
    assert _outcome(treqs) == _outcome(jreqs)
    assert _summary(tr.report()) == _summary(jr.report())
    assert tr.report()["rejected"] + tr.report()["degraded"] > 0
    _oracle_streams(smoke, treqs, specs)


def test_autoscale_up_then_drain_as_the_reference(smoke):
    specs = [("default", 5, 4, i, None) for i in range(12)]
    auto = dict(slots_per_replica=2, min_replicas=1, max_replicas=3, hysteresis=1)
    jr, tr, jreqs, treqs = _serve_both(smoke, specs, slots_per_replica=2, max_replicas=3,
                                       min_replicas=1, autoscaler=auto)
    events = tr.report()["autoscaler_events"]
    assert events == jr.report()["autoscaler_events"]
    kinds = [k for _, k, _ in events]
    assert "up" in kinds and "down" in kinds and tr.active == jr.active < 3
    assert _outcome(treqs) == _outcome(jreqs)
    _oracle_streams(smoke, treqs, specs)


def test_wave_bucket_ladder_is_the_references(smoke):
    jr, tr = _pair(smoke, slots_per_replica=4, max_replicas=4)
    ns = (1, 2, 3, 5, 9, 16, 99)
    assert [tr._wave_bucket(n) for n in ns] == [jr._wave_bucket(n) for n in ns] \
        == [1, 2, 4, 8, 16, 16, 16]
    jr, tr = _pair(smoke, slots_per_replica=3, max_replicas=3)
    assert [tr._wave_bucket(n) for n in ns] == [jr._wave_bucket(n) for n in ns]


def test_warmed_fleet_with_a_shared_prefix_cache(smoke):
    """A fleet with the prefix cache, warmed on every span: the warm-up's
    probe blocks are dropped, hits and streams are the reference's, and
    the span decodes write the shared cache in place (the warm-up's steps
    ran eagerly on the CPU, one a span)."""
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, smoke[2].vocab_size, 24).astype(np.int32)
    specs = [("default", 4 + i, 3, 50 + i, None) for i in range(8)]
    pc = dict(block_size=8, capacity_blocks=32)
    jr, tr = _pair(smoke, slots_per_replica=2, max_replicas=2, prefix_cache=pc)
    for r in (jr, tr):
        r.warmup(prompt_lens=[28, 36], spans=[1, 2])
        assert r.engine.prefix_cache.blocks == 0
    assert tr.engine.calls["decode_eager"] >= 2
    vocab = smoke[2].vocab_size
    jreqs, treqs = _reqs(JRequest, specs, vocab), _reqs(Request, specs, vocab)
    for reqs in (jreqs, treqs):
        for r in reqs:
            r.prompt = np.concatenate([prefix, r.prompt])
    jr.run(jreqs, now_fn=_ticking_clock())
    tr.run(treqs, now_fn=_ticking_clock())
    assert _outcome(treqs) == _outcome(jreqs)
    assert tr.engine.prefix_cache.stats() == jr.engine.prefix_cache.stats()
    assert sum(r.cached_prefill for r in treqs) > 0
    eng = ServeEngine(smoke[2], smoke[3], batch_size=1, max_seq=64, device="cpu")
    for r in treqs:
        want = Request(prompt=r.prompt, max_new_tokens=r.max_new_tokens)
        assert r.out_tokens == eng._run_one(want).out_tokens


def test_span_decode_writes_the_shared_cache_in_place(smoke):
    """``decode_span`` steps views of the first lanes: the lanes past the
    span keep their bits, the span's lanes take what a decode step over a
    copy of them writes."""
    _, _, tcfg, tparams = smoke
    eng = ServeEngine(tcfg, tparams, batch_size=4, max_seq=32, device="cpu")
    cache = eng.init_shared_cache()
    reqs = _reqs(Request, [("default", n, 2, i, None) for i, n in enumerate((5, 7, 6, 9))],
                 tcfg.vocab_size)
    cache, first = eng._prefill_into(cache, list(enumerate(reqs)))
    before = {b: {k: t.clone() for k, t in c["attn"].items()} for b, c in cache.items()}
    sub = {b: {"attn": {k: t[:, :2].clone() for k, t in c.items()}}
           for b, c in before.items()}
    toks = eng._tensor(first[:2, None])
    pos = eng._tensor([5, 7])
    want, sub = eng.model.decode_step(eng.params, toks, pos, sub)
    got = eng.decode_span(2, toks, pos, cache)
    assert (got == want).all()
    for b in cache:
        for k, t in cache[b]["attn"].items():
            assert (t[:, :2] == sub[b]["attn"][k]).all()
            assert (t[:, 2:] == before[b][k][:, 2:]).all()
            assert not (t[:, :2] == before[b][k][:, :2]).all()


def test_int8_kv_fleet_matches_its_oracle(smoke):
    """The int8 KV cache behind the router: every stream the port engine's
    ``_run_one`` over the same cache dtype, and the reference's."""
    jcfg, jparams, tcfg, tparams = smoke
    q = dict(cache_dtype="int8")
    jr = JRouter(dataclasses.replace(jcfg, **q), jparams, slots_per_replica=2,
                 max_replicas=2, max_seq=64)
    tcfg8 = dataclasses.replace(tcfg, **q)
    tr = ReplicaRouter(tcfg8, tparams, slots_per_replica=2, max_replicas=2, max_seq=64,
                       device="cpu")
    specs = FLEET[:4]
    jreqs, treqs = _reqs(JRequest, specs, tcfg.vocab_size), _reqs(Request, specs,
                                                                   tcfg.vocab_size)
    jr.run(jreqs, now_fn=_ticking_clock())
    tr.run(treqs, now_fn=_ticking_clock())
    eng = ServeEngine(tcfg8, tparams, batch_size=1, max_seq=64, device="cpu")
    for got, want in zip(treqs, _reqs(Request, specs, tcfg.vocab_size)):
        assert got.out_tokens == eng._run_one(want).out_tokens
    assert [r.out_tokens for r in treqs] == [r.out_tokens for r in jreqs]


# --------------------------------------------------------------------------- #
# the predictor fleet
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("replicas,max_batch", [(2, 8), (3, 4)])
def test_predictor_fleet_dispatch_and_report_equal_the_references(replicas, max_batch):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(64, 8)).astype(np.float32)
    jk = JKMeans(k=5, max_iter=3).fit(JTable.from_numpy(X, num_shards=4))
    tk = from_reference("kmeans", {"centroids": np.asarray(jk.centroids)},
                        params=KMeansParameters(k=5), device="cpu")
    jf = JFleet([JPredictor(model=None, max_batch=max_batch, predict_fn=jk.predict)
                 for _ in range(replicas)])
    tf = PredictorFleet([ModelPredictor(model=None, max_batch=max_batch,
                                        predict_fn=tk.predict, device="cpu")
                         for _ in range(replicas)])
    blocks = [rng.normal(size=(int(n), 8)).astype(np.float32)
              for n in rng.integers(1, 12, size=11)]
    picks = [(tf.submit(PredictRequest(features=b)), jf.submit(JPredictRequest(features=b)))
             for b in blocks]
    assert [a for a, _ in picks] == [b for _, b in picks]
    assert tf.queued == jf.queued == len(blocks)
    got, want = tf.flush_all(), jf.flush_all()
    assert len(got) == len(want) == len(blocks) and tf.queued == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.result, np.asarray(w.result))
    t_rep, j_rep = tf.report(), jf.report()
    assert {k: t_rep[k] for k in ("replicas", "rows_served", "batches")} == \
        {k: j_rep[k] for k in ("replicas", "rows_served", "batches")}
    for t, j in zip(t_rep["per_replica"], j_rep["per_replica"]):
        assert t == {k: j[k] for k in t}
    with pytest.raises(ValueError, match="at least one"):
        PredictorFleet([])
