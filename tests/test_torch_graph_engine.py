"""The serving engine's persistent decode caches, on the CPU.

The engine keeps one decode cache for each batch size it decodes at and
reuses it from request to request (on the card it also captures the decode
step over it in a CUDA graph).  These tests hold that no state of an
earlier request leaks into a later one: after a long prompt has filled a
ring cache (Gemma3's 32-slot local layer at SMOKE widths), a global cache
(Qwen2) or an SSD state (Mamba2), a short prompt's greedy stream equals the
one a fresh engine gives, through ``run`` and through the slot-at-a-time
``_run_one``, and the two paths still agree.  Streams are compared exactly.
On the CPU the engine never captures a graph: every decode step is eager.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models.transformer import init_model
from repro_torch.serve import Request, ServeEngine

ARCHS = ("qwen2-1.5b", "gemma3-1b", "mamba2-2.7b")
MAX_SEQ = 96
LONG, SHORT = (70, 64), (5, 9)     # the long prompts wrap Gemma3's 32-slot ring


def _engine(arch):
    cfg = get_smoke(arch)
    params = init_model(torch.Generator().manual_seed(0), cfg)
    return ServeEngine(cfg, params, batch_size=2, max_seq=MAX_SEQ, device="cpu")


def _requests(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=12) for n in lens]


def _streams(reqs):
    return [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("arch", ARCHS)
def test_reused_caches_leak_nothing_into_the_next_request(arch):
    eng, fresh = _engine(arch), _engine(arch)
    cfg = eng.cfg
    eng.run(_requests(cfg, LONG, 1))
    first = _streams(eng.run(_requests(cfg, SHORT, 2)))
    second = _streams(eng.run(_requests(cfg, SHORT, 2)))
    want = _streams(fresh.run(_requests(cfg, SHORT, 2)))
    assert first == second == want

    eng._run_one(_requests(cfg, LONG[:1], 1)[0])
    solo = [eng._run_one(r).out_tokens for r in _requests(cfg, SHORT, 2)]
    again = [eng._run_one(r).out_tokens for r in _requests(cfg, SHORT, 2)]
    solo_fresh = [_engine(arch)._run_one(r).out_tokens for r in _requests(cfg, SHORT, 2)]
    assert solo == again == solo_fresh
    assert solo == want            # continuous batching equals the oracle
    assert eng.init_shared_cache() is eng.decode_cache(2)


def test_run_static_reuses_the_group_cache():
    """``_run_group`` prefills into the engine's cache of its group size;
    a second pass over the same requests gives the same streams."""
    eng = _engine("mamba2-2.7b")
    cfg = eng.cfg
    group = _requests(cfg, (40, 40), 3)
    eng.run_static(_requests(cfg, (40, 40), 4))
    got = _streams(eng.run_static(group))
    want = _streams(_engine("mamba2-2.7b").run_static(_requests(cfg, (40, 40), 3)))
    assert got == want


def test_cpu_engine_never_captures(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the CPU engine tried to capture a CUDA graph")

    for name in ("CUDAGraph", "graph", "Stream"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    eng = _engine("gemma3-1b")
    cfg = eng.cfg
    eng.warmup(prompt_lens=[5])
    eng.run(_requests(cfg, SHORT, 2))
    eng._run_one(_requests(cfg, SHORT, 2)[0])
    eng.run_static(_requests(cfg, (7, 7), 5))
    calls = eng.calls
    assert calls["decode_steps"] > 0
    assert calls["decode_graph_replays"] == 0
    assert calls["decode_eager"] == calls["decode_steps"]
    assert eng.graph_pool_bytes == 0
