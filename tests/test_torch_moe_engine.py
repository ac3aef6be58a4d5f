"""The two MoE models' serving on the port against the JAX reference, on
the CPU: ``ServeEngine``'s greedy streams against the JAX engine's (each
routing held against the reference's, ``tests/test_torch_moe.py``'s
``_RouteReplay``; the int8 codes replayed at a last-ulp tie,
``_CodeReplay``), continuous batching against the slot-at-a-time
``_run_one``, decode rows bitwise alone and in a batch of 8, and the
launcher.  The smoke configs and tolerances are ``tests/test_torch_moe.py``'s.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_smoke
from repro_torch.models.transformer import TransformerLM as TLM
from repro_torch.models.transformer import init_model as tinit
from repro_torch.serve import Request, ServeEngine
from test_torch_moe import ARCHS, route_replay  # noqa: F401
from test_torch_zoo import _smoke, replay  # noqa: F401


def _requests(cls, lens, news, seed=42):
    rng = np.random.default_rng(seed)
    return [cls(prompt=rng.integers(0, 512, size=n).astype(np.int32),
                max_new_tokens=m) for n, m in zip(lens, news)]


# 4 requests on 3 slots (one backfill); prompts and streams past Mixtral's
# window (32) and Llama4's chunk (64)
LENS, NEWS = (5, 70, 40, 66), (12, 8, 6, 10)


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_streams_equal_the_jax_engine(arch, quantize, replay, route_replay):
    jcfg, params, tcfg, tparams = _smoke(arch)
    jcfg = dataclasses.replace(jcfg, quantize=quantize)
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    jeng = JEngine(jcfg, params, batch_size=3, max_seq=128)
    teng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=128, device="cpu")
    want = jeng.run(_requests(JRequest, LENS, NEWS))
    got = teng.run(_requests(Request, LENS, NEWS))
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert not teng.ragged_ok and teng.calls["prefill_waves"] == 0
    assert teng.calls["prefills"] == len(LENS)
    assert route_replay.replays == 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batching_equals_slot_at_a_time(arch, quantize):
    _, _, tcfg, tparams = _smoke(arch)
    tcfg = dataclasses.replace(tcfg, quantize=quantize)
    eng = ServeEngine(tcfg, tparams, batch_size=3, max_seq=128, device="cpu")
    served = eng.run(_requests(Request, LENS, NEWS))
    solo = [eng._run_one(r) for r in _requests(Request, LENS, NEWS)]
    assert [r.out_tokens for r in served] == [r.out_tokens for r in solo]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_rows_equal_their_own_batch_1_steps(arch):
    """Bitwise: a decode step of 8 slots at their own positions (some past
    the window or the chunk) gives each row the logits of its own batch-1
    step: no row is dropped at 8 slots, and every sum has one order."""
    cfg = get_smoke(arch)
    params = tinit(torch.Generator().manual_seed(0), cfg)
    model = TLM(cfg, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in (3, 17, 5, 70, 9, 36, 1, 65)]
    caches, first = [], []
    for p in prompts:
        logits, cache = model.prefill(params, torch.as_tensor(p[None]),
                                      model.init_cache(1, 96))
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

    rep = main(["--engine", "lm", "--arch", arch, "--smoke", "--device", "cpu",
                "--requests", "4", "--slots", "2", "--max-new", "3"])
    assert rep["finished"] == 4 and rep["new_tokens"] == 12 and rep["arch"] == arch
