"""Continuous batching's invariant on the CPU, through the port alone: a
decode step's logits for one slot do not depend on the other slots.

Eight prompts of different lengths are prefilled one request at a time
into batch-1 caches; the caches are stacked, and one
``TransformerLM.decode_step`` runs the 8 slots at once, each at its own
position.  Each row's logits must be *bitwise* equal to ``decode_step`` on
that row's own batch-1 cache, for Mamba2-2.7B's and Qwen2-1.5B's SMOKE
configurations (``quantize="none"``: plain weights, whose decode products go
through ``ops.fixed_linear``; the SSD state through ``ops.ssd_decode``).
The serving engine relies on this to give the slot-at-a-time oracle's
greedy streams (``ServeEngine._run_one``); a product whose summation order
depends on the batch breaks it.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.models.transformer import TransformerLM, init_model

SLOTS, MAX_SEQ = 8, 64


def _stack(trees):
    """Batch-1 caches stacked into one batch (the batch axis follows the
    stacked layer axis)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.cat(trees, dim=1)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen2-1.5b"])
def test_decode_rows_equal_their_own_batch_1_steps(arch):
    cfg = get_smoke(arch)
    assert cfg.quantize == "none"
    params = init_model(torch.Generator().manual_seed(0), cfg)
    model = TransformerLM(cfg, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (3, 17, 5, 40, 9, 26, 1, 33)]
    caches, first = [], []
    for p in prompts:
        logits, cache = model.prefill(params, torch.as_tensor(p[None]),
                                      model.init_cache(1, MAX_SEQ))
        caches.append(cache)
        first.append(int(logits[0, -1].argmax()))
    tokens = torch.tensor(first)[:, None]
    pos = torch.tensor([len(p) for p in prompts])
    batched, _ = model.decode_step(params, tokens, pos, _stack(caches))
    assert batched.shape == (SLOTS, 1, cfg.vocab_size)
    same = [torch.equal(model.decode_step(params, tokens[i:i + 1], pos[i:i + 1],
                                          caches[i])[0][0], batched[i])
            for i in range(SLOTS)]
    assert all(same), f"rows whose logits differ from their batch-1 step: " \
                      f"{[i for i, s in enumerate(same) if not s]}"


def test_prefill_wave_rows_equal_their_own_prefills():
    """A ragged prefill wave (several prompts, right-padded, as the engine
    admits them) gives each prompt's next-token logits bitwise equal to its
    own batch-1 prefill: the wave's projections sum each row as the lone
    prompt's do (``fixed_linear`` at every row count)."""
    cfg = get_smoke("qwen2-1.5b")
    params = init_model(torch.Generator().manual_seed(1), cfg)
    model = TransformerLM(cfg, device="cpu")
    rng = np.random.default_rng(12)
    lengths = [21, 4, 33, 12]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    tokens = torch.zeros((len(prompts), max(lengths)), dtype=torch.long)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.as_tensor(p)
    wave, _ = model.prefill_ragged(params, tokens, torch.tensor(lengths),
                                   model.init_cache(len(prompts), MAX_SEQ))
    for i, p in enumerate(prompts):
        alone, _ = model.prefill(params, torch.as_tensor(p[None]), model.init_cache(1, MAX_SEQ))
        assert torch.equal(alone[0], wave[i]), f"prompt {i} ({len(p)} tokens)"
