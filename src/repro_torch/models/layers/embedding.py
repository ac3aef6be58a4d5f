"""Token embedding and LM head (counterpart: ``src/repro/models/layers/embedding.py``).

``logits_from`` is a plain product that the reference leaves to XLA outside
any kernel, so it is ``torch.matmul`` here.  The reference asks for an fp32
result from bf16 operands (``preferred_element_type``); ``torch.matmul`` on
bf16 returns bf16, so the product is taken in fp64 and rounded to fp32.
fp64 rather than fp32 because cuBLAS picks its summation order by the
shape, so an fp32 product of the same row would round differently in a
decode batch of 8 and of 1; fp64 sums in different orders round to the
same fp32 logit unless they straddle an fp32 rounding boundary (rare, not
a guarantee), which keeps greedy streams independent of batching.  This
is the exception to the port's fp32 rule that ROADMAP.md's "Rules of the
port" records.  The fp64 copy of the table is made once per table and
kept (1.87 GB at Qwen2-1.5B's vocabulary), not on every call.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.models.config import ArchConfig
from repro_torch.models.params import table

__all__ = ["embed_init", "embed_tokens", "logits_from"]

# table -> (its version when copied, its fp64 copy); an entry goes with its
# table, and an in-place write to the table makes a new copy
_WIDE = WeakIdKeyDictionary()


def embed_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    out = {"tok": table(gen, (cfg.vocab_size, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        out["head"] = table(gen, (cfg.d_model, cfg.vocab_size), dtype)
    return out


def embed_tokens(params: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """Token rows of the table.  The reference's learned position table
    (whisper) comes with that configuration (ROADMAP.md, Queue 1)."""
    return params["tok"][tokens.long()]


def logits_from(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V), fp32."""
    if "head" in params:
        return torch.matmul(x.double(), _wide(params["head"])).float()
    return torch.matmul(x.double(), _wide(params["tok"]).T).float()


def _wide(w: torch.Tensor) -> torch.Tensor:
    hit = _WIDE.get(w)
    if hit is None or hit[0] != w._version:
        hit = (w._version, w.detach().double())
        _WIDE[w] = hit
    return hit[1]

