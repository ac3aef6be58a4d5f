"""Token embedding and LM head (counterpart: ``src/repro/models/layers/embedding.py``).

The reference's ``logits_from`` is an einsum on bf16 operands with an fp32
result (``preferred_element_type``), which it leaves to XLA.  Here it is the
``lm_head`` kernel (``kernels/lm_head.py``): fp32 products, exact for bf16
operands, summed in fp32 in one order fixed by the model width, so a row's
logits are the same in a decode batch of 8 and of 1 and greedy streams do
not depend on batching.  (cuBLAS picks its order by the shape; the head
summed in fp64 over an fp64 copy of the table before the kernel.)  On the
CPU the kernel's plain version runs: the same product summed in fp64 and
rounded to fp32.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import table

__all__ = ["embed_init", "embed_tokens", "logits_from"]


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
    tied = "head" not in params
    w = params["tok"] if tied else params["head"]
    out = ops.lm_head(x.reshape(-1, x.shape[-1]), w, tied=tied)
    return out.reshape(*x.shape[:-1], out.shape[-1])
