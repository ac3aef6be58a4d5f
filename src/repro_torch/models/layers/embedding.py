"""Token embedding, LM head and position tables (counterpart:
``src/repro/models/layers/embedding.py``).

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

import functools
import math
from typing import Dict, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import table

__all__ = ["embed_init", "embed_tokens", "logits_from", "sinusoidal_positions"]


def embed_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    out = {"tok": table(gen, (cfg.vocab_size, cfg.d_model), dtype)}
    if not cfg.tie_embeddings:
        out["head"] = table(gen, (cfg.d_model, cfg.vocab_size), dtype)
    if cfg.learned_pos:
        out["pos"] = table(gen, (cfg.max_seq_len, cfg.d_model), dtype)
    return out


def embed_tokens(params: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token rows of the table, plus the learned position table's rows
    (Whisper's decoder) where the params hold one and ``positions`` is
    given: (S,) positions shared by every row, or (B, S) a row's own.  A
    position outside the table raises ``ValueError``: the reference's
    ``jnp.take`` reads one past the end as NaN without a word (and a
    negative one from the end; ROADMAP.md, Queue 3), and a gather on the
    card would fault on the device."""
    x = params["tok"][tokens.long()]
    if "pos" in params and positions is not None:
        positions = torch.as_tensor(positions).long()
        rows = params["pos"].shape[0]
        if positions.numel():
            # host positions are checked on the host; a device tensor costs a sync
            lo, hi = torch.stack([positions.min(), positions.max()]).tolist()
            if not 0 <= lo <= hi < rows:
                raise ValueError(f"positions {lo}..{hi} outside the learned position "
                                 f"table's {rows} rows")
        pos = params["pos"][positions.to(x.device)]
        x = x + (pos[None] if positions.ndim == 1 else pos)
    return x


def logits_from(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V), fp32."""
    tied = "head" not in params
    w = params["tok"] if tied else params["head"]
    out = ops.lm_head(x.reshape(-1, x.shape[-1]), w, tied=tied)
    return out.reshape(*x.shape[:-1], out.shape[-1])


@functools.lru_cache(maxsize=8)
def _sinusoidal_table(seq: int, d: int) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32)[:, None]
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32)
                     / max(half - 1, 1))
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)[:, :d]


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(seq, d) sines then cosines of ``position · 10000^(−i / max(half − 1,
    1))``, the reference's formula, divisor included.  The table is computed
    on the host in fp32 and moved, so the card reads the values the CPU
    tests hold.  Its exp, sin and cos are PyTorch's and the reference's are
    XLA's; neither rounds correctly, so the two tables differ in the last
    bits (tests/test_torch_whisper.py states by how much)."""
    return _sinusoidal_table(int(seq), int(d)).to(device=device, dtype=dtype, copy=True)
