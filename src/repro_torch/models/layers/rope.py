"""Rotary position embeddings (counterpart: ``src/repro/models/layers/rope.py``).

The reference pairs the two *halves* of the head dimension, element i with
element i + d/2 (its docstring says adjacent pairs; its code, which this
port follows, splits in halves).  Odd head_dim rotates the even prefix.
"""
from __future__ import annotations

import torch

__all__ = ["apply_rope"]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.
    Computed in fp32, returned in x's dtype."""
    d = x.shape[-1]
    half = d // 2
    freq = torch.arange(half, dtype=torch.float32, device=x.device)
    # torch.full, not torch.tensor: no host-to-device copy, which a CUDA
    # graph capture of the decode step would refuse
    inv = torch.pow(torch.full((), base, dtype=torch.float32, device=x.device),
                    -freq / half)                             # (half,)
    ang = positions.to(torch.float32).unsqueeze(-1) * inv     # (..., seq, half)
    cos = torch.cos(ang).unsqueeze(-2)                        # over heads
    sin = torch.sin(ang).unsqueeze(-2)
    x1 = x[..., :half].float()
    x2 = x[..., half:2 * half].float()
    parts = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
    if d % 2:
        parts.append(x[..., 2 * half:].float())
    return torch.cat(parts, dim=-1).to(x.dtype)
