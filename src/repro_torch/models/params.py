"""Parameter construction (counterpart: ``src/repro/models/params.py``).

Every leaf is made by :func:`linear` / :func:`table` / :func:`bias` /
:func:`ones_vec` / :func:`uniform` with the reference's initialisers
(fan-in-scaled normal for weights), drawn from
an explicit :class:`torch.Generator` on the device the generator lives on.
``jax.random`` and ``torch`` give different numbers from one seed, so a
test that compares the two packages carries the reference's weights across
(:func:`repro_torch.weights.lm_from_reference`) rather than re-drawing them.

The tree is nested dicts of tensors with the reference's key names.  The
reference also returns logical sharding axes; the port has no mesh yet
(ROADMAP.md, Queue 1), so there are none.  :func:`stack_bundles` stacks
per-period trees on a leading layer axis, as the reference does for its
``lax.scan``, so weights carry across one to one.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch

__all__ = ["linear", "bias", "ones_vec", "table", "uniform", "stack_bundles"]


def _normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def _he(gen: torch.Generator, shape: Sequence[int], fan_in: int,
        dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (_normal(gen, shape) * scale).to(dtype)


def linear(gen: torch.Generator, shape: Sequence[int],
           fan_in: Optional[int] = None,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense weight with fan-in scaled normal init."""
    if fan_in is None:
        fan_in = shape[0]
    return _he(gen, shape, fan_in, dtype)


def bias(shape: Sequence[int], dtype: torch.dtype = torch.bfloat16,
         device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_vec(shape: Sequence[int], dtype: torch.dtype = torch.bfloat16,
             device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def uniform(gen: torch.Generator, shape: Sequence[int], low: float,
            high: float) -> torch.Tensor:
    """fp32 drawn uniformly from [low, high), as ``jax.random.uniform``
    (the SSD layer's decay rates)."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32) * (high - low) + low


def table(gen: torch.Generator, shape: Sequence[int],
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Embedding table: unit-variance rows scaled by 1/sqrt(d)."""
    return (_normal(gen, shape) / math.sqrt(shape[-1])).to(dtype)


def stack_bundles(trees: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-period param trees along a leading layer axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_bundles([t[k] for t in trees]) for k in first}
    return torch.stack(list(trees), dim=0)
