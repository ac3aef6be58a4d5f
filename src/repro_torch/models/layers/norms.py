"""RMSNorm / LayerNorm (counterpart: ``src/repro/models/layers/norms.py``).

The model's RMSNorm scales by ``1 + scale`` with fp32 statistics; it is
not the form of the ``rmsnorm`` kernel (kernel 5 of ROADMAP Queue 2, which
scales by ``w``), so it stays plain PyTorch, as the reference keeps it jnp.

The statistics are summed in fp64 and rounded to fp32.  PyTorch picks a
reduction's order by the tensor's shape, so an fp32 mean of the same row
can round differently in a batch of 8 and in a batch of 1; fp64 sums in
different orders round to the same fp32 value unless they straddle an fp32
rounding boundary (rare, not a guarantee), which keeps a row's result
independent of its batch — the serving engine's continuous batching
relies on that.  The reference sums in fp32; the two differ by an ulp at
most.  This is the exception to the port's fp32 rule that ROADMAP.md's
"Rules of the port" records.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.params import bias, ones_vec

__all__ = ["rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm"]


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None):
    return {"scale": ones_vec((d,), dtype, device)}


def rmsnorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.double().square().mean(dim=-1, keepdim=True).float()
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def layernorm_init(d: int, dtype=torch.bfloat16, device=None):
    return {"scale": ones_vec((d,), dtype, device),
            "bias": bias((d,), dtype, device)}


def layernorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.double().mean(dim=-1, keepdim=True).float()
    var = (xf - mu).double().square().mean(dim=-1, keepdim=True).float()
    y = (xf - mu) * (var + eps) ** -0.5
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)
