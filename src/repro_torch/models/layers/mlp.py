"""Dense MLPs: SwiGLU and GELU (counterpart: ``src/repro/models/layers/mlp.py``).

The reference asks for fp32 products (``preferred_element_type``) and casts
the hidden and the output back to ``x``'s dtype; ``linear_or_quant(...,
fp32_out=True)`` keeps that for bf16 operands.  ``jax.nn.gelu`` is the tanh
approximation by default, so ``F.gelu`` takes ``approximate="tanh"``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.config import ArchConfig
from repro_torch.models.layers.quant import linear_or_quant, linear_or_quant_group
from repro_torch.models.params import linear

__all__ = ["mlp_init", "mlp_apply"]


def mlp_init(gen: torch.Generator, cfg: ArchConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {"w_gate": linear(gen, (d, f), fan_in=d, dtype=dtype),
                "w_up": linear(gen, (d, f), fan_in=d, dtype=dtype),
                "w_down": linear(gen, (f, d), fan_in=f, dtype=dtype)}
    if cfg.mlp_kind == "gelu":
        return {"w_up": linear(gen, (d, f), fan_in=d, dtype=dtype),
                "w_down": linear(gen, (f, d), fan_in=f, dtype=dtype)}
    raise ValueError(cfg.mlp_kind)


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:
        g, u = linear_or_quant_group(x, (params["w_gate"], params["w_up"]),
                                     ("bsd,df->bsf",) * 2, fp32_out=True)
        h = (F.silu(g) * u).to(x.dtype)
    else:
        h = F.gelu(linear_or_quant(x, params["w_up"], "bsd,df->bsf", fp32_out=True),
                   approximate="tanh").to(x.dtype)
    return linear_or_quant(h, params["w_down"], "bsf,fd->bsd",
                           fp32_out=True).to(x.dtype)
