"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427)
(counterpart: ``src/repro/models/layers/rglru.py``).

The Griffin recurrent block is:

    x ─ norm ─┬─ linear → GeLU ────────────────────────┐
              └─ linear → conv1d(4) → RG-LRU ──────────┴─ ⊙ ─ linear → out

RG-LRU recurrence (per channel):
    r_t = σ(W_a x_t + b_a)                  (recurrence gate)
    i_t = σ(W_x x_t + b_x)                  (input gate)
    a_t = a^(c·r_t)        a = σ(Λ) ∈ (0,1)  (learned decay, c = 8)
    h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)

The functions are the reference's, with its dtypes: the two branches and
the out-projection are products with an fp32 result cast to x's dtype
(``jax.nn.gelu`` is the tanh form, so ``F.gelu(approximate="tanh")``); the
gates are fp32 products of the conv output widened to fp32 with ``w_a`` and
``w_i`` widened to fp32, ``log_a = −8·σ(·)·softplus(Λ)`` and
``√max(1 − a², 1e-12)``.  The conv output is in x's dtype, so its widening
is exact, and the gates' products take it as it is: a bf16 row against bf16
weights with fp32 sums is the same function (every product of two bf16
values is exact in fp32), with no fp32 copy of either.

Every product goes through ``linear_or_quant``, hence ``ops.fixed_linear``
(the plain weights stay in the model's dtype under ``quantize="int8"``, as
in the reference): one fp32 order fixed by K, the same bits at a prefill
(the tiled form) and a decode step (the decode form, the block's RMSNorm
folded into the branches' launch), whatever the batch.  A decode step is
three launches: the two branches, the two gates, the out-projection.

Prefill takes the recurrence through ``ops.rglru_scan`` (a CUDA kernel on
the card): a multiply then an add a step in time order, the arithmetic of a
decode step, where the reference takes ``jax.lax.associative_scan`` (within
fp32 rounding of it).  So a prefilled state is bitwise the state the decode
steps would reach.  The causal conv's taps stay PyTorch passes (a copy of
``ssd.py``'s ``_causal_conv`` without its SiLU, as the reference's block has
none).  With a cache the layer writes the new ``h`` and conv taps into it in
place and returns it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import softplus
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers.quant import linear_or_quant, linear_or_quant_group
from repro_torch.models.params import bias, linear, uniform

__all__ = ["rglru_shapes", "rglru_init", "rglru_apply", "init_rglru_cache"]

_C = 8.0  # Griffin's fixed exponent scale


def rglru_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf of one RG-LRU block and its shape: the layout that
    ``rglru_init`` draws and ``weights.lm_from_reference`` checks."""
    d, r, k = cfg.d_model, cfg.rnn_width or cfg.d_model, cfg.conv_width
    return {"w_gate_branch": (d, r), "w_rec_branch": (d, r), "conv_w": (k, r),
            "conv_b": (r,), "w_a": (r, r), "b_a": (r,), "w_i": (r, r), "b_i": (r,),
            "lam": (r,), "w_out": (r, d)}


def rglru_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, torch.Tensor]:
    s = rglru_shapes(cfg)
    dev = gen.device

    def lin(name):
        return linear(gen, s[name], fan_in=s[name][0], dtype=dtype)

    # Λ so that a = σ(Λ)^c spreads decay rates in (0.9, 0.999)
    u = uniform(gen, s["lam"], 0.9, 0.999)
    lam = torch.log((u ** (1.0 / _C)) / (1.0 - u ** (1.0 / _C)))
    return {
        "w_gate_branch": lin("w_gate_branch"), "w_rec_branch": lin("w_rec_branch"),
        "conv_w": lin("conv_w"), "conv_b": bias(s["conv_b"], dtype, dev),
        "w_a": lin("w_a"), "b_a": bias(s["b_a"], torch.float32, dev),
        "w_i": lin("w_i"), "b_i": bias(s["b_i"], torch.float32, dev),
        "lam": lam, "w_out": lin("w_out"),
    }


def init_rglru_cache(cfg: ArchConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    r = cfg.rnn_width or cfg.d_model
    return {"h": torch.zeros((batch, r), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, r), dtype=dtype, device=device)}


def _causal_conv(x, w, b, state):
    """Depthwise causal conv1d.  x: (B, S, r), w: (K, r).  Returns (y,
    new_state)."""
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    return y.to(x.dtype), xp[:, -(K - 1):]


def _rglru_gates(params, xr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log_a, gated input) in fp32 of the conv output xr (..., r)."""
    ra, ri = linear_or_quant_group(xr, (params["w_a"], params["w_i"]),
                                   ("bsr,rq->bsq",) * 2, fp32_out=True)
    r_gate = torch.sigmoid(ra + params["b_a"])
    i_gate = torch.sigmoid(ri + params["b_i"])
    log_a = -_C * r_gate * softplus(params["lam"])            # log a_t ≤ 0
    a2 = torch.exp(2.0 * log_a)
    xf = xr.float()
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * (i_gate * xf)
    return log_a, gated


def rglru_apply(params: Dict[str, torch.Tensor], x, *, cfg: ArchConfig, mode: str,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, S, D) (at a decode step a ``PreNorm`` of it) → (out (B, S, D),
    the cache or None)."""
    dtype = x.dtype
    g, xr = linear_or_quant_group(x, (params["w_gate_branch"], params["w_rec_branch"]),
                                  ("bsd,dr->bsr",) * 2, fp32_out=True)
    gate_branch = F.gelu(g, approximate="tanh").to(dtype)
    xr = xr.to(dtype)

    conv_state = cache["conv"] if cache is not None else None
    xr, new_conv = _causal_conv(xr, params["conv_w"], params["conv_b"], conv_state)
    log_a, gated = _rglru_gates(params, xr)

    if mode == "decode":
        if cache is None:
            raise ValueError("RG-LRU decode needs a cache")
        h = cache["h"] * torch.exp(log_a[:, 0]) + gated[:, 0]   # (B, r)
        hs = h[:, None, :]
        cache["h"].copy_(h)
    else:
        h0 = cache["h"] if cache is not None else None
        hs, h_last = ops.rglru_scan(torch.exp(log_a), gated, h0)
        if cache is not None:
            cache["h"].copy_(h_last)
    if cache is not None:
        cache["conv"].copy_(new_conv)

    out = hs.to(dtype) * gate_branch
    return linear_or_quant(out, params["w_out"], "bsr,rd->bsd"), cache

