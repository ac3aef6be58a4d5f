"""Mamba-2 SSD block, state-space duality (arXiv:2405.21060) (counterpart:
``src/repro/models/layers/ssd.py``).

The layer computes a selective state-space model

    h_t = a_t ⊙ h_{t−1} + (Δ_t x_t) ⊗ B_t          a_t = exp(Δ_t · A),  A < 0
    y_t = C_t · h_t + D ⊙ x_t

with a scalar decay per head, over the expanded inner width (P = head dim,
N = state dim).  Prefill takes the chunked dual form through
``ops.ssd_chunk_scan`` (kernel 7 of ROADMAP Queue 2) with the reference's
chunk rule: ``L = min(ssd_chunk, S)``, and ``L = S`` when S is not a
multiple of it.  Decode keeps the plain O(1) recurrence, as the reference
does.  The gated norm (RMSNorm of ``y · silu(z)`` scaled by ``norm_scale``)
goes through ``ops.rmsnorm`` (kernel 5) in fp32, then back to x's dtype.

The kernel takes the (B, H, S) layout and the layer keeps the reference's
(B, S, H); the layer transposes around the call.  The projections are
plain products, as in the reference: z, x and the output in x's dtype
(bf16 ``torch.matmul`` on the served path), B, C and Δ in fp32, as the
reference asks with ``preferred_element_type``.  With a cache the layer
writes the new state and conv taps into it in place (the port's caches
are written through per-layer views) and returns it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import bias, linear, ones_vec, uniform

__all__ = ["ssd_shapes", "ssd_init", "ssd_apply", "init_ssd_cache"]


def ssd_shapes(cfg: ArchConfig) -> Dict[str, Tuple[int, ...]]:
    """Every leaf of one SSD block and its shape: the layout that
    ``ssd_init`` draws and ``weights.lm_from_reference`` checks."""
    d, di, n = cfg.d_model, cfg.d_inner_ssd, cfg.ssm_state
    h, k = cfg.ssd_heads, cfg.conv_width
    return {"wz": (d, di), "wx": (d, di), "wB": (d, n), "wC": (d, n),
            "wdt": (d, h), "dt_bias": (h,), "A_log": (h,), "D": (h,),
            "conv_x": (k, di), "conv_b": (di,), "norm_scale": (di,),
            "w_out": (di, d)}


def ssd_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, torch.Tensor]:
    s = ssd_shapes(cfg)
    dev = gen.device

    def lin(name):
        return linear(gen, s[name], fan_in=s[name][0], dtype=dtype)

    a0 = uniform(gen, s["A_log"], 1.0, 16.0)
    return {
        "wz": lin("wz"), "wx": lin("wx"), "wB": lin("wB"), "wC": lin("wC"),
        "wdt": lin("wdt"),
        "dt_bias": bias(s["dt_bias"], torch.float32, dev),
        "A_log": torch.log(a0),
        "D": ones_vec(s["D"], torch.float32, dev),
        "conv_x": lin("conv_x"),
        "conv_b": bias(s["conv_b"], dtype, dev),
        "norm_scale": ones_vec(s["norm_scale"], dtype, dev),
        "w_out": lin("w_out"),
    }


def init_ssd_cache(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, cfg.ssd_heads, cfg.ssd_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner_ssd),
                            dtype=dtype, device=device),
    }


def _proj(x: torch.Tensor, w: torch.Tensor, fp32: bool) -> torch.Tensor:
    """``x @ w``: in fp32 (the reference's ``preferred_element_type`` kept),
    or in x's dtype (the reference's fp32 result cast back to it)."""
    if fp32:
        return torch.matmul(x.float(), w.float())
    return torch.matmul(x, w.to(x.dtype))


def _causal_conv(x, w, b, state):
    K = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K)) + b
    return F.silu(y.float()).to(x.dtype), xp[:, -(K - 1):]


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(v, 0)``) in its own arithmetic;
    ``F.softplus`` switches to the identity above 20 instead."""
    return v.clamp(min=0.0) + torch.log1p(torch.exp(-v.abs()))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    return ops.rmsnorm(g, scale, eps=eps).to(y.dtype)


def ssd_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, *,
              cfg: ArchConfig, mode: str,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    Bsz, S, _ = x.shape
    H, P = cfg.ssd_heads, cfg.ssd_head_dim

    z = _proj(x, params["wz"], False)
    xin = _proj(x, params["wx"], False)
    conv_state = cache["conv"] if cache is not None else None
    xin, new_conv = _causal_conv(xin, params["conv_x"], params["conv_b"], conv_state)

    Bmat = _proj(x, params["wB"], True)                       # (B,S,N) fp32
    Cmat = _proj(x, params["wC"], True)
    dt = _softplus(_proj(x, params["wdt"], True)
                   + params["dt_bias"].float())               # (B,S,H) fp32
    A = -torch.exp(params["A_log"].float())                   # (H,) negative
    log_a = dt * A                                            # (B,S,H) ≤ 0

    xh = xin.reshape(Bsz, S, H, P).float()
    dtx = dt[..., None] * xh                                  # (B,S,H,P)
    D = params["D"].float()

    if mode == "decode":
        if cache is None:
            raise ValueError("SSD decode needs a cache")
        a = torch.exp(log_a[:, 0])                            # (B,H)
        h = cache["h"]
        h.mul_(a[..., None, None]).add_(
            torch.einsum("bhp,bn->bhpn", dtx[:, 0], Bmat[:, 0]))
        y = torch.einsum("bhpn,bn->bhp", h, Cmat[:, 0])
        y = y + D[None, :, None] * xh[:, 0]
        y = y.reshape(Bsz, 1, H * P).to(x.dtype)
        out = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
        cache["conv"].copy_(new_conv)
        return _proj(out, params["w_out"], False), cache

    # ---------------- chunked dual form ---------------- #
    L = min(cfg.ssd_chunk, S)
    if S % L != 0:
        L = S
    h0 = cache["h"] if cache is not None else None
    y, h_fin = ops.ssd_chunk_scan(log_a.transpose(1, 2), dtx.transpose(1, 2),
                                  Bmat, Cmat, h0, chunk=L)
    y = y.transpose(1, 2)                                     # (B,S,H,P)
    y = y + D[None, None, :, None] * xh
    y = y.reshape(Bsz, S, H * P).to(x.dtype)
    out = _gated_norm(y, z, params["norm_scale"], cfg.norm_eps)
    out = _proj(out, params["w_out"], False)
    if cache is None:
        return out, None
    cache["h"].copy_(h_fin)
    cache["conv"].copy_(new_conv)
    return out, cache
