"""Mamba-2 SSD block, state-space duality (arXiv:2405.21060) (counterpart:
``src/repro/models/layers/ssd.py``).

The layer computes a selective state-space model

    h_t = a_t ⊙ h_{t−1} + (Δ_t x_t) ⊗ B_t          a_t = exp(Δ_t · A),  A < 0
    y_t = C_t · h_t + D ⊙ x_t

with a scalar decay per head, over the expanded inner width (P = head dim,
N = state dim).  The projections give z, x and the output in x's dtype and
B, C and Δ in fp32, as the reference asks with ``preferred_element_type``.

Prefill takes the chunked dual form through ``ops.ssd_chunk_scan`` (kernel
7 of ROADMAP Queue 2) with the reference's chunk rule: ``L = min(ssd_chunk,
S)``, and ``L = S`` when S is not a multiple of it.  The kernel takes the
(B, H, S) layout and the layer keeps the reference's (B, S, H); the layer
transposes around the call.  Its projections are plain ``torch.matmul``
products, as the reference's are einsums, and the gated norm (RMSNorm of
``y · silu(z)`` scaled by ``norm_scale``) goes through ``ops.rmsnorm``
(kernel 5) in fp32, then back to x's dtype.

Decode keeps the O(1) recurrence, as the reference does, in three launches
that each sum in an order fixed by the widths, never by the batch, so a
slot's step is bitwise the same in a batch of 8 and of 1:
``ops.fixed_linear`` for the five in-projections z, x, B, C and Δ (with the
block's RMSNorm folded in when the block hands over a ``PreNorm``);
``ops.ssd_decode`` for the state update (h in place), y = C·h + D·x and the
gated norm's gate y·silu(z) in fp32; and ``ops.fixed_linear`` for the
out-projection, whose prologue takes the gate's RMSNorm and the cast to x's
dtype, so the gated norm is ``_gated_norm``'s function with no launch of
its own.  The causal conv's taps stay PyTorch passes.  With a cache the layer
writes the new state and conv taps into it in place (the port's caches are
written through per-layer views) and returns it.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import softplus
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers.norms import PreNorm
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


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    g = y.float() * F.silu(z.float())
    return ops.rmsnorm(g, scale, eps=eps).to(y.dtype)


def _decode(params: Dict[str, torch.Tensor], x, cfg: ArchConfig,
            cache: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One decode step: x (B, 1, D), or a ``PreNorm`` of it → (B, 1, D)."""
    xt, kw = (x.x, {"norm": x.norm}) if isinstance(x, PreNorm) else (x, {})
    Bsz, dtype = xt.shape[0], xt.dtype
    H, P = cfg.ssd_heads, cfg.ssd_head_dim
    f32 = torch.float32
    z, xin, Bm, Cm, dt_raw = ops.fixed_linear(
        xt.reshape(Bsz, -1),
        [params[k].to(dtype) for k in ("wz", "wx", "wB", "wC", "wdt")],
        [dtype, dtype, f32, f32, f32], **kw)
    xin, new_conv = _causal_conv(xin[:, None], params["conv_x"], params["conv_b"],
                                 cache["conv"])
    gate = ops.ssd_decode(cache["h"], dt_raw, xin.reshape(Bsz, H, P), Bm, Cm,
                          params["dt_bias"], params["A_log"], params["D"],
                          z=z.reshape(Bsz, H, P))
    (out,) = ops.fixed_linear(gate.reshape(Bsz, H * P), [params["w_out"].to(dtype)], [dtype],
                              norm=(params["norm_scale"], cfg.norm_eps, False))
    cache["conv"].copy_(new_conv)
    return out[:, None]


def ssd_apply(params: Dict[str, torch.Tensor], x, *,
              cfg: ArchConfig, mode: str,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """The SSD block on x (B, S, D) (at a decode step x may be a
    ``PreNorm``) → (out (B, S, D), the cache or None)."""
    if mode == "decode":
        if cache is None:
            raise ValueError("SSD decode needs a cache")
        return _decode(params, x, cfg, cache), cache
    Bsz, S, _ = x.shape
    H, P = cfg.ssd_heads, cfg.ssd_head_dim

    z = _proj(x, params["wz"], False)
    xin = _proj(x, params["wx"], False)
    conv_state = cache["conv"] if cache is not None else None
    xin, new_conv = _causal_conv(xin, params["conv_x"], params["conv_b"], conv_state)

    Bmat = _proj(x, params["wB"], True)                       # (B,S,N) fp32
    Cmat = _proj(x, params["wC"], True)
    dt = softplus(_proj(x, params["wdt"], True)
                  + params["dt_bias"].float())                # (B,S,H) fp32
    A = -torch.exp(params["A_log"].float())                   # (H,) negative
    log_a = dt * A                                            # (B,S,H) ≤ 0

    xh = xin.reshape(Bsz, S, H, P).float()
    dtx = dt[..., None] * xh                                  # (B,S,H,P)
    D = params["D"].float()

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
