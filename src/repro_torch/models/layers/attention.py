"""Attention: GQA with RoPE/NoPE, global / sliding-window / chunked-local
masks, and KV-cache decode over full and ring-buffer caches (counterpart:
``src/repro/models/layers/attention.py``).

Attention itself is plain PyTorch (einsum and softmax), as the reference
computes it outside any kernel; the flash kernel is a later slice
(ROADMAP.md, Queue 2).  The projections go through ``linear_or_quant``, so
int8 weights reach the ``quant_matmul`` kernel.

Where the port differs in form:

* The reference's caches are immutable arrays that every write copies; the
  port writes into the cache tensors in place and returns the same dict.
  Callers in this package never keep an old cache, so the results agree.
* ``preferred_element_type=jnp.float32`` on bf16 operands: ``torch.einsum``
  on bf16 returns bf16.  The two products and the softmax's sum are taken
  in fp64 and rounded to fp32: cuBLAS and PyTorch's reductions pick their
  summation order by shape, so fp32 sums of the same row round differently
  in a decode batch of 8 and of 1, or over a padded and an exact prompt;
  fp64 sums of the same row differ by a few fp64 ulps from order to order,
  and round to one fp32 value unless they straddle an fp32 rounding
  boundary: rare, since that spread is some 10⁶ times smaller than an
  fp32 ulp, but not a guarantee.  That keeps continuous
  batching stream-identical to the slot-at-a-time oracle on the card, as
  the reference's invariant asks.  They differ from the reference's fp32
  sums by an ulp or so.  This is an exception to the port's fp32 rule
  (ROADMAP.md, "Rules of the port"), kept until a fixed-order attention
  kernel (kernel 6) replaces it; it costs a decode step an fp64 copy of
  every layer's K/V cache.
* ``jnp.repeat`` for GQA (each kv head serves ``groups`` consecutive q
  heads, ``repeat_interleave`` and not ``Tensor.repeat``) is not copied:
  ``_sdpa`` groups the q heads by the kv head they read instead, so the
  fp64 conversion touches the KV heads only.
* The ring-slot arithmetic ``pc - (pc - slot_ids) % slots`` needs a modulo
  with the divisor's sign: ``torch.remainder`` is that, as Python's and
  ``jnp``'s ``%`` are (C's ``%`` is not).

Not ported in this slice, and raising ``NotImplementedError`` (ROADMAP.md,
Queue 1): the int8 KV cache (``cache_dtype="int8"``), cross-attention, and
the tail prefill over a restored prefix (``start_pos=``, the prefix cache's
``_prefill_offset``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.layers.quant import linear_or_quant
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.params import bias as bias_init
from repro_torch.models.params import linear

__all__ = ["attn_init", "attn_apply", "init_kv_cache", "NEG_INF"]

NEG_INF = -2.0e38  # fp32-safe mask value

_ROADMAP = "not ported yet (ROADMAP.md, Queue 1)"


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, cross: bool = False):
    if cross:
        raise NotImplementedError(f"cross-attention is {_ROADMAP}")
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    out = {
        "wq": linear(gen, (d, h, hd), fan_in=d, dtype=dtype),
        "wk": linear(gen, (d, kv, hd), fan_in=d, dtype=dtype),
        "wv": linear(gen, (d, kv, hd), fan_in=d, dtype=dtype),
        "wo": linear(gen, (h, hd, d), fan_in=h * hd, dtype=dtype),
    }
    if cfg.qkv_bias:
        dev = gen.device
        out["bq"] = bias_init((h, hd), dtype, dev)
        out["bk"] = bias_init((kv, hd), dtype, dev)
        out["bv"] = bias_init((kv, hd), dtype, dev)
    return out


# --------------------------------------------------------------------------- #
# kv cache
# --------------------------------------------------------------------------- #
def init_kv_cache(cfg: ArchConfig, kind: BlockKind, batch: int, max_seq: int,
                  dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    """Cache for ONE attention layer.  Local/chunked layers keep a ring of
    ``window``/``attn_chunk`` slots; global layers keep ``max_seq``."""
    if cfg.cache_dtype == "int8":
        raise NotImplementedError(f"the int8 KV cache is {_ROADMAP}")
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if kind == BlockKind.ATTN_LOCAL:
        slots = min(cfg.window, max_seq)
    elif kind == BlockKind.ATTN_CHUNKED:
        slots = min(cfg.attn_chunk, max_seq)
    else:
        slots = max_seq
    return {"k": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device)}


def _cache_write(cache: Dict[str, torch.Tensor], slot: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Write one token (B, kv, hd) at ring slot ``slot``, in place — a
    scalar (all batch rows share the position) or a (B,) vector
    (continuous-batching decode, where every slot sits at its own
    position)."""
    slot = torch.as_tensor(slot, device=k_new.device)
    if slot.ndim == 0:
        idx = (slice(None), slot.long())
    else:
        idx = (torch.arange(k_new.shape[0], device=k_new.device), slot.long())
    cache["k"][idx] = k_new.to(cache["k"].dtype)
    cache["v"][idx] = v_new.to(cache["v"].dtype)
    return cache


# --------------------------------------------------------------------------- #
# core attention math
# --------------------------------------------------------------------------- #
def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, Sq, H, hd)  k/v: (B, Sk, KV, hd)  mask: (B|1, 1, Sq, Sk) bool.
    GQA without copying K/V: q is grouped as (B, Sq, KV, H/KV, hd), each kv
    head against the H/KV consecutive q heads it serves (the reference's
    ``jnp.repeat``).  fp32 logits and probabilities (summed in fp64, see
    the module note); the probabilities are rounded to v's dtype before the
    second product, as in the reference."""
    B, Sq, H, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(B, Sq, kv, H // kv, hd).double()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.double()).float() * scale
    logits = torch.where(mask[:, :, None], logits,
                         torch.full((), NEG_INF, device=logits.device))
    probs = torch.softmax(logits.double(), dim=-1).float()
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype).double(), v.double())
    return out.float().to(q.dtype).reshape(B, Sq, H, hd)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# --------------------------------------------------------------------------- #
# prefill / train forward
# --------------------------------------------------------------------------- #
def _mask_for(pq: torch.Tensor, pk: torch.Tensor, kind: BlockKind,
              cfg: ArchConfig) -> torch.Tensor:
    if cfg.causal:
        m = pk[None, :] <= pq[:, None]
    else:
        m = torch.ones((pq.shape[0], pk.shape[0]), dtype=torch.bool, device=pq.device)
    if kind == BlockKind.ATTN_LOCAL:
        m = m & (pq[:, None] - pk[None, :] < cfg.window)
    elif kind == BlockKind.ATTN_CHUNKED:
        m = m & (torch.div(pq[:, None], cfg.attn_chunk, rounding_mode="floor")
                 == torch.div(pk[None, :], cfg.attn_chunk, rounding_mode="floor"))
    return m[None, None]  # (1, 1, Sq, Sk)


def _prefill_attend(q, k, v, kind: BlockKind, cfg: ArchConfig,
                    positions: torch.Tensor) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, S, KV, hd).
    positions: (S,) absolute positions (shared across the batch).  Queries
    go in ``q_chunk`` blocks, each against the key span its mask admits, as
    the reference's ``lax.scan`` does."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5
    C = min(cfg.q_chunk, S)
    if S % C != 0:
        C = S  # single block, as the reference falls back
    n_chunks = S // C
    if n_chunks == 1:
        return _sdpa(q, k, v, _mask_for(positions, positions, kind, cfg), scale)

    if kind == BlockKind.ATTN_LOCAL:
        span = C + _round_up(cfg.window, C)
    elif kind == BlockKind.ATTN_CHUNKED:
        span = max(cfg.attn_chunk, C)
    else:
        span = S
    outs = []
    for i in range(n_chunks):
        q_start = i * C
        qi = q[:, q_start:q_start + C]
        pos_q = positions[q_start:q_start + C]
        if span >= S:
            ki, vi, pos_k = k, v, positions
        else:
            if kind == BlockKind.ATTN_CHUNKED:
                start = (q_start // cfg.attn_chunk) * cfg.attn_chunk
            else:
                start = q_start + C - span
            start = min(max(start, 0), S - span)
            ki, vi = k[:, start:start + span], v[:, start:start + span]
            pos_k = positions[start:start + span]
        outs.append(_sdpa(qi, ki, vi, _mask_for(pos_q, pos_k, kind, cfg), scale))
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------- #
# public apply
# --------------------------------------------------------------------------- #
def attn_apply(
    params: Dict[str, torch.Tensor],
    x: torch.Tensor,
    *,
    cfg: ArchConfig,
    kind: BlockKind,
    mode: str,                                  # "prefill" | "decode"
    positions: Optional[torch.Tensor] = None,   # (S,) prefill positions
    pos: Optional[torch.Tensor] = None,         # scalar or (B,) decode position
    cache: Optional[Dict[str, torch.Tensor]] = None,
    kv_src: Optional[torch.Tensor] = None,      # cross-attention source
    is_cross: bool = False,
    use_rope: bool = True,
    lengths: Optional[torch.Tensor] = None,     # (B,) ragged prefill lengths
    start_pos: Optional[torch.Tensor] = None,   # (B,) tail-prefill offsets
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (output (B,S,D), updated cache or None)."""
    if is_cross or kv_src is not None:
        raise NotImplementedError(f"cross-attention is {_ROADMAP}")
    if start_pos is not None:
        raise NotImplementedError(
            f"the tail prefill over a restored prefix (start_pos=, used by "
            f"serve/prefix_cache.py) is {_ROADMAP}")
    B, S, D = x.shape
    hd = cfg.resolved_head_dim
    rope_on = use_rope and kind != BlockKind.ATTN_NOPE

    q = linear_or_quant(x, params["wq"], "bsd,dhk->bshk")
    if "bq" in params:
        q = q + params["bq"]
    k = linear_or_quant(x, params["wk"], "bsd,dhk->bshk")
    v = linear_or_quant(x, params["wv"], "bsd,dhk->bshk")
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]

    if mode == "prefill":
        pos_q = positions if positions is not None else torch.arange(S, device=x.device)
        if rope_on:
            q = apply_rope(q, pos_q[None, :], cfg.rope_base)
            k = apply_rope(k, pos_q[None, :], cfg.rope_base)
        if cache is not None:
            # write the (possibly windowed) tail of K/V into the cache for
            # the decode steps that follow
            cache = _prefill_fill_cache(cache, k, v, lengths)
        out = _prefill_attend(q, k, v, kind, cfg, pos_q)
        return _out_proj(out, params), cache

    # ---------------- decode: S == 1, attend to the cache ---------------- #
    if mode != "decode" or cache is None or pos is None:
        raise ValueError("decode needs mode='decode', cache= and pos=")
    pos = torch.as_tensor(pos, device=x.device).long()
    per_slot = pos.ndim == 1
    pos_b = pos if per_slot else pos.expand(B)                 # (B,)
    if rope_on:
        q = apply_rope(q, pos_b[:, None], cfg.rope_base)
        k = apply_rope(k, pos_b[:, None], cfg.rope_base)
    slots = cache["k"].shape[1]
    cache = _cache_write(cache, torch.remainder(pos_b if per_slot else pos, slots),
                         k[:, 0], v[:, 0])
    kc, vc = cache["k"], cache["v"]
    slot_ids = torch.arange(slots, device=x.device)
    # most recent position ≡ slot (mod slots) that is ≤ pos, per row
    pc = pos_b[:, None]                                        # (B, 1)
    slot_pos = pc - torch.remainder(pc - slot_ids[None, :], slots)   # (B, slots)
    valid = slot_pos >= 0
    if kind == BlockKind.ATTN_LOCAL:
        valid &= slot_pos > pc - cfg.window
    elif kind == BlockKind.ATTN_CHUNKED:
        valid &= (torch.div(slot_pos, cfg.attn_chunk, rounding_mode="floor")
                  == torch.div(pc, cfg.attn_chunk, rounding_mode="floor"))
    else:
        valid &= slot_pos <= pc
    mask = valid[:, None, None, :]
    out = _sdpa(q, kc, vc, mask, hd ** -0.5)
    return _out_proj(out, params), cache


def _prefill_fill_cache(cache, k, v, lengths=None):
    """Copy the last ``slots`` tokens of prefill K/V into the decode cache,
    in place, laid out so ring addressing (slot = pos % slots) stays
    consistent.

    ``lengths=None`` is the equal-length path.  With ``lengths`` (B,), the
    prompts are right-padded to a common S and row b's real tokens occupy
    columns 0..lengths[b]-1: each row keeps its last ``min(lengths[b],
    slots)`` real columns, and pad or evicted columns are dropped (the
    reference routes them to an out-of-range destination that its scatter
    drops; the port selects the kept columns), so pad tokens never enter the
    cache."""
    B, S = k.shape[0], k.shape[1]
    slots = cache["k"].shape[1]
    if lengths is None:
        take = min(S, slots)
        pos0 = S - take
        dest = torch.remainder(pos0 + torch.arange(take, device=k.device), slots)
        cache["k"][:, dest] = k[:, S - take:].to(cache["k"].dtype)
        cache["v"][:, dest] = v[:, S - take:].to(cache["v"].dtype)
        return cache
    L = torch.as_tensor(lengths, device=k.device).long()[:, None]   # (B, 1)
    j = torch.arange(S, device=k.device)[None, :]                   # (1, S)
    keep = (j < L) & (j >= L - slots)   # the last ≤ slots real columns per row
    bi, ji = keep.nonzero(as_tuple=True)
    dest = torch.remainder(ji, slots)
    cache["k"][bi, dest] = k[bi, ji].to(cache["k"].dtype)
    cache["v"][bi, dest] = v[bi, ji].to(cache["v"].dtype)
    return cache


def _out_proj(out: torch.Tensor, params) -> torch.Tensor:
    return linear_or_quant(out, params["wo"], "bshk,hkd->bsd")
