"""Attention: GQA with RoPE/NoPE, global / sliding-window / chunked-local
masks, and KV-cache decode over full and ring-buffer caches (counterpart:
``src/repro/models/layers/attention.py``).

Attention itself goes through kernel 6 (ROADMAP.md, Queue 2;
``kernels/flash_attention.py``): a prefill is one ``ops.flash_attention``
call over the whole sequence, a decode step one ``ops.flash_attention_decode``
call over the cache, each with the layer's mask.  On the card both are the
hand-written CUDA kernels, on the CPU their plain versions.  The
projections go through ``linear_or_quant`` (q, k and v as one group through
``linear_or_quant_group``), so int8 weights reach the ``quant_matmul``
kernels through ``ops.quant_linear``.

Where the port differs in form:

* The reference's caches are immutable arrays that every write copies; the
  port writes into the cache tensors in place and returns the same dict.
  Callers in this package never keep an old cache, so the results agree.
* The reference's ``_sdpa`` (bf16 einsums, a softmax, the probabilities
  rounded to v's dtype) and its prefill loop over ``q_chunk`` query blocks,
  each against the key span its mask admits, are one function: the masks
  carry the spans.  The port computes it as the Pallas kernel does
  (``src/repro/kernels/flash_attention.py``): the probabilities stay fp32
  for the product with V, where the reference's layer rounds them to bf16
  for a bf16 model (identical for fp32 models).  The kernels sum each row
  in one order fixed by the head dim and a key tile of fixed width from key
  0, so a row's result is the same in a decode batch of 8 and of 1, and
  over a padded and an exact prompt: continuous batching stays
  stream-identical to the slot-at-a-time oracle, as the reference's
  invariant asks, in fp32 and with no fp64 copy of the caches.
* ``jnp.repeat`` for GQA (each kv head serves ``groups`` consecutive q
  heads) is not copied: the kernel groups the q heads by the kv head they
  read.
* The prefill masks read query and key positions 0..S-1 (the kernel's
  convention, queries at the last Sq of Sk): ``positions`` is
  ``arange(S)`` on every path the port runs, and RoPE reads it.  The tail
  prefill over a restored prefix, which offsets them, raises (below).
* ``ArchConfig.use_flash_kernel`` is not read, as in the reference: the
  kernel is the port's only attention.

Not ported in this slice, and raising ``NotImplementedError`` (ROADMAP.md,
Queue 1): the int8 KV cache (``cache_dtype="int8"``), cross-attention, and
the tail prefill over a restored prefix (``start_pos=``, the prefix cache's
``_prefill_offset``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.layers.quant import linear_or_quant, linear_or_quant_group
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.params import bias as bias_init
from repro_torch.models.params import linear

__all__ = ["attn_init", "attn_apply", "init_kv_cache"]

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
# masks of a layer kind
# --------------------------------------------------------------------------- #
def _masks(kind: BlockKind, cfg: ArchConfig) -> Dict[str, object]:
    """The kernel's mask arguments for a layer: causal as the config says,
    the sliding window on local layers, the attention chunk on chunked
    ones."""
    return {"causal": cfg.causal,
            "window": cfg.window if kind == BlockKind.ATTN_LOCAL else None,
            "chunk": cfg.attn_chunk if kind == BlockKind.ATTN_CHUNKED else None}


def _prefill_attend(q, k, v, kind: BlockKind, cfg: ArchConfig) -> torch.Tensor:
    """q: (B, S, H, hd), k/v: (B, S, KV, hd), at positions 0..S-1 → (B, S,
    H, hd).  One kernel call over the whole sequence, reading the (B, S,
    H, hd) layout through its strides."""
    hd = cfg.resolved_head_dim
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              scale=hd ** -0.5, **_masks(kind, cfg))
    return out.transpose(1, 2)


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

    q, k, v = linear_or_quant_group(x, (params["wq"], params["wk"], params["wv"]),
                                    ("bsd,dhk->bshk",) * 3)
    if "bq" in params:
        q = q + params["bq"]
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
        out = _prefill_attend(q, k, v, kind, cfg)
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
    out = ops.flash_attention_decode(q[:, 0], cache["k"], cache["v"], pos_b,
                                     scale=hd ** -0.5, **_masks(kind, cfg))
    return _out_proj(out[:, None], params), cache


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
