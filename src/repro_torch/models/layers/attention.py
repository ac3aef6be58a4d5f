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
  prefill over a restored prefix (``start_pos=``, the prefix cache's
  ``_prefill_offset``) offsets row b's to ``start_pos[b] + j`` and runs
  through kernel 6's tail form, ``ops.flash_attention_tail``: its keys are
  the ring cache's slots below ``start_pos[b]`` (read before the tail is
  written, as the reference reads them) and the tail's own, laid out by
  position from 0 as a full prefill's are, so each row is the full
  prefill's row at its position, bitwise.  A ``start_pos == 0`` row reads
  no prefix slot.
* ``ArchConfig.use_flash_kernel`` is not read, as in the reference: the
  kernel is the port's only attention.

* Cross-attention (``kv_src=``, ``is_cross=True``: Whisper's decoder over
  the encoder's output) has no mask.  At a prefill q comes from x and K/V
  from ``kv_src``, one ``ops.flash_attention`` call with ``causal=False``
  over all Se keys, and the cross cache ``{"k", "v"}`` (B, Se, KV, hd) is
  written in place.  At a decode step K/V are read from that cache and
  nothing is projected: one ``ops.flash_attention_decode`` call with every
  row at position Se − 1, where the decode form's ring admits exactly slots
  0..Se − 1 (slot s holds position s), summed in its span order from slot
  0.  A prefill without ``kv_src`` raises ``ValueError`` (the reference
  fails there too, projecting None).

* The int8 KV cache (``cache_dtype="int8"``): ``k``/``v`` int8 (B, slots,
  KV, hd) and ``k_scale``/``v_scale`` fp32 (B, slots, KV), as the
  reference's.  Every write quantizes through the ``quantize_rows`` kernel
  over hd (the reference's ``_quantize``: max|x|/127 + 1e-8, round half to
  even), one launch for K and one for V: 2 launches a layer at a decode
  step and 2 at a prefill wave.  A prefill attends the raw K/V; a decode
  step reads the codes through ``ops.flash_attention_decode(k_scale=,
  v_scale=)``, kernel 6's int8 route, which dequantizes each code to
  ``_cache_read``'s bf16 value.  A tail prefill reads an int8 prefix as
  ``_cache_read`` gives it, cast to the model's dtype (the engine refuses
  the prefix cache over an int8 cache, as the reference's does).
  Cross-attention caches stay in the model's dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import cache_read
from repro_torch.models.config import ArchConfig, BlockKind
from repro_torch.models.layers.quant import linear_or_quant, linear_or_quant_group
from repro_torch.models.layers.rope import apply_rope
from repro_torch.models.params import bias as bias_init
from repro_torch.models.params import linear

__all__ = ["attn_init", "attn_apply", "init_kv_cache"]


# --------------------------------------------------------------------------- #
# params
# --------------------------------------------------------------------------- #
def attn_init(gen: torch.Generator, cfg: ArchConfig, dtype, cross: bool = False):
    """A layer's projections; a cross-attention layer's (``cross=True``)
    have the same shapes, as in the reference."""
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
    ``window``/``attn_chunk`` slots; global layers keep ``max_seq``.  With
    ``cfg.cache_dtype == "int8"`` the K/V are int8 codes with an fp32
    scale a (slot, kv head)."""
    kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if kind == BlockKind.ATTN_LOCAL:
        slots = min(cfg.window, max_seq)
    elif kind == BlockKind.ATTN_CHUNKED:
        slots = min(cfg.attn_chunk, max_seq)
    else:
        slots = max_seq
    if cfg.cache_dtype == "int8":
        return {"k": torch.zeros((batch, slots, kv, hd), dtype=torch.int8, device=device),
                "v": torch.zeros((batch, slots, kv, hd), dtype=torch.int8, device=device),
                "k_scale": torch.zeros((batch, slots, kv), dtype=torch.float32, device=device),
                "v_scale": torch.zeros((batch, slots, kv), dtype=torch.float32, device=device)}
    return {"k": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device),
            "v": torch.zeros((batch, slots, kv, hd), dtype=dtype, device=device)}


def _cache_put(cache: Dict[str, torch.Tensor], idx, k_new: torch.Tensor,
               v_new: torch.Tensor, sel=None) -> None:
    """Write K/V rows (…, kv, hd) at ``idx`` of the cache, in place: the
    rows ``sel`` picks (all where None), as they are, or quantized over hd
    by the ``quantize_rows`` kernel into an int8 cache's codes and scales:
    all the rows in one launch for K and one for V, then picked, as the
    reference quantizes before its scatter drops."""
    pick = (lambda t: t) if sel is None else (lambda t: t[sel])
    if "k_scale" in cache:
        for name, x in (("k", k_new), ("v", v_new)):
            xq, xs = ops.quantize_rows(x)
            cache[name][idx] = pick(xq)
            cache[f"{name}_scale"][idx] = pick(xs)
    else:
        cache["k"][idx] = pick(k_new).to(cache["k"].dtype)
        cache["v"][idx] = pick(v_new).to(cache["v"].dtype)


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
    _cache_put(cache, idx, k_new, v_new)
    return cache


def _cache_scales(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The decode kernel's scale arguments for an int8 cache (none else)."""
    if "k_scale" not in cache:
        return {}
    return {"k_scale": cache["k_scale"], "v_scale": cache["v_scale"]}


def _cache_read(cache: Dict[str, torch.Tensor], dtype: torch.dtype):
    """The cache's K/V in ``dtype``: an int8 cache as the reference's
    ``_cache_read`` gives it (bf16), cast."""
    if "k_scale" not in cache:
        return cache["k"], cache["v"]
    return (cache_read(cache["k"], cache["k_scale"]).to(dtype),
            cache_read(cache["v"], cache["v_scale"]).to(dtype))


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
        return _cross_apply(params, x, cfg=cfg, kind=kind, mode=mode, positions=positions,
                            pos=pos, cache=cache, kv_src=kv_src, use_rope=use_rope)
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

    if mode == "prefill" and start_pos is not None:
        out, cache = _prefill_offset(q, k, v, cfg=cfg, kind=kind, cache=cache,
                                     lengths=lengths, start_pos=start_pos, rope_on=rope_on)
        return _out_proj(out, params), cache
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
                                     scale=hd ** -0.5, **_masks(kind, cfg),
                                     **_cache_scales(cache))
    return _out_proj(out[:, None], params), cache


def _prefill_offset(q, k, v, *, cfg: ArchConfig, kind: BlockKind, cache, lengths,
                    start_pos, rope_on: bool):
    """The tail prefill: row b's tokens are its prompt's tail at positions
    ``start_pos[b] .. start_pos[b] + lengths[b] − 1``, over a cache whose
    ring already holds the prefix K/V (restored by
    ``serve/prefix_cache.py``).  One ``ops.flash_attention_tail`` call
    reads the prefix from the cache before the tail's K/V are written into
    it.  Returns (attention output (B, S, H, hd), cache)."""
    if cache is None or lengths is None:
        raise ValueError("start_pos= prefill needs cache= and lengths=")
    S = q.shape[1]
    hd = cfg.resolved_head_dim
    start = torch.as_tensor(start_pos, device=q.device).long()
    L = torch.as_tensor(lengths, device=q.device).long()
    if rope_on:
        pos_bq = start[:, None] + torch.arange(S, device=q.device)[None, :]
        q = apply_rope(q, pos_bq, cfg.rope_base)
        k = apply_rope(k, pos_bq, cfg.rope_base)
    kc, vc = _cache_read(cache, k.dtype)
    out = ops.flash_attention_tail(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                   kc, vc, start, L, scale=hd ** -0.5, **_masks(kind, cfg))
    cache = _prefill_fill_cache(cache, k, v, L, start=start)
    return out.transpose(1, 2), cache


def _cross_apply(params, x, *, cfg: ArchConfig, kind: BlockKind, mode: str, positions,
                 pos, cache, kv_src, use_rope: bool):
    """Cross-attention of x over ``kv_src`` (prefill) or over the cross
    cache (decode); RoPE on q alone where ``use_rope`` asks for it, as in
    the reference (its decoders pass ``use_rope=False``)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    rope_on = use_rope and kind != BlockKind.ATTN_NOPE
    q = linear_or_quant(x, params["wq"], "bsd,dhk->bshk")
    if "bq" in params:
        q = q + params["bq"]
    if mode == "decode":
        if cache is None:
            raise ValueError("a cross-attention decode step reads the cross cache: cache=")
        k, v = cache["k"], cache["v"]
        Se = k.shape[1]
        if rope_on:
            pos_b = torch.as_tensor(pos, device=x.device).long().expand(B)
            q = apply_rope(q, pos_b[:, None], cfg.rope_base)
        # every row at position Se - 1: the ring admits slots 0..Se-1, all of them
        at = torch.full((B,), Se - 1, dtype=torch.long, device=x.device)
        out = ops.flash_attention_decode(q[:, 0], k, v, at, scale=hd ** -0.5, causal=False)
        return _out_proj(out[:, None], params), cache
    if mode != "prefill":
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    if kv_src is None:
        raise ValueError("a cross-attention prefill projects the encoder's output "
                         "(kv_src=, the model's encoder_frames=); none was given")
    k, v = linear_or_quant_group(kv_src, (params["wk"], params["wv"]), ("bsd,dhk->bshk",) * 2)
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    if rope_on:
        pos_q = positions if positions is not None else torch.arange(S, device=x.device)
        q = apply_rope(q, pos_q[None, :], cfg.rope_base)
    if cache is not None:
        if cache["k"].shape != k.shape:
            raise ValueError(f"cross cache {tuple(cache['k'].shape)} does not hold the "
                             f"encoder's K/V {tuple(k.shape)}")
        cache["k"].copy_(k)
        cache["v"].copy_(v)
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              scale=hd ** -0.5, causal=False)
    return _out_proj(out.transpose(1, 2), params), cache


def _prefill_fill_cache(cache, k, v, lengths=None, start=None):
    """Copy the last ``slots`` tokens of prefill K/V into the decode cache,
    in place, laid out so ring addressing (slot = pos % slots) stays
    consistent; an int8 cache takes them quantized (``_cache_put``: K and
    V in one ``quantize_rows`` launch each).

    ``lengths=None`` is the equal-length path.  With ``lengths`` (B,), the
    prompts are right-padded to a common S and row b's real tokens occupy
    columns 0..lengths[b]-1: each row keeps its last ``min(lengths[b],
    slots)`` real columns, and pad or evicted columns are dropped (the
    reference routes them to an out-of-range destination that its scatter
    drops; the port selects the kept columns), so pad tokens never enter the
    cache.  ``start`` (B,) puts row b's columns at positions ``start[b] +
    j`` (the tail prefill): the kept window is the last ≤ ``slots``
    positions before ``start[b] + lengths[b]``, so prefix entries still in
    the ring are kept and the ring ends as a full prefill of the whole
    prompt would leave it."""
    B, S = k.shape[0], k.shape[1]
    slots = cache["k"].shape[1]
    if lengths is None:
        take = min(S, slots)
        pos0 = S - take
        dest = torch.remainder(pos0 + torch.arange(take, device=k.device), slots)
        _cache_put(cache, (slice(None), dest), k[:, S - take:], v[:, S - take:])
        return cache
    L = torch.as_tensor(lengths, device=k.device).long()[:, None]   # (B, 1)
    j = torch.arange(S, device=k.device)[None, :]                   # (1, S)
    s0 = 0 if start is None else torch.as_tensor(start, device=k.device).long()[:, None]
    keep = (j < L) & (j >= L - slots)   # the last ≤ slots real columns per row
    bi, ji = keep.nonzero(as_tuple=True)
    dest = torch.remainder(ji if start is None else (s0 + j).expand(B, S)[bi, ji], slots)
    _cache_put(cache, (bi, dest), k, v, sel=(bi, ji))
    return cache


def _out_proj(out: torch.Tensor, params) -> torch.Tensor:
    return linear_or_quant(out, params["wo"], "bshk,hkd->bsd")
