"""Flash attention as hand-written CUDA kernels for Hopper, in a prefill and
a per-slot decode form, with their plain PyTorch versions.

Counterpart: ``src/repro/kernels/flash_attention.py`` (``flash_attention``)
and the oracle ``flash_attention_ref`` of ``src/repro/kernels/ref.py``,
wrapped by ``ops.flash_attention`` there (``src/repro/kernels/ops.py:37``).

The function is the Pallas kernel's: online-softmax attention with fp32
running max, sum and accumulator; causal, sliding-window and chunked masks;
GQA by kv-head index (q head h reads kv head ``h // (H // KV)``, K/V are
not broadcast); scores scaled after the dot, ``s = (q·k) · scale``; the
probabilities kept in fp32 for the product with V; ``acc / max(l, 1e-30)``
at the end, so a fully masked row is 0.  (The oracle ``flash_attention_ref``
averages V over such a row instead; the port follows the kernel.)

* :func:`flash_attention` — the prefill form, the reference's contract:
  q ``(B, H, Sq, hd)``, k and v ``(B, KV, Sk, hd)``, query i at position
  ``Sk − Sq + i``, key j at j.
* :func:`flash_attention_decode` — the same function for one query a row at
  its own position ``pos[b]`` over a ring cache: q ``(B, H, hd)``, caches
  ``(B, slots, KV, hd)`` as the port stores them, pos ``(B,)``.  Slot s
  holds position ``pos − ((pos − s) mod slots)``, valid where that is ≥ 0
  and the mask admits it: the reference's decode mask
  (``src/repro/models/layers/attention.py:296-305``) for any pos ≥ 0, also
  pos ≥ slots (idle slots of the engine keep stale positions).

The kernels (``csrc/flash_attention.cu``, where the design and bound are
described) sum every row in one order fixed by hd and a key tile of fixed
width from key 0 (the decode form: tiles within spans from slot 0, 64
slots wide at hd 256 and 128 below, the spans merged in span order by a
second kernel of the same launch), so a row's result does not depend on
the batch, the position or padding: that is what lets continuous batching
give the slot-at-a-time oracle's streams without the fp64 sums the port's
attention took before.
They take fp32 or bf16 (q, k and v of one dtype), hd 32, 64, 128 or 256,
and in the decode form at most 8 q heads a kv head; inputs are read through
their strides.  The prefill form has two routes, by dtype and nothing else:
fp32 operands go to an IEEE-fp32 kernel on the SIMT pipe, bf16 operands to
a tensor-core kernel (``mma.sync`` bf16 with fp32 accumulation), whose
products are all exact (bf16 × bf16, and each fp32 probability split into
three bf16 terms, :func:`bf16_terms`, for its product with V) and whose
sums run in one order fixed by hd and the key tile.  The wrappers run the
kernel for a CUDA tensor and the plain version for a CPU tensor, and raise
for anything else: there is no fallback.  ``flash_attention.launches`` and
``flash_attention_decode.launches`` count launches,
``flash_attention.routes`` counts the prefill launches by route
(``"mma_bf16"``, ``"fp32"``), ``.shapes`` counts them by ``(B, H, KV, Sq,
Sk, hd, mask)`` and ``(B, H, KV, slots, hd, mask)``, the mask as
``(causal, window, chunk)``.

The plain versions take their sums in fp64 and round to fp32, as the plain
``rmsnorm`` does: the scores' dot products, the softmax (each probability
correctly rounded to fp32, as the port's attention took them before this
kernel) and the product with V.  The same function, written with the
kernel's unnormalised ``acc / l`` in fp32, moves the 28-layer int8 reading
of ``tests/test_torch_lm.py::test_int8_logit_error_grows_with_depth`` from
the reference's 0.6407 to 0.6818: on random weights the int8 stack turns
ulps into other quantised activations.  They run on the CPU and as the
card's oracle, never on the card's serving path.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

__all__ = ["bf16_terms", "flash_attention", "flash_attention_decode",
           "flash_attention_plain", "flash_attention_decode_plain", "flash_attention_terms",
           "slot_positions"]

NEG_INF = -2.0e38
#: the mask arguments, in the order the ``.shapes`` keys hold their values
MASK_ARGS = ("causal", "window", "chunk")
#: head dims the kernels are built for
HEAD_DIMS = (32, 64, 128, 256)
#: q heads a kv head the decode kernel holds (its block's rows)
DECODE_GROUP_MAX = 8
#: the prefill form's kernel for each operand dtype, as ``.routes`` counts it
ROUTES = {torch.float32: "fp32", torch.bfloat16: "mma_bf16"}
#: bf16 terms a probability takes in the tensor-core kernel's P · V
P_TERMS = 3

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("flash_attention")
        for fn in (lib.flash_prefill_launch, lib.flash_prefill_terms_launch):
            fn.argtypes = ([_I32, _I32] + [_P] * 4 + [_I32] * 3 + [_I64] * 2 + [_I64] * 12
                           + [_I32, _I32, _I64, _I32, _I64, ctypes.c_float, _P])
            fn.restype = _I32
        lib.flash_decode_launch.argtypes = (
            [_I32, _I32] + [_P] * 6 + [_I32] * 3 + [_I64] + [_I64] * 10
            + [_I32, _I32, _I64, _I32, _I64, ctypes.c_float, _P])
        lib.flash_decode_launch.restype = _I32
        lib.flash_decode_scratch_floats.argtypes = [_I32, _I32, _I64, _I32]
        lib.flash_decode_scratch_floats.restype = _I64
        _lib_handle = lib
    return _lib_handle


# --------------------------------------------------------------------------- #
# shapes, masks, keys
# --------------------------------------------------------------------------- #
def _check_chunk(chunk: Optional[int]) -> None:
    if chunk is not None and int(chunk) <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")


def _check_prefill(q, k, v) -> None:
    """The reference wrapper's validation and error texts."""
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} must be "
                         f"(B, H, Sq, hd) and (B, KV, Sk, hd)")
    if v.shape != k.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k.shape)} vs {tuple(v.shape)}")
    B, H, _, hd = q.shape
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"q{tuple(q.shape)} and k{tuple(k.shape)} differ in B or hd")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")


def _check_decode(q, k_cache, v_cache, pos) -> None:
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q{tuple(q.shape)} and k_cache{tuple(k_cache.shape)} must "
                         f"be (B, H, hd) and (B, slots, KV, hd)")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v shape mismatch: {tuple(k_cache.shape)} vs "
                         f"{tuple(v_cache.shape)}")
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != hd:
        raise ValueError(f"q{tuple(q.shape)} and k_cache{tuple(k_cache.shape)} "
                         f"differ in B or hd")
    if KV == 0 or H % KV:
        raise ValueError(f"H={H} not divisible by KV={KV}")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"pos{tuple(pos.shape)} must be ({B},)")


def _admitted(pq: torch.Tensor, pk: torch.Tensor, causal: bool,
              window: Optional[int], chunk: Optional[int]) -> torch.Tensor:
    """The reference's masks for queries at ``pq`` and keys at ``pk``
    (broadcast against each other)."""
    m = torch.ones(torch.broadcast_shapes(pq.shape, pk.shape), dtype=torch.bool,
                   device=pq.device)
    if causal:
        m &= pk <= pq
    if window is not None:
        m &= pq - pk < window
    if chunk is not None:
        m &= (torch.div(pq, chunk, rounding_mode="floor")
              == torch.div(pk, chunk, rounding_mode="floor"))
    return m


def _mask_key(causal: bool, window: Optional[int], chunk: Optional[int]) -> tuple:
    """The mask as the ``.shapes`` keys hold it: the values of MASK_ARGS."""
    return (bool(causal), window, chunk)


def _softmax_pv(s: torch.Tensor, valid: torch.Tensor, pv) -> torch.Tensor:
    """s: fp32 scores (..., keys), valid: a bool mask broadcast against
    them, pv: p (fp64) ↦ p · V (fp64).  The softmax over the admitted keys
    taken in fp64 and rounded to fp32, then p · V summed in fp64 and
    rounded to fp32; 0 for a row with no admitted key.  The same function
    as the kernel's ``acc / max(l, 1e-30)``, with each probability
    correctly rounded."""
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s.double(), dim=-1).float()
    p = torch.where(valid, p, torch.zeros((), device=s.device))
    return pv(p.double()).float()


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          chunk: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The prefill form's function, sums in fp64 rounded to fp32.
    (B, H, Sq, hd) × (B, KV, Sk, hd)² → (B, H, Sq, hd) in q's dtype."""
    _check_prefill(q, k, v)
    _check_chunk(chunk)
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, KV, H // KV, Sq, hd).double()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.double()).float() * scale
    pos_q = torch.arange(Sq, device=q.device) + (Sk - Sq)
    pos_k = torch.arange(Sk, device=q.device)
    valid = _admitted(pos_q[:, None], pos_k[None, :], causal, window, chunk)
    out = _softmax_pv(s, valid, lambda p: torch.einsum("bkgqs,bksd->bkgqd", p, v.double()))
    return out.to(q.dtype).reshape(B, H, Sq, hd)


def slot_positions(pos: torch.Tensor, slots: int) -> torch.Tensor:
    """(B,) positions → (B, slots): the position slot s of a ring holds, the
    most recent one ≡ s (mod slots) that is ≤ pos (negative: empty).
    ``torch.remainder`` takes the divisor's sign, as Python's ``%``."""
    pc = pos.long()[:, None]
    return pc - torch.remainder(pc - torch.arange(slots, device=pos.device)[None, :], slots)


def flash_attention_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor, pos: torch.Tensor, *,
                                 causal: bool = True, window: Optional[int] = None,
                                 chunk: Optional[int] = None,
                                 scale: Optional[float] = None) -> torch.Tensor:
    """The decode form's function, sums in fp64 rounded to fp32.
    q (B, H, hd), caches (B, slots, KV, hd), pos (B,) → (B, H, hd)."""
    _check_decode(q, k_cache, v_cache, pos)
    _check_chunk(chunk)
    B, H, hd = q.shape
    slots, KV = k_cache.shape[1], k_cache.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    sp = slot_positions(pos, slots)                                 # (B, slots)
    pc = pos.long()[:, None]
    valid = (sp >= 0) & _admitted(pc, sp, causal, window, chunk)
    qg = q.reshape(B, KV, H // KV, hd).double()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.double()).float() * scale
    out = _softmax_pv(s, valid[:, None, None, :],
                      lambda p: torch.einsum("bkgs,bskd->bkgd", p, v_cache.double()))
    return out.to(q.dtype).reshape(B, H, hd)


def bf16_terms(x: torch.Tensor, terms: int = P_TERMS) -> list:
    """``x`` (fp32) as ``terms`` bf16 tensors, each the bf16 rounding (to
    nearest) of what the ones before leave: the split the tensor-core
    prefill kernel makes of each probability before its product with V.
    The remainders are exact in fp32, and three terms hold all 24
    significant bits of a normal fp32 value, so each term's product with a
    bf16 value is exact in fp32 and the three sum back to ``x``.  Written
    for the CPU tests of that precision choice; on no served path."""
    out, rest = [], x.float()
    for _ in range(terms):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].float()
    return out


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def _kernel_view(t: torch.Tensor, align: int = 4) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (the head dim
    contiguous, every other stride a multiple of ``align`` elements, the
    base 16-byte aligned), else a contiguous copy."""
    if (t.stride(-1) == 1 and all(s % align == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.contiguous()


def _check_cuda(q, *others) -> None:
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"q, k and v must be float32 or bfloat16, got {q.dtype}")
    for t in others:
        if t.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype, got {q.dtype} and {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
    hd = q.shape[-1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel takes {HEAD_DIMS}")
    if q.numel() == 0 or any(t.numel() == 0 for t in others):
        raise ValueError("empty operand")
    if q.shape[0] > 65535:
        raise ValueError(f"batch {q.shape[0]} exceeds the kernel's grid (65535)")


def _mask_args(causal, window, chunk):
    return (int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0,
            int(chunk is not None), int(chunk) if chunk is not None else 0)


def _launch_prefill(launch, first: int, q, k, v, causal, window, chunk, scale):
    """Launch a prefill kernel through ``launch`` (a C launcher whose first
    argument is ``first``); returns the output in q's dtype and strides."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = hd ** -0.5 if scale is None else scale
    # bf16 rows travel as 16-byte cp.async copies (8 elements)
    align = 8 if q.dtype == torch.bfloat16 else 4
    q, k, v = (_kernel_view(t, align) for t in (q, k, v))
    out = _kernel_view(torch.empty_like(q), align)
    err = launch(
        first, hd, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, Sq, Sk,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), out.stride(0), out.stride(1), out.stride(2),
        *_mask_args(causal, window, chunk), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    chunk: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Prefill attention.  (B, H, Sq, hd) × (B, KV, Sk, hd)² → (B, H, Sq,
    hd) in q's dtype, with q's strides.  On the card, fp32 operands take the
    IEEE-fp32 kernel and bf16 operands the tensor-core kernel
    (``.routes`` counts each)."""
    _check_prefill(q, k, v)
    _check_chunk(chunk)
    if _build.on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     chunk=chunk, scale=scale)
    _check_cuda(q, k, v)
    out = _launch_prefill(_lib().flash_prefill_launch, _build.DTYPE_CODES[q.dtype], q, k, v,
                          causal, window, chunk, scale)
    B, H, Sq, hd = q.shape
    flash_attention.launches += 1
    flash_attention.routes[ROUTES[q.dtype]] += 1
    flash_attention.shapes[(B, H, k.shape[1], Sq, k.shape[2], hd,
                            _mask_key(causal, window, chunk))] += 1
    return out


def flash_attention_terms(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, terms: int,
                          *, causal: bool = True, window: Optional[int] = None,
                          chunk: Optional[int] = None,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The tensor-core prefill kernel with each probability in ``terms``
    (1 to 3) bf16 terms instead of three: a reading of that precision
    choice on the card (CUDA bf16 tensors only), on no served path and
    counted nowhere."""
    _check_prefill(q, k, v)
    _check_chunk(chunk)
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_terms reads the bf16 kernel: CUDA bf16 operands")
    if terms not in range(1, P_TERMS + 1):
        raise ValueError(f"terms must be 1 to {P_TERMS}, got {terms}")
    _check_cuda(q, k, v)
    return _launch_prefill(_lib().flash_prefill_terms_launch, terms, q, k, v, causal,
                           window, chunk, scale)


def flash_attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor, *,
                           causal: bool = True, window: Optional[int] = None,
                           chunk: Optional[int] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One decode step's attention: q (B, H, hd) at positions pos (B,) over
    ring caches (B, slots, KV, hd) → (B, H, hd) in q's dtype."""
    _check_decode(q, k_cache, v_cache, pos)
    _check_chunk(chunk)
    if _build.on_cpu(q):
        return flash_attention_decode_plain(q, k_cache, v_cache, pos, causal=causal,
                                            window=window, chunk=chunk, scale=scale)
    _check_cuda(q, k_cache, v_cache)
    B, H, hd = q.shape
    slots, KV = k_cache.shape[1], k_cache.shape[2]
    if H // KV > DECODE_GROUP_MAX:
        raise ValueError(f"{H // KV} q heads a kv head; the decode kernel takes at "
                         f"most {DECODE_GROUP_MAX}")
    if pos.device != q.device:
        raise ValueError(f"pos on {pos.device}, q on {q.device}")
    scale = hd ** -0.5 if scale is None else scale
    # rows of q and of the caches travel as 16-byte vectors
    vec = 16 // q.element_size()
    q, k_cache, v_cache = (_kernel_view(t, vec) for t in (q, k_cache, v_cache))
    pos = pos.to(torch.int64).contiguous()
    out = _kernel_view(torch.empty_like(q))
    lib = _lib()
    scratch = torch.empty(lib.flash_decode_scratch_floats(B, H, slots, hd),
                          dtype=torch.float32, device=q.device)
    err = lib.flash_decode_launch(
        _build.DTYPE_CODES[q.dtype], hd, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), pos.data_ptr(), scratch.data_ptr(), B, H, KV,
        slots,
        q.stride(0), q.stride(1), k_cache.stride(0), k_cache.stride(2),
        k_cache.stride(1), v_cache.stride(0), v_cache.stride(2), v_cache.stride(1),
        out.stride(0), out.stride(1), *_mask_args(causal, window, chunk), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_decode launch failed: CUDA error {err}")
    flash_attention_decode.launches += 1
    flash_attention_decode.shapes[(B, H, KV, slots, hd,
                                   _mask_key(causal, window, chunk))] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = collections.Counter()
flash_attention.shapes = collections.Counter()
flash_attention_decode.launches = 0
flash_attention_decode.shapes = collections.Counter()
