"""Fixed-order products as a hand-written CUDA kernel for Hopper, with their
plain PyTorch version.

No TPU kernel: the reference's projections are einsums that it leaves to XLA
(``src/repro/models/layers/ssd.py``, ``attention.py``, ``mlp.py``).  The port
needs them in an order of its own, because continuous batching must give
the slot-at-a-time oracle's greedy streams (at a decode step, and in a
prefill wave of several prompts against the oracle's one) and a cuBLAS
product picks its summation order by shape: an fp32 product of 8 rows
differs from the same rows one at a time in most elements.  The kernel
(``csrc/fixed_linear.cu``, where its design and bound are described) sums
every output in one fp32 order fixed by K alone, so row m is bitwise the
same at any M:

    out_i = xin @ W_i        x (M, K), each W_i (K, N_i), one to five of them

in one launch for the weights that read the same x, each output in a dtype
of its own (fp32 or bf16).  ``xin`` is ``x``, or, with the norm prologue
``norm=(scale, eps, plus_one)``, what the layer's RMSNorm would hand the
product, computed in the kernel and never written out:
``rmsnorm(x, scale, eps, plus_one=plus_one)`` rounded to the weights'
dtype.  x is then in the weights' dtype (a block's pre-norm) or fp32 with
bf16 weights (Mamba-2's gated norm: ``ssd_decode`` writes its fp32 gate
``y·silu(z)``, and ``rmsnorm(gate).to(bf16)`` is ``ssd.py``'s
``_gated_norm``).  The kernel sums the statistics in the ``rmsnorm``
kernel's order, so the row the product reads is bitwise what the unfused
composition hands it.

Routes (:func:`route`), all in one bf16 order fixed by K: k16 steps of
16 contiguous elements at their natural positions, chained by the tensor
core in its own fp32 accumulator over each slice of 256 elements (the first
step from zero), the slices' sums added in order with IEEE adds, rounded
once.  A probe on the H100 (``tests/csrc/mma_chain_probe.cu``) found that
chain the same bits through ``mma.sync`` and ``wgmma``, so both bf16 forms
compute it: ``"mma_bf16"`` (bf16 weights at M ≤ 16 or behind a norm: a
decode step, bound by the weights' bytes; ``mma.sync`` m16n8k16, the
weights streamed through shared-memory rings into ``ldmatrix`` by clusters
of blocks that split every tile's slices evenly over the card) and, above 16 rows of bf16 x with
no norm (a prefill wave, bound by the tensor cores), ``"mma_bf16_tiled"``
(``wgmma`` m64n128k16 fed by a TMA ring, 128 x 128 output tiles); fp32
weights ``"fma"`` (IEEE FMA on the SIMT pipe).  x shares the weights' dtype
but for the fp32 x of a normed bf16 product.

The kernel reads each weight as ``W.T``, ``(N, K)`` row-major: the port
keeps its plain projection weights in that storage on the card
(``models/params.py``'s ``kernel_layout``), so a weight is read in place;
the wrapper raises for any other storage rather than copy the weight.  K
must be a multiple of 8, and at most :func:`max_k` but on the tiled route;
the wrapper raises otherwise.  It runs the kernel for a CUDA tensor and the
plain version for a CPU tensor, and raises for anything else.
``fixed_linear.launches`` counts launches, ``.shapes`` counts them by
``(M, K, (N, ...), prologue)`` (``"norm"`` or None) and ``.routes`` by
route.

The plain version takes each row on its own (so a row's result cannot depend
on the others), sums it in fp64 and rounds to fp32, then to the output's
dtype, as ``lm_head_plain`` does; its prologue is ``rmsnorm_plain`` and the
cast.  It runs on the CPU and as the card's oracle, never on the card's
serving path.
"""
from __future__ import annotations

import collections
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm import rmsnorm_plain

__all__ = ["fixed_linear", "fixed_linear_plain", "max_k", "plan", "route"]

#: weights one launch takes at most (Mamba-2's z, x, B, C and Δ)
MAX_GROUP = 5
#: K must be a multiple of this
K_ALIGN = 8
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("fixed_linear")
        lib.fixed_linear_launch.argtypes = ([_I32, _I32, _P, _I64, _I32, _I32, _P, _P, _P, _P,
                                             _I32, _I32, _P, _I32, _I32, ctypes.c_float, _P])
        lib.fixed_linear_launch.restype = _I32
        lib.fixed_linear_max_k.argtypes = [_I32, _I32, _I32]
        lib.fixed_linear_max_k.restype = _I32
        lib.fixed_linear_route.argtypes = [_I32, _I32, _I32, _I32]
        lib.fixed_linear_route.restype = _I32
        lib.fixed_linear_plan.argtypes = [_I32, _I32, _I32, _I32, _P]
        lib.fixed_linear_plan.restype = _I32
        _lib_handle = lib
    return _lib_handle


def max_k(dtype: torch.dtype, x_dtype: torch.dtype, norm: bool) -> int:
    """The widest K one launch of the decode form (or the SIMT route) takes
    on the card with weights of ``dtype`` and x of ``x_dtype`` (a tile's
    partial sums, and behind a norm x's whole rows, must fit a block's
    shared memory); the tiled form takes any K."""
    codes = _build.DTYPE_CODES
    return _lib().fixed_linear_max_k(codes[dtype], codes[x_dtype], int(norm))


def plan(x_dtype: torch.dtype, scale_dtype: Optional[torch.dtype], K: int,
         Ns: Sequence[int]) -> dict:
    """How the decode form splits a launch with bf16 weights of widths
    ``Ns`` over this card: blocks a cluster, clusters, tiles of 16 weight
    rows a cluster takes at once (more tiles run in waves), phases of x's
    rows (1 where they fit shared memory whole; else 4,096 elements a
    phase), and 4 KB pieces of weights each warp keeps in flight (x of ``x_dtype``; ``scale_dtype``
    the norm's, or None without a norm)."""
    codes = _build.DTYPE_CODES
    out = (_I32 * 5)()
    scale = 0 if scale_dtype is None else (1 if scale_dtype == torch.bfloat16 else 2)
    tiles = sum((int(N) + 15) // 16 for N in Ns)
    err = _lib().fixed_linear_plan(codes[x_dtype], scale, K, tiles, out)
    if err:
        raise ValueError(f"no decode-form plan for K = {K}, N = {tuple(Ns)}: CUDA error {err}")
    return dict(zip(("cluster", "clusters", "wave", "phases", "pieces"), out))


#: the routes, by the C launcher's code
ROUTES = ("fma", "mma_bf16", "mma_bf16_tiled")


def route(dtype: torch.dtype, x_dtype: torch.dtype, norm: bool, M: int) -> str:
    """The route a CUDA call with weights of ``dtype``, x of ``x_dtype``, a
    norm or not, and M rows takes (the C launcher decides)."""
    codes = _build.DTYPE_CODES
    return ROUTES[_lib().fixed_linear_route(codes[dtype], codes[x_dtype], int(norm), M)]


def _check(x, weights, out_dtypes, norm) -> List[torch.dtype]:
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (M, K), got x{tuple(x.shape)}")
    if not 1 <= len(weights) <= MAX_GROUP:
        raise ValueError(f"fixed_linear takes 1 to {MAX_GROUP} weights, got {len(weights)}")
    for w in weights:
        if w.ndim != 2 or w.shape[0] != x.shape[1]:
            raise ValueError(f"shape mismatch: x{tuple(x.shape)} w{tuple(w.shape)}")
    wdt = weights[0].dtype
    out_dtypes = [wdt] * len(weights) if out_dtypes is None else list(out_dtypes)
    if len(out_dtypes) != len(weights):
        raise ValueError(f"{len(out_dtypes)} output dtypes for {len(weights)} weights")
    if norm is not None and tuple(norm[0].shape) != (x.shape[1],):
        raise ValueError(f"norm scale {tuple(norm[0].shape)} vs K = {x.shape[1]}")
    return out_dtypes


def _prologue_plain(x: torch.Tensor, norm, dtype: torch.dtype) -> torch.Tensor:
    """What the product reads: x, or ``rmsnorm_plain(x, *norm)`` rounded to
    the weights' ``dtype``."""
    if norm is None:
        return x
    scale, eps, plus_one = norm
    return rmsnorm_plain(x, scale, eps, plus_one=plus_one).to(dtype)


def fixed_linear_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                       out_dtypes: Optional[Sequence[torch.dtype]] = None, *,
                       norm=None) -> List[torch.Tensor]:
    """The products row by row (each row its own (1, K) product of a batched
    call), each summed in fp64, rounded to fp32 and then to its output dtype
    (the weights' dtype by default)."""
    out_dtypes = _check(x, weights, out_dtypes, norm)
    xin = _prologue_plain(x, norm, weights[0].dtype).double()[:, None, :]
    M, K = x.shape
    return [torch.bmm(xin, w.double().expand(M, K, w.shape[1]))[:, 0].float().to(dt)
            for w, dt in zip(weights, out_dtypes)]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t (M, K) as the kernel reads it: unit column stride, 16-byte aligned
    rows."""
    if t.stride(-1) != 1 or (t.stride(0) * t.element_size()) % 16:
        t = t.contiguous()
    return _aligned(t)


def _weight(w: torch.Tensor) -> torch.Tensor:
    """w (K, N) as the kernel reads it, ``w.T``: a view, never a copy (a
    copy on every call would stream the weight twice, and a CUDA graph
    would keep it)."""
    wt = w.t()
    if not wt.is_contiguous() or wt.data_ptr() % 16:
        raise ValueError(f"a weight (K, N) = {tuple(w.shape)} with strides {w.stride()}: the "
                         f"kernel reads (N, K) row-major storage, 16-byte aligned "
                         f"(models/params.py's kernel_layout)")
    return wt


def fixed_linear(x: torch.Tensor, weights: Sequence[torch.Tensor],
                 out_dtypes: Optional[Sequence[torch.dtype]] = None, *,
                 norm: Optional[Tuple[torch.Tensor, float, bool]] = None,
                 ) -> List[torch.Tensor]:
    """For each weight ``(K, N_i)`` of ``weights`` (one to five that read
    the same x), ``xin @ W_i`` in ``out_dtypes[i]`` (the weights' dtype by
    default): the weights bf16 or fp32, x (M, K) in their dtype, or fp32
    under bf16 weights with ``norm=(scale, eps, plus_one)``, where ``xin``
    is ``rmsnorm(x, scale, eps, plus_one=plus_one)`` in the weights' dtype."""
    out_dtypes = _check(x, weights, out_dtypes, norm)
    if _build.on_cpu(x):
        return fixed_linear_plain(x, weights, out_dtypes, norm=norm)
    wdt = weights[0].dtype
    if wdt not in _build.DTYPE_CODES or any(w.dtype != wdt for w in weights):
        raise TypeError(f"the weights must share a dtype, float32 or bfloat16; got "
                        f"{[w.dtype for w in weights]}")
    if x.dtype != wdt and not (norm is not None and x.dtype == torch.float32):
        raise TypeError(f"x {x.dtype} must be the weights' {wdt} (or float32 under a norm)")
    if any(dt not in _OUT_CODES for dt in out_dtypes):
        raise TypeError(f"outputs are float32 or bfloat16, got {out_dtypes}")
    for t in list(weights) + ([] if norm is None else [norm[0]]):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    M, K = x.shape
    Ns = tuple(int(w.shape[1]) for w in weights)
    if min(M, K, *Ns) == 0:
        raise ValueError(f"empty operand: (M, K, N) = ({M}, {K}, {Ns})")
    way = route(wdt, x.dtype, norm is not None, M)
    widest = 2**31 - 1 if way == "mma_bf16_tiled" else max_k(wdt, x.dtype, norm is not None)
    if K % K_ALIGN or K > widest or max(M, *Ns) > 2**31 - 1:
        raise ValueError(f"(M, K, N) = ({M}, {K}, {Ns}): the kernel takes K a multiple of "
                         f"{K_ALIGN} up to {widest}")
    xr = _rows(x)
    wts = [_weight(w) for w in weights]
    outs = [torch.empty((M, N), dtype=dt, device=x.device) for N, dt in zip(Ns, out_dtypes)]
    scale, eps, plus_one = norm if norm is not None else (None, 0.0, False)
    if scale is not None:
        if scale.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"the norm's scale must be float32 or bfloat16, got {scale.dtype}")
        scale = _aligned(scale.contiguous())
    n = len(weights)
    ptrs = lambda ts: (_P * n)(*[t.data_ptr() for t in ts])  # noqa: E731
    codes = _build.DTYPE_CODES
    err = _lib().fixed_linear_launch(
        codes[wdt], codes[x.dtype], xr.data_ptr(), xr.stride(0), M, K, ptrs(wts), ptrs(outs),
        (_I32 * n)(*Ns), (_I32 * n)(*[_OUT_CODES[dt] for dt in out_dtypes]), n,
        int(norm is not None), None if scale is None else scale.data_ptr(),
        0 if scale is None else codes[scale.dtype], int(bool(plus_one)), float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fixed_linear launch failed: CUDA error {err}")
    fixed_linear.launches += 1
    fixed_linear.shapes[(M, K, Ns, None if norm is None else "norm")] += 1
    fixed_linear.routes[way] += 1
    return outs


fixed_linear.launches = 0
fixed_linear.shapes = collections.Counter()
fixed_linear.routes = collections.Counter()
