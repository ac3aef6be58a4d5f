"""Quantized int8 matrix products as hand-written CUDA kernels for Hopper,
the row quantization in front of them, and their plain PyTorch versions.

Counterpart: ``src/repro/kernels/quant_matmul.py`` (``quant_matmul_pallas``)
with the oracle ``quant_matmul_ref`` of ``src/repro/kernels/ref.py``, and
``quantize_rows`` of ``src/repro/kernels/ops.py``.

    out = (xq · wq) * xs[:, None] * ws[None, :]

with the product summed exactly in integers and the two scale products in
fp32, in that order, so every version here is bitwise equal to the oracle
at any K.  (The reference's own off-TPU path sums in fp32 and is exact only
while K·127² < 2²⁴; see ROADMAP.md, Queue 3.)

Three entry points, each a CUDA kernel for a CUDA tensor and its plain
version for a CPU tensor (any other device raises; a shape a kernel cannot
take raises; nothing falls back):

* :func:`quant_matmul` — xq ``(M, K)`` int8, xs ``(M,)``, wq ``(K, N)``
  int8, ws ``(N,)`` → ``(M, N)`` fp32.  The reference's counterpart, held
  by its own tests.
* :func:`quantize_rows` — ``x (..., K)`` → ``(xq, xs)``: per-row symmetric
  int8 with scale ``max|x| / 127 + 1e-8``, IEEE division, rounding half to
  even.
* :func:`quant_linear` — the serving path's projection group: ``x (M, K)``
  in bf16 or fp32 and one to three ``(wq, ws)`` that read it; returns, for
  each, exactly ``quant_matmul(*quantize_rows(x), wq, ws).to(x.dtype)``.
  The reference has no grouped call; grouping changes no bit, because the
  quantization is per row and every product is independent.  M ≤ 16 (a
  decode step) is one launch of ``qmm_group`` for the whole group, which
  quantizes x in its prologue and writes x's dtype; a larger M (a prefill
  wave) is one ``quantize_rows`` launch and one ``qmm_wgmma`` launch per
  weight, writing x's dtype.

The kernels (``csrc/quant_matmul.cu``, where their design and bounds are
described) read the weight as ``wq.T``, ``(N, K)`` row-major: a ``wq`` that
is a transposed view of such a tensor (as
:class:`repro_torch.models.layers.quant.QTensor` hands it over) is read in
place, any other ``wq`` is first copied to that layout.  Both product forms
want K a multiple of 16 and 16-byte aligned int8 operands: the wrappers pad
K with zeros (which an integer sum does not notice) and copy a misaligned
operand; at the served shapes neither happens.  ``qmm_wgmma``'s tiles of
128 × 128 or 128 × 256 outputs are chosen by :func:`tile_n`.

Launch counts: ``quant_matmul.launches`` and ``quant_linear.launches`` count
product launches, ``quantize_rows.launches`` quantization launches
(``quant_linear``'s prefill form counts its one there).  ``.shapes`` count
calls by ``(M, K, N)`` (``quant_matmul``), ``(M, K, (N₁, …))``
(``quant_linear``, one per group call) and ``(M, K, dtype)``
(``quantize_rows``).
"""
from __future__ import annotations

import collections
import ctypes
import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["quant_linear", "quant_linear_plain", "quant_matmul", "quant_matmul_plain",
           "quantize_rows", "quantize_rows_plain", "tile_n"]

#: rows a decode-form launch takes at most; larger M takes the tiled form
SKINNY_M = 16
#: rows of a tiled-form tile, and the widths it may take
TILE_M, TILE_N = 128, (256, 128)
#: weights one ``quant_linear`` call takes at most (q, k and v)
MAX_GROUP = 3
#: output dtype codes of the C launchers
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_longlong
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("quant_matmul")
        lib.quant_matmul_launch.argtypes = [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32,
                                            _I32, _P]
        lib.quant_group_launch.argtypes = [_P, _I64, _I32, _I32, _I32, _I32, _P, _P, _P,
                                           _P, _I32, _P]
        lib.quantize_rows_launch.argtypes = [_P, _I64, _I32, _P, _I64, _P, _I32, _I32,
                                             _I32, _P]
        for fn in (lib.quant_matmul_launch, lib.quant_group_launch,
                   lib.quantize_rows_launch):
            fn.restype = _I32
        _lib_handle = lib
    return _lib_handle


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_shapes(xq, xs, wq, ws) -> None:
    if xq.ndim != 2 or wq.ndim != 2:
        raise ValueError(f"shape mismatch: xq{tuple(xq.shape)} wq{tuple(wq.shape)} "
                         f"must both be 2-D")
    M, K = xq.shape
    K2, N = wq.shape
    if K != K2 or tuple(xs.shape) != (M,) or tuple(ws.shape) != (N,):
        raise ValueError(f"shape mismatch: xq{tuple(xq.shape)} wq{tuple(wq.shape)} "
                         f"x_scale{tuple(xs.shape)} w_scale{tuple(ws.shape)}")


def tile_n(M: int, N: int, sms: int) -> int:
    """Output columns of a tiled-form tile at (M, N) on a card with ``sms``
    SMs: 256, unless 128-column tiles finish sooner.  The grid holds one
    block per SM, so a launch takes as many rounds as tiles over SMs; a
    round costs about the bytes a tile loads a K step, 128 + bn rows (the
    loads from L2, not the tensor cores, hold the form's main loop).  Ties
    go to 256.  0 for M ≤ ``SKINNY_M`` (the decode form, which has no
    tile)."""
    if M <= SKINNY_M:
        return 0
    m_tiles = math.ceil(M / TILE_M)
    cost = {bn: math.ceil(m_tiles * math.ceil(N / bn) / sms) * (TILE_M + bn)
            for bn in TILE_N}
    return min(TILE_N, key=lambda bn: (cost[bn], -bn))


_SMS: dict = {}


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _SMS[index]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _weight(wq: torch.Tensor) -> torch.Tensor:
    """The int8 weight ``(K, N)`` as the kernels read it: ``(N, Kp)``
    row-major, Kp = K rounded up to 16 (zeros past K), 16-byte aligned."""
    if wq.dtype != torch.int8:
        raise TypeError(f"wq must be int8, got {wq.dtype}")
    wt = wq.t()
    if not wt.is_contiguous():
        wt = wt.contiguous()
    pad = -wt.shape[1] % 16
    return _aligned(F.pad(wt, (0, pad)) if pad else wt)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels read it: a unit column stride (any row stride)."""
    return x if x.stride(-1) == 1 else x.contiguous()


# --------------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------------- #
def quant_matmul_plain(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                       ws: torch.Tensor) -> torch.Tensor:
    """The exact product: int64 on the CPU, float64 on the card (exact while
    K·127² < 2⁵³), then the oracle's fp32 epilogue."""
    _check_shapes(xq, xs, wq, ws)
    if xq.device.type == "cpu":
        acc = torch.matmul(xq.long(), wq.long())
    else:
        acc = torch.matmul(xq.double(), wq.double())
    return acc.float() * xs.float()[:, None] * ws.float()[None, :]


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: returns ``(xq, scale)`` with
    ``xq`` int8 of ``x.shape`` and ``scale`` fp32 of ``x.shape[:-1]`` such
    that ``xq * scale[..., None] ≈ x``.  The ``1e-8`` floor keeps all-zero
    rows from dividing by zero.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does.  The maximum is divided by a tensor of 127s, not by
    the number: PyTorch's CUDA division by a Python number multiplies by its
    reciprocal, which can differ from the reference's IEEE division in the
    last bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, 127.0) + 1e-8
    xq = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return xq, scale


def quant_linear_plain(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                       ) -> List[torch.Tensor]:
    """``quant_matmul_plain(*quantize_rows_plain(x), wq, ws).to(x.dtype)``
    for each weight."""
    _check_group(x, weights)
    xq, xs = quantize_rows_plain(x)
    return [quant_matmul_plain(xq, xs, wq, ws).to(x.dtype) for wq, ws in weights]


# --------------------------------------------------------------------------- #
# kernels
# --------------------------------------------------------------------------- #
def _launch_product(xq, xs, wt, ws, out, M, N, Kp, bn) -> None:
    err = _lib().quant_matmul_launch(
        xq.data_ptr(), wt.data_ptr(), xs.data_ptr(), ws.data_ptr(), out.data_ptr(),
        M, N, Kp, bn, _OUT_CODES[out.dtype], _stream(xq))
    _check(err, "quant_matmul")


def quant_matmul(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                 ws: torch.Tensor) -> torch.Tensor:
    """Quantized int8 × int8 product with the fp32 dequantizing epilogue.
    xq (M, K) int8, xs (M,), wq (K, N) int8, ws (N,) → (M, N) fp32."""
    _check_shapes(xq, xs, wq, ws)
    if _build.on_cpu(xq):
        return quant_matmul_plain(xq, xs, wq, ws)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"xq and wq must be int8, got {xq.dtype} and {wq.dtype}")
    for other in (xs, wq, ws):
        if other.device != xq.device:
            raise ValueError(f"operands on {other.device} and {xq.device}")
    M, K = xq.shape
    N = wq.shape[1]
    if min(M, K, N) == 0:
        raise ValueError(f"empty operand: (M, K, N) = ({M}, {K}, {N})")
    if max(M, K + 15, N) > 2**31 - 1:
        raise ValueError(f"(M, K, N) = ({M}, {K}, {N}) exceeds the kernels' 32-bit sizes")
    wt = _weight(wq)
    xq = xq.contiguous()
    if xq.shape[1] != wt.shape[1]:
        xq = F.pad(xq, (0, wt.shape[1] - K))
    xq = _aligned(xq)
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    _launch_product(xq, xs.float().contiguous(), wt, ws.float().contiguous(), out,
                    M, N, wt.shape[1], tile_n(M, N, _sms(xq.device)))
    quant_matmul.launches += 1
    quant_matmul.shapes[(M, K, N)] += 1
    return out


def _quantize(x: torch.Tensor, Kq: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``quantize_rows_kernel`` on x (M, K) with a unit
    column stride: xq (M, Kq) int8, zeros past K, and xs (M,) fp32."""
    M, K = x.shape
    if x.dtype not in _OUT_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if max(M, Kq) > 2**31 - 1:
        raise ValueError(f"(M, K) = ({M}, {K}) exceeds the kernel's 32-bit sizes")
    xq = torch.empty((M, Kq), dtype=torch.int8, device=x.device)
    xs = torch.empty((M,), dtype=torch.float32, device=x.device)
    err = _lib().quantize_rows_launch(x.data_ptr(), x.stride(0), _OUT_CODES[x.dtype],
                                      xq.data_ptr(), Kq, xs.data_ptr(), M, K, Kq,
                                      _stream(x))
    _check(err, "quantize_rows")
    quantize_rows.launches += 1
    quantize_rows.shapes[(M, K, x.dtype)] += 1
    return xq, xs


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization of ``x (..., K)``: ``(xq, scale)``
    with ``xq`` int8 of ``x.shape`` and ``scale`` fp32 of ``x.shape[:-1]``,
    bitwise :func:`quantize_rows_plain`."""
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"quantize_rows needs rows of at least one element, "
                         f"got x{tuple(x.shape)}")
    if _build.on_cpu(x):
        return quantize_rows_plain(x)
    K = x.shape[-1]
    x2 = _rows(x.reshape(-1, K))
    if x2.shape[0] == 0:                     # nothing to launch
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device))
    xq, xs = _quantize(x2, K)
    return xq.reshape(x.shape), xs.reshape(x.shape[:-1])


def _check_group(x, weights) -> None:
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (M, K), got x{tuple(x.shape)}")
    if not 1 <= len(weights) <= MAX_GROUP:
        raise ValueError(f"quant_linear takes 1 to {MAX_GROUP} weights, got {len(weights)}")
    for wq, ws in weights:
        if wq.ndim != 2 or wq.shape[0] != x.shape[1] or tuple(ws.shape) != (wq.shape[1],):
            raise ValueError(f"shape mismatch: x{tuple(x.shape)} wq{tuple(wq.shape)} "
                             f"w_scale{tuple(ws.shape)}")


def _launch_group(x, wts, wss, outs, Kp) -> None:
    """One ``qmm_group`` launch: x (M ≤ 16, K) with a unit column stride,
    the weights as :func:`_weight` lays them out, fp32 scales, outputs (M,
    N_i) of x's dtype."""
    n = len(wts)
    ptrs = lambda ts: (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])  # noqa: E731
    err = _lib().quant_group_launch(
        x.data_ptr(), x.stride(0), _OUT_CODES[x.dtype], x.shape[0], x.shape[1], Kp,
        ptrs(wts), ptrs(wss), ptrs(outs), (ctypes.c_int * n)(*[o.shape[1] for o in outs]), n,
        _stream(x))
    _check(err, "quant_linear")


def quant_linear(x: torch.Tensor, weights: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
    """For each ``(wq (K, N_i) int8, ws (N_i,))`` of ``weights`` (one to
    three that read the same x), ``quant_matmul(*quantize_rows(x), wq,
    ws).to(x.dtype)``, bitwise: x (M, K) bf16 or fp32 → a list of (M, N_i)
    in x's dtype."""
    _check_group(x, weights)
    if _build.on_cpu(x):
        return quant_linear_plain(x, weights)
    if x.dtype not in _OUT_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for wq, ws in weights:
        for t in (wq, ws):
            if t.device != x.device:
                raise ValueError(f"operands on {t.device} and {x.device}")
    M, K = x.shape
    Ns = tuple(int(wq.shape[1]) for wq, _ in weights)
    if min(M, K, *Ns) == 0:
        raise ValueError(f"empty operand: (M, K, N) = ({M}, {K}, {Ns})")
    if max(M, K + 15, *Ns) > 2**31 - 1:
        raise ValueError(f"(M, K, N) = ({M}, {K}, {Ns}) exceeds the kernels' 32-bit sizes")
    x = _rows(x)
    wts = [_weight(wq) for wq, _ in weights]
    wss = [ws.float().contiguous() for _, ws in weights]
    outs = [torch.empty((M, N), dtype=x.dtype, device=x.device) for N in Ns]
    Kp = wts[0].shape[1]
    if M <= SKINNY_M:
        _launch_group(x, wts, wss, outs, Kp)
        quant_linear.launches += 1
    else:
        xq, xs = _quantize(x, Kp)
        sms = _sms(x.device)
        for wt, ws, out, N in zip(wts, wss, outs, Ns):
            _launch_product(xq, xs, wt, ws, out, M, N, Kp, tile_n(M, N, sms))
        quant_linear.launches += len(weights)
    quant_linear.shapes[(M, K, Ns)] += 1
    return outs


quant_matmul.launches = 0
quant_matmul.shapes = collections.Counter()
quant_linear.launches = 0
quant_linear.shapes = collections.Counter()
quantize_rows.launches = 0
quantize_rows.shapes = collections.Counter()
