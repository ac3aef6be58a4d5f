"""Quantized int8 matrix product as a hand-written CUDA kernel for Hopper,
with its plain PyTorch version.

Counterpart: ``src/repro/kernels/quant_matmul.py`` (``quant_matmul_pallas``)
and the oracle ``quant_matmul_ref`` of ``src/repro/kernels/ref.py``.

    out = (xq · wq) * xs[:, None] * ws[None, :]

with the product summed exactly in integers and the two scale products in
fp32, in that order, so every version here is bitwise equal to the oracle
at any K.  (The reference's own off-TPU path sums in fp32 and is exact only
while K·127² < 2²⁴; see ROADMAP.md, Queue 3.)

xq is ``(M, K)`` int8, xs ``(M,)``, wq ``(K, N)`` int8, ws ``(N,)``; the
result is ``(M, N)`` fp32.  The kernels (``csrc/quant_matmul.cu``, where
their design and bounds are described) read the weight as ``wq.T``,
``(N, K)`` row-major: a ``wq`` that is a transposed view of such a tensor
(as :class:`repro_torch.models.layers.quant.QTensor` hands it over) is read
in place, any other ``wq`` is first copied to that layout.  M ≤ 16 (a
decode step) takes ``qmm_skinny``; a larger M (a prefill wave) takes
``qmm_wgmma``, whose tiles of 128 × 128 or 128 × 256 outputs
:func:`tile_n` chooses by shape, and whose TMA loads want K a multiple of
16 and 16-byte aligned operands: the wrapper pads K with zeros (which an
integer sum does not notice) and copies a misaligned operand.  It runs the
kernel for a CUDA tensor and the plain version for a CPU tensor, and raises
for anything else.  ``quant_matmul.launches`` counts launches and
``quant_matmul.shapes`` counts them by ``(M, K, N)``.
"""
from __future__ import annotations

import collections
import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

__all__ = ["quant_matmul", "quant_matmul_plain", "tile_n"]

#: rows a decode-form launch takes at most; larger M takes the tiled form
SKINNY_M = 16
#: rows of a tiled-form tile, and the widths it may take
TILE_M, TILE_N = 128, (256, 128)

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("quant_matmul")
        lib.quant_matmul_launch.argtypes = [_P, _P, _P, _P, _P, _I32, _I32, _I32, _I32, _P]
        lib.quant_matmul_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


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
    xq = xq.contiguous()
    wt = wq.t()
    if not wt.is_contiguous():
        wt = wt.contiguous()
    bn = tile_n(M, N, _sms(xq.device))
    if bn:
        pad = -K % 16
        if pad:
            xq, wt = F.pad(xq, (0, pad)), F.pad(wt, (0, pad))
        xq, wt = _aligned(xq), _aligned(wt)
    xs32 = xs.float().contiguous()
    ws32 = ws.float().contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    err = _lib().quant_matmul_launch(
        xq.data_ptr(), wt.data_ptr(), xs32.data_ptr(), ws32.data_ptr(),
        out.data_ptr(), M, N, xq.shape[1], bn,
        torch.cuda.current_stream(xq.device).cuda_stream)
    if err:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    quant_matmul.launches += 1
    quant_matmul.shapes[(M, K, N)] += 1
    return out


quant_matmul.launches = 0
quant_matmul.shapes = collections.Counter()
