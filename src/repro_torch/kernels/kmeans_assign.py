"""Fused pairwise-distance k-means assignment as a hand-written CUDA kernel
for Hopper, with its plain PyTorch version.

Counterpart: ``src/repro/kernels/kmeans_assign.py`` (``kmeans_assign_pallas``)
and the oracle ``kmeans_assign_ref`` of ``src/repro/kernels/ref.py``.

The Lloyd assignment computes, for every row x, ``argmin_c ||x − c||²``.
``||x||²`` is constant per row, so the argmin needs only the relative score
``||c||² − 2·x·c`` (the expanded form).  ``||c||²`` is computed once here, by
the wrapper.

The kernel (``csrc/kmeans_assign.cu``, where the design is described) sums
in one order fixed by d alone: d is cut into slices of 512 elements, each
slice is one fp32 ``fmaf`` chain from zero in natural depth order (bf16 x
enters as its exact fp32 value), the slices are added in slice order with
IEEE adds, the score is ``cn[c] − 2·sum``, and the pick is the first lowest
score.  Every form and route computes that order, so a row's pick is
bitwise the same at any n and P, at any place in the batch and at any row
stride.  The C launcher picks:

* the stream form where rows fill the card (the fit's (8, 131072, 4096)):
  bound by fp32 operations (6.41 ms at 67 TFLOP/s) and nearly by bytes
  (5.13 ms at 3.35 TB/s); a persistent grid streams X through a ring of
  shared-memory stages (TMA) while the FMA pipe works on register tiles,
  the column tile fitted to k (k = 50 runs 52 columns);
* the split form where they do not (a serving microbatch, (1, 2048,
  4096)): bound by occupancy, so d's slices are split over a cluster of up
  to 8 blocks and added in slice order by each row's owner through
  distributed shared memory;
* the TMA route where X's rows start on 16-byte boundaries, else a general
  route that fills the same stages with ``cp.async`` (fp32) or 2-byte
  loads (bf16 at odd offsets).

No tensor cores: the port keeps fp32 operands on IEEE fp32 FMA (no TF32),
and three bf16 terms a side cost 9 products for each one, no faster than
the FMA bound.

X is ``(n, d)`` or ``(P, n, d)`` (one launch for every partition), fp32 or
bf16, with contiguous rows at any row stride; C is ``(k, d)``.  The
wrapper runs the kernel for a CUDA tensor and the plain version for a CPU
tensor, and raises for anything else.  ``kmeans_assign.launches`` counts
launches, ``.forms`` the launches by form (``stream``, ``split``) and
``.routes`` by route (``tma``, ``general``).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["kmeans_assign", "kmeans_assign_plain"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("kmeans_assign")
        lib.kmeans_assign_launch.argtypes = [_I32, _P, _I64, _I64, _P, _I64, _P,
                                             _P, _I32, _I32, _I32, _I32, _P, _P]
        lib.kmeans_assign_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


def kmeans_assign_plain(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """argmin_c (||c||² − 2·x·c) in fp32, first index on ties — the
    reference's expanded-form oracle.  X (..., n, d), C (k, d) → (..., n)
    int32."""
    Xf, Cf = X.float(), C.float()
    score = (Cf * Cf).sum(dim=1) - 2.0 * (Xf @ Cf.T)
    return torch.argmin(score, dim=-1).to(torch.int32)


def kmeans_assign(X: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid assignment.  X (n, d) or (P, n, d), C (k, d) →
    (n,) or (P, n) int32."""
    if X.ndim not in (2, 3) or C.ndim != 2 or X.shape[-1] != C.shape[1]:
        raise ValueError(f"shape mismatch: X{tuple(X.shape)} C{tuple(C.shape)}")
    if _build.on_cpu(X):
        return kmeans_assign_plain(X, C)
    flat = X.ndim == 2
    X3 = X.unsqueeze(0) if flat else X
    _build.check_cuda_operands(X3, C)
    P, n, d = X3.shape
    k = C.shape[0]
    if not 0 < k <= 2**31 - 1:
        raise ValueError(f"C{tuple(C.shape)}: the kernel takes 1 to 2³¹ − 1 "
                         f"centroids")
    Cf = C.float().contiguous()
    cn = (Cf * Cf).sum(dim=1)
    # the kernel reads C by TMA: rows of a multiple of 16 bytes, zeros past d
    ldc = -(-d // 4) * 4
    if ldc != d or Cf.data_ptr() % 16:
        Cp = torch.zeros((k, ldc), dtype=torch.float32, device=X.device)
        Cp[:, :d] = Cf
        Cf = Cp
    out = torch.empty((P, n), dtype=torch.int32, device=X.device)
    info = (_I32 * 3)()
    err = _lib().kmeans_assign_launch(
        _build.DTYPE_CODES[X3.dtype], X3.data_ptr(), X3.stride(0), X3.stride(1),
        Cf.data_ptr(), ldc, cn.data_ptr(), out.data_ptr(), P, n, d, k, info,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err:
        raise RuntimeError(f"kmeans_assign launch failed: CUDA error {err}")
    kmeans_assign.launches += 1
    kmeans_assign.forms["split" if info[0] else "stream"] += 1
    kmeans_assign.routes["tma" if info[1] else "general"] += 1
    return out[0] if flat else out


kmeans_assign.launches = 0
kmeans_assign.forms = collections.Counter()
kmeans_assign.routes = collections.Counter()
