"""Fused logistic-regression gradient — the paper's §IV-A inner loop — as two
hand-written CUDA kernels for Hopper, with their plain PyTorch versions.

Counterpart: ``src/repro/kernels/logreg_grad.py`` (``logreg_margin``,
``logreg_xt_z``, ``logreg_grad_pallas``) and the oracle ``logreg_grad_ref``
of ``src/repro/kernels/ref.py``.

    pass 1 (margin):   z = σ(Xw) − y      kernel ``logreg_margin``
    pass 2 (gradient): g = Xᵀz            kernel ``logreg_xt_z``

Both kernels (``csrc/logreg_grad.cu``, where the design is described) read X
once and are bound by its bytes.  They take a leading partition dimension,
X ``(P, n, d)``, so one launch serves every partition of a runner round;
a 2-D X is one partition.  X may be a strided view (the feature columns of
a table whose column 0 is the label) as long as its last dimension is
contiguous, and fp32 or bf16; the margin and the gradient are fp32.

Each wrapper runs its kernel for a CUDA tensor and the plain version for a
CPU tensor, and raises for anything else: a CUDA tensor never reaches the
plain version.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["logreg_margin", "logreg_xt_z", "logreg_grad",
           "logreg_margin_plain", "logreg_xt_z_plain", "logreg_grad_plain"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("logreg_grad")
        lib.logreg_margin_scratch.argtypes = [_I32, _I32, _I32,
                                              ctypes.POINTER(_I64),
                                              ctypes.POINTER(_I64)]
        lib.logreg_margin_scratch.restype = None
        lib.logreg_margin_launch.argtypes = [_I32, _P, _I64, _I64, _P, _I64,
                                             _P, _P, _P, _P, _I32, _I32, _I32,
                                             _P]
        lib.logreg_margin_launch.restype = _I32
        lib.logreg_xt_z_launch.argtypes = [_I32, _P, _I64, _I64, _P, _P,
                                           _I32, _I32, _I32, _P]
        lib.logreg_xt_z_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


# --------------------------------------------------------------------------- #
# shapes
# --------------------------------------------------------------------------- #
def _check_logreg(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> None:
    """The reference's shape check (``kernels/ops.py``), widened to a
    leading partition dimension: X (n, d) with y (n,), w (d,); or X
    (P, n, d) with y (P, n) and w (d,) shared or (P, d) per partition."""
    if X.ndim == 2:
        n, d = X.shape
        ok = tuple(y.shape) == (n,) and tuple(w.shape) == (d,)
    elif X.ndim == 3:
        P, n, d = X.shape
        ok = tuple(y.shape) == (P, n) and tuple(w.shape) in ((d,), (P, d))
    else:
        ok = False
    if not ok:
        raise ValueError(f"shape mismatch: X{tuple(X.shape)} y{tuple(y.shape)} "
                         f"w{tuple(w.shape)}")


def _as_parts(X: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(P, n, d) view of X and whether X was 2-D (one partition)."""
    return (X.unsqueeze(0), True) if X.ndim == 2 else (X, False)


# --------------------------------------------------------------------------- #
# plain versions (CPU tensors; the card compares the kernels against them)
# --------------------------------------------------------------------------- #
def logreg_margin_plain(X: torch.Tensor, y: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """z = σ(Xw) − y in fp32; shapes as :func:`logreg_margin`."""
    Xf, wf = X.float(), w.float()
    if wf.ndim == 2:                       # per-partition weights
        margin = (Xf @ wf.unsqueeze(-1)).squeeze(-1)
    else:
        margin = Xf @ wf
    return torch.sigmoid(margin) - y.float()


def logreg_xt_z_plain(X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """g = Xᵀz in fp32; shapes as :func:`logreg_xt_z`."""
    return (X.float().transpose(-1, -2) @ z.float().unsqueeze(-1)).squeeze(-1)


def logreg_grad_plain(X: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (1): ∇f = Xᵀ(σ(Xw) − y), cast to ``w.dtype``."""
    return logreg_xt_z_plain(X, logreg_margin_plain(X, y, w)).to(w.dtype)


# --------------------------------------------------------------------------- #
# kernel wrappers
# --------------------------------------------------------------------------- #
def logreg_margin(X: torch.Tensor, y: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """z = σ(Xw) − y.  X (n, d) or (P, n, d); y (n,) or (P, n); w (d,)
    shared or (P, d) per partition → z (n,) or (P, n) fp32."""
    _check_logreg(X, y, w)
    if _build.on_cpu(X):
        return logreg_margin_plain(X, y, w)
    X3, flat = _as_parts(X)
    _build.check_cuda_operands(X3, y, w)
    P, n, d = X3.shape
    yf = y.reshape(P, n).float().contiguous()
    wf = w.float().contiguous()
    z = torch.empty((P, n), dtype=torch.float32, device=X.device)
    lib = _lib()
    n_partial, n_tickets = _I64(), _I64()
    lib.logreg_margin_scratch(P, n, d, ctypes.byref(n_partial),
                              ctypes.byref(n_tickets))
    partial = torch.empty(n_partial.value, dtype=torch.float32, device=X.device)
    tickets = torch.zeros(n_tickets.value, dtype=torch.int32, device=X.device)
    err = lib.logreg_margin_launch(
        _build.DTYPE_CODES[X3.dtype], X3.data_ptr(), X3.stride(0), X3.stride(1),
        wf.data_ptr(), d if wf.ndim == 2 else 0, yf.data_ptr(), z.data_ptr(),
        partial.data_ptr(), tickets.data_ptr(), P, n, d,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err:
        raise RuntimeError(f"logreg_margin launch failed: CUDA error {err}")
    logreg_margin.launches += 1
    return z[0] if flat else z


logreg_margin.launches = 0


def logreg_xt_z(X: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """g = Xᵀz.  X (n, d) or (P, n, d); z (n,) or (P, n) → g (d,) or
    (P, d) fp32: each partition's own sum over its rows."""
    if X.ndim not in (2, 3) or tuple(z.shape) != tuple(X.shape[:-1]):
        raise ValueError(f"shape mismatch: X{tuple(X.shape)} z{tuple(z.shape)}")
    if _build.on_cpu(X):
        return logreg_xt_z_plain(X, z)
    X3, flat = _as_parts(X)
    _build.check_cuda_operands(X3, z)
    P, n, d = X3.shape
    zf = z.reshape(P, n).float().contiguous()
    g = torch.empty((P, d), dtype=torch.float32, device=X.device)
    err = _lib().logreg_xt_z_launch(
        _build.DTYPE_CODES[X3.dtype], X3.data_ptr(), X3.stride(0), X3.stride(1),
        zf.data_ptr(), g.data_ptr(), P, n, d,
        torch.cuda.current_stream(X.device).cuda_stream)
    if err:
        raise RuntimeError(f"logreg_xt_z launch failed: CUDA error {err}")
    logreg_xt_z.launches += 1
    return g[0] if flat else g


logreg_xt_z.launches = 0


def logreg_grad(X: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """Full fused gradient ∇f = Xᵀ(σ(Xw) − y): the two kernels chained,
    fp32, cast to ``w.dtype`` (the reference's ``logreg_grad_pallas``).
    With a partition dimension the result is per partition, (P, d)."""
    return logreg_xt_z(X, logreg_margin(X, y, w)).to(w.dtype)
