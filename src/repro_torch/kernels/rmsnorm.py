"""RMSNorm as a hand-written CUDA kernel for Hopper, with its plain
PyTorch version.

Counterpart: ``src/repro/kernels/rmsnorm.py`` (``rmsnorm_pallas``) and the
oracle ``rmsnorm_ref`` of ``src/repro/kernels/ref.py``, wrapped by
``ops.rmsnorm`` there (``src/repro/kernels/ops.py:127``).

    out = x · rsqrt(mean(x²) + eps) · w

per row of the last axis: fp32 statistics, ``w`` read as fp32, the output
in ``x``'s dtype, the products in that order.  ``plus_one=True`` takes
``w = 1 + weight`` in fp32, the models' ``(1 + scale)`` form, with the
addition done in the kernel, and ``weight`` may be stored as fp32 or bf16,
so a model's norm costs one launch and no fp32 copy of its scale.  The kernel
(``csrc/rmsnorm.cu``, where its design and bound are described) reduces
each row in one fixed order that depends on the row width alone, so a
row's result does not depend on how many rows share the launch.  ``x`` is
fp32 or bf16, any leading shape.  The wrapper runs the kernel for a CUDA
tensor and the plain version for a CPU tensor, and raises for anything
else.  ``rmsnorm.launches`` counts launches and ``rmsnorm.shapes`` counts
them by ``(rows, d, dtype)``.

The plain version takes the sum of squares in fp64 and rounds the mean to
fp32: the correctly rounded fp32 statistic, which the reference's fp32 sum
(XLA's order) and the kernel's fixed-order fp32 sum each come within a few
ulps of.  An fp32 sum in PyTorch's own order is no nearer either of them,
and on random weights the int8 path turns those ulps into visibly other
logits: at 28 layers (tests/test_torch_lm.py::
test_int8_logit_error_grows_with_depth) the port's int8 error reads 0.6397
that way against the reference's 0.6407, and 0.6407 with the rounded
statistic.  The plain version runs on the CPU and as the card's oracle,
never on the card's serving path.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["rmsnorm", "rmsnorm_plain"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("rmsnorm")
        lib.rmsnorm_launch.argtypes = [_I32] * 3 + [_P] * 3 + [_I32] * 2 + [ctypes.c_float, _P]
        lib.rmsnorm_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


def _check_shapes(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.ndim == 0 or tuple(weight.shape) != (x.shape[-1],):
        raise ValueError(f"weight {tuple(weight.shape)} vs x feature dim "
                         f"{x.shape[-1] if x.ndim else None}")


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *,
                  plus_one: bool = False) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps) · w with fp32 statistics — the reference's
    oracle, with the mean correctly rounded to fp32 (summed in fp64)."""
    _check_shapes(x, weight)
    x32 = x.float()
    var = x32.double().square().mean(dim=-1, keepdim=True).float()
    w = 1.0 + weight.float() if plus_one else weight.float()
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6, *,
            plus_one: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis.  x (..., d) fp32 or bf16, weight (d,)
    fp32 or bf16 (taken as ``1 + weight`` with ``plus_one``) → x's shape
    and dtype."""
    _check_shapes(x, weight)
    if _build.on_cpu(x):
        return rmsnorm_plain(x, weight, eps, plus_one=plus_one)
    for t in (x, weight):
        if t.dtype not in _build.DTYPE_CODES:
            raise TypeError(f"x and weight must be float32 or bfloat16, got {t.dtype}")
    if weight.device != x.device:
        raise ValueError(f"operands on {weight.device} and {x.device}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        raise ValueError(f"empty x{tuple(x.shape)}")
    if rows > 2**31 - 1 or d > 2**31 - 1:
        raise ValueError(f"x{tuple(x.shape)} exceeds the kernel's grid")
    xc, wc = x.contiguous(), weight.contiguous()
    out = torch.empty_like(xc)
    err = _lib().rmsnorm_launch(
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[wc.dtype], int(plus_one),
        xc.data_ptr(), wc.data_ptr(), out.data_ptr(), rows, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {err}")
    rmsnorm.launches += 1
    rmsnorm.shapes[(rows, d, str(x.dtype).split(".")[-1])] += 1
    return out


rmsnorm.launches = 0
rmsnorm.shapes = collections.Counter()
