"""The LM head as a hand-written CUDA kernel for Hopper, with its plain
PyTorch version.

No TPU kernel: the reference's ``logits_from``
(``src/repro/models/layers/embedding.py:34-40``) is an einsum with
``preferred_element_type=float32`` on bf16 operands, which it leaves to
XLA.  Each product of two bf16 values is exact in fp32, so only the
summation order is free, and the port fixes it: the kernel
(``csrc/lm_head.cu``, where its design and bound are described) sums every
logit in one order that depends on D alone, so a row's logits are bitwise
the same at M = 1 and M = 8 — the batch invariance the serving engine's
continuous batching needs to give the slot-at-a-time oracle's greedy
streams.

    tied     logits = x @ W.T     x (M, D), W (V, D), the token table
    untied   logits = x @ H       H (D, V), the head table

x and the table share a dtype, fp32 or bf16; the logits are fp32.  Each
(dtype, form) takes one route (:func:`route`):

* bf16, tied — every served model's head — ``"mma_bf16"``: the tensor
  cores (``mma.sync`` m16n8k16, bf16 operands), each k16 step summed from
  zero by the tensor core and added to the logit's fp32 sum in index order;
* fp32, tied, and untied in either dtype — ``"fma"``: IEEE fp32 FMA on the
  SIMT pipe (the port keeps fp32 operands off the tensor cores; no served
  model is untied).

The kernel takes contiguous operands with D (tied) or V (untied) a
multiple of 8; the wrapper copies a non-contiguous or misaligned operand
and raises for the rest.  It runs the kernel for a CUDA tensor and the
plain version for a CPU tensor, and raises for anything else.
``lm_head.launches`` counts launches, ``lm_head.shapes`` counts them by
``(M, D, V, tied)`` and ``lm_head.routes`` by route.

The plain version sums in fp64 and rounds to fp32: the correctly rounded
logit, which the kernel's fp32 chain comes within a few ulps of.  It is
the product the port's head computed before this kernel, so the CPU parity
tests against the reference read what they read then.  It runs on the CPU
and as the card's oracle, never on the card's serving path.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["lm_head", "lm_head_plain"]

#: elements a lane loads at once; D (tied) or V (untied) must be a multiple
_VEC = 8
# the widest D whose 8-row tile of x fits the kernel's shared memory
_D_MAX = 227 * 1024 // (8 * 4)

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("lm_head")
        lib.lm_head_launch.argtypes = [_I32, _I32, _P, _P, _P, _I32, _I32, _I32, _P]
        lib.lm_head_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


def _check_shapes(x: torch.Tensor, w: torch.Tensor, tied: bool) -> None:
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x{tuple(x.shape)} and the table{tuple(w.shape)} must be 2-D")
    D = w.shape[1] if tied else w.shape[0]
    if x.shape[1] != D:
        raise ValueError(f"x{tuple(x.shape)} does not match the "
                         f"{'tied (V, D)' if tied else 'untied (D, V)'} table"
                         f"{tuple(w.shape)}")


def lm_head_plain(x: torch.Tensor, w: torch.Tensor, *, tied: bool) -> torch.Tensor:
    """The head's function, summed in fp64 and rounded to fp32."""
    _check_shapes(x, w, tied)
    wd = w.double()
    return torch.matmul(x.double(), wd.T if tied else wd).float()


def route(dtype: torch.dtype, tied: bool) -> str:
    """The route a CUDA call with these operands takes: ``"mma_bf16"`` (the
    tensor cores) for bf16 tied, ``"fma"`` (the SIMT pipe) otherwise."""
    return "mma_bf16" if dtype == torch.bfloat16 and tied else "fma"


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def lm_head(x: torch.Tensor, w: torch.Tensor, *, tied: bool) -> torch.Tensor:
    """fp32 logits (M, V) of x (M, D) against the tied table W (V, D) or
    the untied head H (D, V)."""
    _check_shapes(x, w, tied)
    if _build.on_cpu(x):
        return lm_head_plain(x, w, tied=tied)
    if x.dtype not in _build.DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and the table must share a dtype, float32 or bfloat16; "
                        f"got {x.dtype} and {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"operands on {w.device} and {x.device}")
    M, D = x.shape
    V = w.shape[0] if tied else w.shape[1]
    if min(M, D, V) == 0:
        raise ValueError(f"empty operand: (M, D, V) = ({M}, {D}, {V})")
    if (D if tied else V) % _VEC:
        raise ValueError(f"the kernel takes {'D' if tied else 'V'} a multiple of "
                         f"{_VEC}: (M, D, V) = ({M}, {D}, {V})")
    if D > _D_MAX or max(M, V) > 2**31 - 1 or M > 8 * 65535:
        raise ValueError(f"(M, D, V) = ({M}, {D}, {V}) exceeds the kernel's limits")
    x, w = _aligned(x), _aligned(w)
    out = torch.empty((M, V), dtype=torch.float32, device=x.device)
    err = _lib().lm_head_launch(
        _build.DTYPE_CODES[x.dtype], int(bool(tied)), x.data_ptr(), w.data_ptr(),
        out.data_ptr(), M, V, D, torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"lm_head launch failed: CUDA error {err}")
    lm_head.launches += 1
    lm_head.shapes[(M, D, V, bool(tied))] += 1
    lm_head.routes[route(x.dtype, tied)] += 1
    return out


lm_head.launches = 0
lm_head.shapes = collections.Counter()
lm_head.routes = collections.Counter()
