"""The RG-LRU recurrence of a prefill as a hand-written CUDA kernel for
Hopper, with its plain PyTorch version.

No TPU kernel: the reference's ``rglru_apply``
(``src/repro/models/layers/rglru.py``) takes the recurrence as
``jax.lax.associative_scan`` over time, left to XLA.  The port's recurrent
blocks prefill each request alone, and a PyTorch loop over the prompt would
be thousands of launches a layer, so the scan is a kernel
(``csrc/rglru_scan.cu``, where its design and bound are described):

    h_t = a_t · h_{t−1} + b_t        per (row, channel), h_{−1} = h0 or 0

in IEEE fp32, each step a multiply then an add (never an FMA), in time
order: the arithmetic of the decode step (``models/layers/rglru.py``), so
a prefilled state is bitwise the one token-by-token steps reach.  a and b
are (B, S, r) fp32, h0 (B, r) fp32 or None; it returns every h_t (B, S, r)
and the final state (B, r).  The associative scan of the reference pairs
the terms in a tree instead and lies within fp32 rounding of this one.

The wrapper runs the kernel for a CUDA tensor and the plain version for a
CPU tensor, and raises for anything else.  ``rglru_scan.launches`` counts
launches and ``rglru_scan.shapes`` counts them by ``(B, S, r, h0 given)``.
The plain version is the same loop in PyTorch, a multiply and an add a
step; on the card it is the kernel's oracle (bitwise), never on the
serving path.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["rglru_scan", "rglru_scan_plain"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("rglru_scan")
        lib.rglru_scan_launch.argtypes = [_P] * 5 + [_I32] * 3 + [_P]
        lib.rglru_scan_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


def _check(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor]) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a{tuple(a.shape)} and b{tuple(b.shape)} must both be (B, S, r)")
    if h0 is not None and tuple(h0.shape) != (a.shape[0], a.shape[2]):
        raise ValueError(f"h0{tuple(h0.shape)} must be ({a.shape[0]}, {a.shape[2]})")
    for t in (a, b) + (() if h0 is None else (h0,)):
        if t.dtype != torch.float32:
            raise TypeError(f"a, b and h0 must be float32, got {t.dtype}")


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence step by step: a multiply, then an add."""
    _check(a, b, h0)
    h = torch.zeros_like(a[:, 0]) if h0 is None else h0
    hs = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = h * a[:, t] + b[:, t]
        hs[:, t] = h
    return hs, h.clone()


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t · h_{t−1} + b_t`` over S: a, b (B, S, r) fp32, h0 (B, r)
    or None (zeros) → (every h_t (B, S, r), the last (B, r))."""
    _check(a, b, h0)
    if _build.on_cpu(a):
        return rglru_scan_plain(a, b, h0)
    for t in (b,) + (() if h0 is None else (h0,)):
        if t.device != a.device:
            raise ValueError(f"operands on {t.device} and {a.device}")
    B, S, r = a.shape
    if min(B, S, r) == 0:
        raise ValueError(f"empty operand: (B, S, r) = ({B}, {S}, {r})")
    if B > 65535 or max(S, r) > 2**31 - 1:
        raise ValueError(f"(B, S, r) = ({B}, {S}, {r}) exceeds the kernel's grid or "
                         f"32-bit sizes")
    a, b = a.contiguous(), b.contiguous()
    h0c = None if h0 is None else h0.contiguous()
    hs = torch.empty_like(a)
    last = torch.empty((B, r), dtype=torch.float32, device=a.device)
    err = _lib().rglru_scan_launch(a.data_ptr(), b.data_ptr(),
                                   None if h0c is None else h0c.data_ptr(), hs.data_ptr(),
                                   last.data_ptr(), B, S, r,
                                   torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    rglru_scan.launches += 1
    rglru_scan.shapes[(B, S, r, h0 is not None)] += 1
    return hs, last


rglru_scan.launches = 0
rglru_scan.shapes = collections.Counter()
