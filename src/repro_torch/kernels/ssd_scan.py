"""Mamba-2 SSD chunk scan as a hand-written CUDA kernel for Hopper, with
its plain PyTorch version.

Counterpart: ``src/repro/kernels/ssd_scan.py`` (``ssd_chunk_scan``) and the
oracle ``ssd_chunk_scan_ref`` of ``src/repro/kernels/ref.py``, wrapped by
``ops.ssd_chunk_scan`` there (``src/repro/kernels/ops.py:135``).

The chunked dual form of arXiv:2405.21060: within a chunk of L steps the
output is the masked product ``(C·Bᵀ ⊙ decay) · Δx``, across chunks a
``(P, N)`` state is carried in order.  ``log_a`` is ``(B, H, S)``, ``dx``
``(B, H, S, P)``, ``Bm`` and ``Cm`` ``(B, S, N)``, ``h0`` ``(B, H, P, N)`` or
``None`` (zeros); the result is ``(y (B, H, S, P), h_final (B, H, P, N))``,
fp32 throughout.  ``L = min(chunk, S)`` must divide S: the reference falls
back to its oracle with L = S otherwise, the port raises (its caller, the
SSD layer, picks L = S itself in that case).

The kernel (``csrc/ssd_scan.cu``, where its design and bound are
described) takes P ≤ 64 and N ≤ 128 and any L that divides S; the wrapper
raises for a CUDA tensor outside that.  It runs the kernel for a CUDA
tensor and the plain version for a CPU tensor, and raises for anything
else.  ``ssd_chunk_scan.launches`` counts launches and
``ssd_chunk_scan.shapes`` counts them by ``(B, H, S, P, N, L, with h0)``.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["ssd_chunk_scan", "ssd_chunk_scan_plain"]

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_lib_handle = None
#: widths the kernel's shared-memory tiles hold
P_MAX, N_MAX = 64, 128


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("ssd_scan")
        lib.ssd_chunk_scan_launch.argtypes = [_P] * 8 + [_I32] * 6 + [_P]
        lib.ssd_chunk_scan_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


def _chunk_len(log_a, dx, Bm, Cm, h0, chunk: int) -> int:
    """The reference's shape checks, then L, which must divide S."""
    if dx.ndim != 4:
        raise ValueError(f"shape mismatch: dx{tuple(dx.shape)} must be (B, H, S, P)")
    B, H, S, P = dx.shape
    if tuple(log_a.shape) != (B, H, S) or tuple(Bm.shape[:2]) != (B, S):
        raise ValueError(f"shape mismatch: log_a{tuple(log_a.shape)} "
                         f"dx{tuple(dx.shape)} Bm{tuple(Bm.shape)}")
    if Bm.ndim != 3 or tuple(Cm.shape) != tuple(Bm.shape):
        raise ValueError(f"shape mismatch: Bm{tuple(Bm.shape)} Cm{tuple(Cm.shape)}")
    N = Bm.shape[-1]
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"shape mismatch: h0{tuple(h0.shape)} vs {(B, H, P, N)}")
    L = min(int(chunk), S)
    if L <= 0 or S % L:
        raise ValueError(f"S={S} must divide chunk {L}")
    return L


def ssd_chunk_scan_plain(log_a: torch.Tensor, dx: torch.Tensor, Bm: torch.Tensor,
                         Cm: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                         chunk: int = 64, dtype: torch.dtype = torch.float32,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's oracle, chunk by chunk in fp32 (or in ``dtype``:
    float64 gives the function's value to check fp32 results against)."""
    L = _chunk_len(log_a, dx, Bm, Cm, h0, chunk)
    B, H, S, P = dx.shape
    N = Bm.shape[-1]
    C = S // L
    la = log_a.reshape(B, H, C, L).to(dtype)
    dxc = dx.reshape(B, H, C, L, P).to(dtype)
    Bc = Bm.reshape(B, C, L, N).to(dtype)
    Cc = Cm.reshape(B, C, L, N).to(dtype)
    h = (torch.zeros((B, H, P, N), dtype=dtype, device=dx.device)
         if h0 is None else h0.to(dtype))
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dx.device))
    ys = []
    for c in range(C):
        cum = torch.cumsum(la[:, :, c], dim=-1)                       # (B,H,L)
        CB = torch.einsum("btn,bsn->bts", Cc[:, c], Bc[:, c])         # (B,L,L)
        decay = torch.exp(torch.clamp(cum[..., :, None] - cum[..., None, :], max=0.0))
        M = CB[:, None] * decay * causal
        y_intra = torch.einsum("bhts,bhsp->bhtp", M, dxc[:, :, c])
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "btn,bhpn->bhtp", Cc[:, c], h)
        w_tail = torch.exp(cum[..., -1:] - cum)                        # (B,H,L)
        h = h * torch.exp(cum[..., -1])[..., None, None] + torch.einsum(
            "bhs,bhsp,bsn->bhpn", w_tail, dxc[:, :, c], Bc[:, c])
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=2).reshape(B, H, S, P), h


def ssd_chunk_scan(log_a: torch.Tensor, dx: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                   chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD chunked scan.  log_a (B,H,S), dx (B,H,S,P), Bm/Cm
    (B,S,N), h0 (B,H,P,N) or None → (y (B,H,S,P), h_final (B,H,P,N)),
    fp32."""
    L = _chunk_len(log_a, dx, Bm, Cm, h0, chunk)
    if _build.on_cpu(dx):
        return ssd_chunk_scan_plain(log_a, dx, Bm, Cm, h0, chunk=L)
    B, H, S, P = dx.shape
    N = Bm.shape[-1]
    for t in (log_a, Bm, Cm) + (() if h0 is None else (h0,)):
        if t.device != dx.device:
            raise ValueError(f"operands on {t.device} and {dx.device}")
    if P > P_MAX or N > N_MAX or B > 65535:
        raise ValueError(f"P={P}, N={N}, B={B}: the kernel takes P ≤ {P_MAX}, "
                         f"N ≤ {N_MAX} and B ≤ 65535")
    if max(H, S) > 2**31 - 1:
        raise ValueError(f"H={H}, S={S} exceed the kernel's 32-bit grid")
    args = [t.float().contiguous() for t in (log_a, dx, Bm, Cm)]
    h0c = None if h0 is None else h0.float().contiguous()
    y = torch.empty((B, H, S, P), dtype=torch.float32, device=dx.device)
    h_fin = torch.empty((B, H, P, N), dtype=torch.float32, device=dx.device)
    cum = torch.empty((B, H, S), dtype=torch.float32, device=dx.device)
    err = _lib().ssd_chunk_scan_launch(
        *(t.data_ptr() for t in args), None if h0c is None else h0c.data_ptr(),
        y.data_ptr(), h_fin.data_ptr(), cum.data_ptr(), B, H, S, P, N, L,
        torch.cuda.current_stream(dx.device).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_chunk_scan launch failed: CUDA error {err}")
    ssd_chunk_scan.launches += 1
    ssd_chunk_scan.shapes[(B, H, S, P, N, L, h0 is not None)] += 1
    return y, h_fin


ssd_chunk_scan.launches = 0
ssd_chunk_scan.shapes = collections.Counter()
