"""LayerNorm as a hand-written CUDA kernel for Hopper, with its plain
PyTorch version.

No TPU kernel: the reference's ``layernorm``
(``src/repro/models/layers/norms.py:32-39``) is jnp left to XLA.  Whisper's
encoder-decoder runs 62 of them a forward, and the serving path needs each
row's statistics independent of the rows beside it (a decode batch of 8
must give each row its bits alone), so the port takes them in one fixed
fp32 order in a kernel (``csrc/layernorm.cu``, where its design and bound
are described):

    out = ((x − μ) · (1 / sqrt(var + eps))) · scale + bias

per row of the last axis, μ and the centred variance ``var`` each the
row's sum divided by d, with fp32 statistics, scale and bias read as fp32,
the output in ``x``'s dtype, and each step one IEEE rounding in that order
(never an FMA).  ``x`` is fp32 or bf16, any leading shape; scale and bias
(d,) fp32 or bf16, one dtype for both.

The order.  A row is cut into chunks of 16 bytes (4 fp32 or 8 bf16
elements); chunk c belongs to thread c mod 256 of the launch's block, each
thread adds its chunks' elements in order (the variance its elements'
``(x − μ)²``, a multiply then an add), each warp of 32 threads adds its
sums in an xor butterfly (offsets 16, 8, 4, 2, 1), and the 8 warp sums are
added in warp order.  It depends on d and x's dtype alone, never on the
number of rows.

The plain version takes the same order step for step in PyTorch, so on the
CPU it gives the kernel's bits (the card checks how close it comes); it
runs on the CPU and as the card's oracle, never on the card's serving path.
The wrapper runs the kernel for a CUDA tensor and the plain version for a
CPU tensor, and raises for anything else.  ``layernorm.launches`` counts
launches and ``layernorm.shapes`` counts them by ``(rows, d, dtype)``.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["layernorm", "layernorm_plain"]

#: threads a row is cut over, and warps of 32 among them (csrc/common.cuh)
THREADS = 256
WARPS = THREADS // 32
#: elements in a 16-byte chunk, by x's dtype
CHUNK = {torch.float32: 4, torch.bfloat16: 8}

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        lib = _build.load("layernorm")
        lib.layernorm_launch.argtypes = [_I32] * 2 + [_P] * 4 + [_I32] * 2 + [ctypes.c_float,
                                                                             _P]
        lib.layernorm_launch.restype = _I32
        _lib_handle = lib
    return _lib_handle


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> None:
    if x.ndim == 0 or tuple(scale.shape) != (x.shape[-1],) or bias.shape != scale.shape:
        raise ValueError(f"scale {tuple(scale.shape)} and bias {tuple(bias.shape)} vs x "
                         f"feature dim {x.shape[-1] if x.ndim else None}")
    if x.dtype not in CHUNK:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if scale.dtype not in CHUNK or bias.dtype != scale.dtype:
        raise TypeError(f"scale and bias must be one of float32 and bfloat16, got "
                        f"{scale.dtype} and {bias.dtype}")


def _row_sums(v: torch.Tensor, chunk: int) -> torch.Tensor:
    """(R, d) fp32 → (R,) fp32: each row summed in the kernel's order."""
    R, d = v.shape
    span = THREADS * chunk
    n = -(-d // span)
    padded = torch.zeros((R, n * span), dtype=torch.float32, device=v.device)
    padded[:, :d] = v
    # (chunk pass, element of the chunk, row, thread)
    parts = padded.view(R, n, THREADS, chunk).permute(1, 3, 0, 2).contiguous()
    s = torch.zeros((R, THREADS), dtype=torch.float32, device=v.device)
    for i in range(n):                       # a thread's chunks, in order
        for j in range(chunk):
            s = s + parts[i, j]
    for off in (16, 8, 4, 2, 1):             # the warp's xor butterfly: lane l
        partner = s.view(R, WARPS, 32 // (2 * off), 2, off).flip(3)   # gets l ^ off
        s = s + partner.reshape(R, THREADS)
    t = s[:, 0]
    for w in range(1, WARPS):                # the warps in order
        t = t + s[:, 32 * w]
    return t


def layernorm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function, in its order, in PyTorch fp32."""
    _check(x, scale, bias)
    d = x.shape[-1]
    chunk = CHUNK[x.dtype]
    x32 = x.reshape(-1, d).float()
    # divisions by tensors: PyTorch divides a CUDA tensor by a scalar as a
    # product with its reciprocal, which is not the kernel's IEEE division
    width = torch.full((x32.shape[0], 1), float(d), device=x.device)
    mu = _row_sums(x32, chunk)[:, None] / width
    c = x32 - mu
    var = _row_sums(c * c, chunk)[:, None] / width
    r = torch.ones_like(var) / torch.sqrt(var + eps)
    out = c * r * scale.float() + bias.float()
    return out.to(x.dtype).reshape(x.shape)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis.  x (..., d) fp32 or bf16, scale and
    bias (d,) fp32 or bf16 → x's shape and dtype."""
    _check(x, scale, bias)
    if _build.on_cpu(x):
        return layernorm_plain(x, scale, bias, eps)
    for t in (scale, bias):
        if t.device != x.device:
            raise ValueError(f"operands on {t.device} and {x.device}")
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0 or d == 0:
        raise ValueError(f"empty x{tuple(x.shape)}")
    if rows > 2**31 - 1 or d > 2**31 - 1:
        raise ValueError(f"x{tuple(x.shape)} exceeds the kernel's grid")
    xc, sc, bc = x.contiguous(), scale.contiguous(), bias.contiguous()
    out = torch.empty_like(xc)
    err = _lib().layernorm_launch(
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[sc.dtype], xc.data_ptr(),
        sc.data_ptr(), bc.data_ptr(), out.data_ptr(), rows, d, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"layernorm launch failed: CUDA error {err}")
    layernorm.launches += 1
    layernorm.shapes[(rows, d, str(x.dtype).split(".")[-1])] += 1
    return out


layernorm.launches = 0
layernorm.shapes = collections.Counter()
