"""Public wrappers of the port's kernels.

Counterpart: ``src/repro/kernels/ops.py`` (``flash_attention``,
``logreg_grad``, ``kmeans_assign``, ``quantize_rows``, ``quant_matmul``,
``rmsnorm`` and ``ssd_chunk_scan``), with the same shape validation and
error texts.  The reference falls back to its jnp oracle for shapes its TPU
blocks cannot tile (``flash_attention``: sequence lengths that do not
divide the blocks; ``ssd_chunk_scan``: when the chunk does not divide S),
and off the TPU takes ``quant_matmul`` in fp32; the port has none of these
fallbacks, because its kernels mask ragged shapes themselves, and
``ssd_chunk_scan`` raises when the chunk does not divide S.  A CUDA tensor
goes to the kernel, a CPU tensor to the plain version, and nothing else is
accepted.  ``flash_attention_decode`` has no counterpart there: it is the
same function as ``flash_attention`` for one query a row at its own
position over a ring cache, the form a continuous-batching decode step
needs (``kernels/flash_attention.py``).  ``lm_head`` has none either: the
reference's head is a plain product left to XLA, and the port's is a
kernel that sums each logit in one order fixed by D (``kernels/lm_head.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_decode
from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.kernels.lm_head import lm_head
from repro_torch.kernels.logreg_grad import logreg_grad
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_chunk_scan

__all__ = ["flash_attention", "flash_attention_decode", "kmeans_assign", "lm_head",
           "logreg_grad", "quant_matmul", "quantize_rows", "rmsnorm", "ssd_chunk_scan"]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-row int8 quantization: returns ``(xq, scale)`` with
    ``xq`` int8 of ``x.shape`` and ``scale`` fp32 of ``x.shape[:-1]`` such
    that ``xq * scale[..., None] ≈ x``.  The ``1e-8`` floor keeps all-zero
    rows from dividing by zero.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0 + 1e-8
    xq = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return xq, scale
