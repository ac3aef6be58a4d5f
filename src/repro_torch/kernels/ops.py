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
accepted.  ``quantize_rows`` is a kernel here too, where the reference's is
jnp left to XLA (``kernels/quant_matmul.py``).  ``flash_attention_decode``
has no counterpart there: it is the same function as ``flash_attention``
for one query a row at its own position over a ring cache, the form a
continuous-batching decode step needs (``kernels/flash_attention.py``).
``lm_head`` has none either: the reference's head is a plain product left
to XLA, and the port's is a kernel that sums each logit in one order fixed
by D (``kernels/lm_head.py``).  Nor has ``quant_linear``: it is the
reference's ``quantize_rows`` → ``quant_matmul`` → ``astype`` for one to
three weights that read the same x, in one decode launch
(``kernels/quant_matmul.py``).
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention, flash_attention_decode
from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.kernels.lm_head import lm_head
from repro_torch.kernels.logreg_grad import logreg_grad
from repro_torch.kernels.quant_matmul import quant_linear, quant_matmul, quantize_rows
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_chunk_scan

__all__ = ["flash_attention", "flash_attention_decode", "kmeans_assign", "lm_head",
           "logreg_grad", "quant_linear", "quant_matmul", "quantize_rows", "rmsnorm",
           "ssd_chunk_scan"]
