"""Public wrappers of the main path's kernels.

Counterpart: ``src/repro/kernels/ops.py`` (``logreg_grad`` and
``kmeans_assign``), with the same shape validation and error texts.  The
reference falls back to its jnp oracle for shapes its TPU blocks cannot
tile; the port has no such fallback, because its kernels mask ragged rows,
columns and centroids themselves and take every shape.  A CUDA tensor goes
to the kernel, a CPU tensor to the plain version, and nothing else is
accepted.  The remaining kernels of the reference (``flash_attention``,
``quant_matmul``, ``rmsnorm``, ``ssd_chunk_scan``) are later slices.
"""
from __future__ import annotations

from repro_torch.kernels.kmeans_assign import kmeans_assign
from repro_torch.kernels.logreg_grad import logreg_grad

__all__ = ["kmeans_assign", "logreg_grad"]
