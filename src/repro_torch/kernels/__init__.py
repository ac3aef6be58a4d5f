"""Hand-written CUDA kernels of the port (counterpart: ``src/repro/kernels/``).

Each kernel module holds the wrapper, its plain PyTorch version and a
launch count (``<wrapper>.launches``); the CUDA sources are under
``csrc/`` and are built on first use by :mod:`repro_torch.kernels._build`.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import kmeans_assign as _kmeans_assign
from repro_torch.kernels import logreg_grad as _logreg_grad
from repro_torch.kernels import quant_matmul as _quant_matmul
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd_scan

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

#: every kernel wrapper of the package, by kernel name
KERNELS = {
    "logreg_margin": _logreg_grad.logreg_margin,
    "logreg_xt_z": _logreg_grad.logreg_xt_z,
    "kmeans_assign": _kmeans_assign.kmeans_assign,
    "quant_matmul": _quant_matmul.quant_matmul,
    "rmsnorm": _rmsnorm.rmsnorm,
    "ssd_chunk_scan": _ssd_scan.ssd_chunk_scan,
    "flash_attention": _flash_attention.flash_attention,
    "flash_attention_decode": _flash_attention.flash_attention_decode,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
