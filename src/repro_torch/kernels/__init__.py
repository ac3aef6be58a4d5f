"""Hand-written CUDA kernels of the port (counterpart: ``src/repro/kernels/``).

Each kernel module holds the wrapper, its plain PyTorch version and a
launch count (``<wrapper>.launches``); the CUDA sources are under
``csrc/`` and are built on first use by :mod:`repro_torch.kernels._build`.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import fixed_linear as _fixed_linear
from repro_torch.kernels import flash_attention as _flash_attention
from repro_torch.kernels import kmeans_assign as _kmeans_assign
from repro_torch.kernels import lm_head as _lm_head
from repro_torch.kernels import logreg_grad as _logreg_grad
from repro_torch.kernels import quant_matmul as _quant_matmul
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import ssd_scan as _ssd_scan

__all__ = ["KERNELS", "launch_counts", "reset_launch_counts"]

#: every kernel wrapper of the package, by kernel name
KERNELS = {
    "logreg_grad": _logreg_grad.logreg_grad,
    "logreg_margin": _logreg_grad.logreg_margin,
    "logreg_xt_z": _logreg_grad.logreg_xt_z,
    "kmeans_assign": _kmeans_assign.kmeans_assign,
    "quant_matmul": _quant_matmul.quant_matmul,
    "quant_linear": _quant_matmul.quant_linear,
    "quantize_rows": _quant_matmul.quantize_rows,
    "rmsnorm": _rmsnorm.rmsnorm,
    "ssd_chunk_scan": _ssd_scan.ssd_chunk_scan,
    "ssd_decode": _ssd_scan.ssd_decode,
    "flash_attention": _flash_attention.flash_attention,
    "flash_attention_decode": _flash_attention.flash_attention_decode,
    "lm_head": _lm_head.lm_head,
    "fixed_linear": _fixed_linear.fixed_linear,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every launch count to 0, and clear the route counts of
    ``logreg_grad``, ``flash_attention``'s prefill form, ``fixed_linear``
    and ``kmeans_assign`` (``.routes``) and ``kmeans_assign``'s form counts
    (``.forms``)."""
    for fn in KERNELS.values():
        fn.launches = 0
    for fn in (_logreg_grad.logreg_grad, _flash_attention.flash_attention,
               _fixed_linear.fixed_linear, _kmeans_assign.kmeans_assign):
        fn.routes.clear()
    _kmeans_assign.kmeans_assign.forms.clear()
