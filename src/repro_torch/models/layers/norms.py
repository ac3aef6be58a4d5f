"""RMSNorm / LayerNorm (counterpart: ``src/repro/models/layers/norms.py``).

The model's RMSNorm computes ``xf * rsqrt(mean(xf²) + eps) * (1 + scale)``
with fp32 statistics: that is the ``rmsnorm`` kernel's function with
``w = 1 + scale`` in fp32, with the products in the same order, so it goes
through ``ops.rmsnorm`` (kernel 5 of ROADMAP Queue 2) for every model,
which reads the bf16 scale and adds the 1 itself (``plus_one``).  The
kernel reduces each row in one fixed order that depends on the row width
alone, so a row's result is the same in a decode batch of 8 and of 1,
which the serving engine's continuous batching relies on.  Its plain
version (the CPU's) rounds the mean to fp32 from an fp64 sum, the
correctly rounded statistic (``kernels/rmsnorm.py`` says why).

At a decode step the block does not apply its RMSNorm itself: it hands the
layer a :class:`PreNorm` (the un-normed x and the norm's parameters), and
the layer's first plain-weight products take it whole, computing the norm
in their own launch (``ops.fixed_linear``'s ``norm=``), bitwise what
``rmsnorm`` would hand them.  Any other reader, the int8 groups included,
applies it with :meth:`PreNorm.apply` (the kernel, exactly as before).

``layernorm`` (Whisper's encoder and decoder) goes through
``ops.layernorm`` (``kernels/layernorm.py``): the mean and the centred
variance each summed in one fp32 order fixed by the row width, so a row's
result is the same in a decode batch of 8 and of 1; scale and bias are read
in their stored dtype.  Its plain version, the CPU's, takes the kernel's
order step for step.  At a decode step it is applied in front of the layer
(no product folds a LayerNorm in).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.params import bias, ones_vec

__all__ = ["PreNorm", "rmsnorm_init", "rmsnorm", "layernorm_init", "layernorm"]


def rmsnorm_init(d: int, dtype=torch.bfloat16, device=None):
    return {"scale": ones_vec((d,), dtype, device)}


def rmsnorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return ops.rmsnorm(x, params["scale"], eps=eps, plus_one=True)


class PreNorm(NamedTuple):
    """The model's RMSNorm of ``x`` (``(1 + scale)`` form), not applied yet:
    a decode step's products fold it into their own launch.  ``shape``,
    ``dtype`` and ``device`` are x's."""
    x: torch.Tensor
    scale: torch.Tensor
    eps: float

    @property
    def shape(self) -> torch.Size:
        return self.x.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.x.dtype

    @property
    def device(self) -> torch.device:
        return self.x.device

    @property
    def norm(self) -> Tuple[torch.Tensor, float, bool]:
        """The kernels' ``norm=`` argument."""
        return self.scale, self.eps, True

    def apply(self) -> torch.Tensor:
        """The normed x, through the ``rmsnorm`` kernel."""
        return rmsnorm({"scale": self.scale}, self.x, self.eps)


def layernorm_init(d: int, dtype=torch.bfloat16, device=None):
    return {"scale": ones_vec((d,), dtype, device),
            "bias": bias((d,), dtype, device)}


def layernorm(params: Dict[str, torch.Tensor], x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    return ops.layernorm(x, params["scale"], params["bias"], eps=eps)
