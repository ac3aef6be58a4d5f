"""Device selection and host-array conversion for the port's entry points.

No counterpart in ``src/repro/``: JAX places arrays on its default backend
implicitly.  The port is explicit instead.  Every entry point that creates
tensors (:meth:`MLNumericTable.from_numpy`, :class:`ModelPredictor`,
:func:`repro_torch.weights.from_reference`) takes ``device=``; ``None``
means the CUDA card, and with no card that raises rather than quietly
running on the CPU.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

__all__ = ["resolve_device", "to_tensor"]

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` is the CUDA card.

    Raises ``RuntimeError`` when ``device`` is ``None`` and no card is
    present — the CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def to_tensor(array, device: torch.device) -> torch.Tensor:
    """A copy of a host array as a tensor on ``device``.

    float64 becomes float32, as ``jnp.asarray`` does with 64-bit mode off,
    so the port and the reference see the same dtype for the same input;
    the copy never aliases the caller's array (again as ``jnp.asarray``)."""
    arr = np.asarray(array)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)
