"""Sums whose order is fixed by the width alone, for served predictions.

No counterpart in ``src/repro/``: the reference's ``jnp.sum`` and ``x @ w``
leave the order to XLA.  PyTorch's reductions and cuBLAS pick theirs by
shape, so a row summed in a microbatch of 16 and in a table of 65,536 can
differ in the last bit.  The models whose ``predict`` is served
(``MatrixFactorizationModel``, ``GeneralizedLinearModel``,
``NaiveBayesModel``) sum through :func:`fixed_sum` instead: elementwise adds
of halves, an order that depends on the width and never on the rows, so a
served row is bitwise its offline prediction on every device.
"""
from __future__ import annotations

import torch

__all__ = ["fixed_sum", "fixed_dot"]

# elements of the (rows, d) product :func:`fixed_dot` holds at once
_CHUNK_ELEMENTS = 1 << 27


def fixed_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension in a pairwise order fixed by its width:
    element i is added to element i + w//2 until one is left; at an odd
    width the last element is carried to the next level unchanged."""
    if x.shape[-1] == 0:
        return x.sum(-1)
    while x.shape[-1] > 1:
        w = x.shape[-1]
        h = w // 2
        y = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([y, x[..., 2 * h:]], dim=-1) if w % 2 else y
    return x[..., 0]


def fixed_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Rows ``x`` (n, d), or one row (d,), dotted with ``w`` (d,) in
    :func:`fixed_sum`'s order; the (rows, d) products are formed over row
    chunks of at most ``_CHUNK_ELEMENTS``."""
    if x.ndim == 1:
        return fixed_sum(x * w)
    step = max(1, _CHUNK_ELEMENTS // max(1, x.shape[-1]))
    if x.shape[0] <= step:
        return fixed_sum(x * w)
    return torch.cat([fixed_sum(x[i:i + step] * w)
                      for i in range(0, x.shape[0], step)])
