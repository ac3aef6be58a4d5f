"""Parameter construction (counterpart: ``src/repro/models/params.py``).

Every leaf is made by :func:`linear` / :func:`table` / :func:`bias` /
:func:`ones_vec` / :func:`uniform` with the reference's initialisers
(fan-in-scaled normal for weights), drawn from
an explicit :class:`torch.Generator` on the device the generator lives on.
``jax.random`` and ``torch`` give different numbers from one seed, so a
test that compares the two packages carries the reference's weights across
(:func:`repro_torch.weights.lm_from_reference`) rather than re-drawing them.

The tree is nested dicts of tensors with the reference's key names.  The
reference also returns logical sharding axes; the port has no mesh yet
(ROADMAP.md, Queue 1), so there are none.  :func:`stack_bundles` stacks
per-period trees on a leading layer axis, as the reference does for its
``lax.scan``, so weights carry across one to one.

On the card the plain projection weights (:data:`PROJECTIONS`) are stored
in :func:`kernel_layout`: the same shape, with the contracted axes fastest,
which is the ``(N, K)`` row-major storage the products
(``kernels/fixed_linear.py``) read in place.  The weight is stored once.
:func:`place` is the one way a param tree reaches a device: ``init_model``
stacks its weights so on the card, and ``lm_from_reference`` and
``ServeEngine`` hand their trees to it.  The kernel's wrapper raises for a
weight on the card in any other storage.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["PROJECTIONS", "linear", "bias", "ones_vec", "table", "uniform", "kernel_layout",
           "in_kernel_layout", "place", "projection_contract", "stack_bundles"]

#: the plain projection weights the decode products read, by module and
#: name, with the number of their leading (contracted) axes
PROJECTIONS: Dict[str, Dict[str, int]] = {
    "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 2},
    "mlp": {"w_gate": 1, "w_up": 1, "w_down": 1},
    "ssd": {"wz": 1, "wx": 1, "wB": 1, "wC": 1, "wdt": 1, "w_out": 1},
}


def _normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def _he(gen: torch.Generator, shape: Sequence[int], fan_in: int,
        dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (_normal(gen, shape) * scale).to(dtype)


def linear(gen: torch.Generator, shape: Sequence[int],
           fan_in: Optional[int] = None,
           dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Dense weight with fan-in scaled normal init."""
    if fan_in is None:
        fan_in = shape[0]
    return _he(gen, shape, fan_in, dtype)


def bias(shape: Sequence[int], dtype: torch.dtype = torch.bfloat16,
         device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_vec(shape: Sequence[int], dtype: torch.dtype = torch.bfloat16,
             device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def uniform(gen: torch.Generator, shape: Sequence[int], low: float,
            high: float) -> torch.Tensor:
    """fp32 drawn uniformly from [low, high), as ``jax.random.uniform``
    (the SSD layer's decay rates)."""
    return torch.rand(tuple(shape), generator=gen, device=gen.device,
                      dtype=torch.float32) * (high - low) + low


def table(gen: torch.Generator, shape: Sequence[int],
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Embedding table: unit-variance rows scaled by 1/sqrt(d)."""
    return (_normal(gen, shape) / math.sqrt(shape[-1])).to(dtype)


def projection_contract(path: Tuple[str, ...]) -> Optional[int]:
    """The contracted axes of the plain projection weight at ``path`` (the
    keys down to it, e.g. ``("b0", "attn", "wq")``), None for other leaves."""
    return PROJECTIONS.get(path[-2], {}).get(path[-1]) if len(path) >= 2 else None


def kernel_layout(w: torch.Tensor, n_contract: int, n_batch: int = 0) -> torch.Tensor:
    """``w`` (``*batch, *contracted, *out``) with the same shape and values,
    stored with the contracted axes fastest: ``(*batch, N, K)`` row-major
    underneath (a view of that, so nothing of the old storage is kept)."""
    lead = tuple(w.shape[:n_batch])
    K = math.prod(w.shape[n_batch:n_batch + n_contract])
    t = w.reshape(*lead, K, -1).transpose(-1, -2).contiguous()
    return t.transpose(-1, -2).reshape(w.shape)


def in_kernel_layout(w: torch.Tensor, n_contract: int, n_batch: int = 0) -> bool:
    """Whether ``w`` is stored as :func:`kernel_layout` stores it."""
    like = kernel_layout(torch.empty(w.shape, device="meta"), n_contract, n_batch)
    return w.stride() == like.stride()


def place(tree: Any, device: torch.device, path: Tuple[str, ...] = ()) -> Any:
    """A param tree (dicts of tensors, each projection stacked on a leading
    layer axis) on ``device``.  On the card every plain projection weight
    takes :func:`kernel_layout`, made where the weight lies before it moves
    (on the host for a tree from the host); any other leaf moves as it is."""
    if isinstance(tree, dict):
        return {k: place(v, device, path + (k,)) for k, v in tree.items()}
    nc = projection_contract(path) if device.type == "cuda" else None
    if nc is None or not isinstance(tree, torch.Tensor) or in_kernel_layout(tree, nc, 1):
        return tree.to(device)
    return kernel_layout(tree, nc, n_batch=1).to(device)


def _stack_kernel_layout(trees: Sequence[torch.Tensor], n_contract: int) -> torch.Tensor:
    """``kernel_layout(torch.stack(trees), n_contract, 1)``, written layer by
    layer into one allocation, as ``torch.stack`` would allocate."""
    shape = tuple(trees[0].shape)
    K = math.prod(shape[:n_contract])
    out = torch.empty((len(trees), math.prod(shape) // K, K), dtype=trees[0].dtype,
                      device=trees[0].device)
    for i, t in enumerate(trees):
        out[i].copy_(t.reshape(K, -1).t())
    return out.transpose(1, 2).reshape((len(trees),) + shape)


def stack_bundles(trees: Sequence[Dict[str, Any]],
                  n_contract: Optional[Callable[[Tuple[str, ...]], Optional[int]]] = None,
                  ) -> Dict[str, Any]:
    """Stack per-period param trees along a leading layer axis.  With
    ``n_contract`` (a leaf's key path → its contracted axes, or None), the
    leaves it names are stacked in :func:`kernel_layout`."""
    def stack(group, path):
        first = group[0]
        if isinstance(first, dict):
            return {k: stack([t[k] for t in group], path + (k,)) for k in first}
        nc = n_contract(path) if n_contract is not None else None
        if nc is None:
            return torch.stack(list(group), dim=0)
        return _stack_kernel_layout(group, nc)

    return stack(trees, ())
