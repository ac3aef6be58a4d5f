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
(ROADMAP.md, Queue 1), so there are none.  :class:`LayerStack` stacks
per-period trees on a leading layer axis, as the reference's
``stack_bundles`` does for its ``lax.scan``, so weights carry across one
to one; it takes a period, or one block of it, at a time, so a model is
drawn without ever holding its layers apart.

On the card the plain projection weights (:data:`PROJECTIONS`) are stored
in :func:`kernel_layout`: the same shape, with the contracted axes fastest,
which is the ``(N, K)`` row-major storage the products
(``kernels/fixed_linear.py``) read in place.  The weight is stored once.
An MoE block's experts (``moe/w_gate``, ``w_up``, ``w_down``: ``(E, d, f)``
and ``(E, f, d)`` a layer) keep their expert axis leading
(:data:`EXPERT_AXES`), so each expert's ``(d, f)`` is a view in that
storage; the router and the shared expert (``moe/shared``) are plain
projections.
:func:`place` is the one way a param tree reaches a device: ``init_model``
stacks its weights so on the card, and ``lm_from_reference`` and
``ServeEngine`` hand their trees to it.  The kernel's wrapper raises for a
weight on the card in any other storage.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

__all__ = ["PROJECTIONS", "EXPERT_AXES", "LayerStack", "linear", "bias", "ones_vec", "table",
           "uniform", "kernel_layout", "in_kernel_layout", "place", "projection_contract",
           "projection_layout"]

#: the plain projection weights the decode products read, by module and
#: name, with the number of their leading (contracted) axes
PROJECTIONS: Dict[str, Dict[str, int]] = {
    "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 2},
    "cross": {"wq": 1, "wk": 1, "wv": 1, "wo": 2},
    "mlp": {"w_gate": 1, "w_up": 1, "w_down": 1},
    "ssd": {"wz": 1, "wx": 1, "wB": 1, "wC": 1, "wdt": 1, "w_out": 1},
    "rglru": {"w_gate_branch": 1, "w_rec_branch": 1, "w_a": 1, "w_i": 1, "w_out": 1},
    "moe": {"router": 1, "w_gate": 1, "w_up": 1, "w_down": 1},
    "shared": {"w_gate": 1, "w_up": 1, "w_down": 1},        # moe/shared, an MLP
}
#: the projections of :data:`PROJECTIONS` stacked on axes of their own
#: inside a layer (the experts), by module and name, with those axes' count
EXPERT_AXES: Dict[str, Dict[str, int]] = {"moe": {"w_gate": 1, "w_up": 1, "w_down": 1}}


def _normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def _he(gen: torch.Generator, shape: Sequence[int], fan_in: int,
        dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    # scaled in place: an MoE layer's experts are GBs of fp32 while drawn
    return _normal(gen, shape).mul_(scale).to(dtype)


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


def projection_layout(path: Tuple[str, ...]) -> Optional[Tuple[int, int]]:
    """``(contracted axes, leading expert axes)`` of the plain projection
    weight at ``path`` (one layer's leaf), None for other leaves."""
    nc = projection_contract(path)
    return None if nc is None else (nc, EXPERT_AXES.get(path[-2], {}).get(path[-1], 0))


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
    takes :func:`kernel_layout` (behind the layer axis and any expert axis),
    made where the weight lies before it moves (on the host for a tree from
    the host); any other leaf moves as it is."""
    if isinstance(tree, dict):
        return {k: place(v, device, path + (k,)) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):      # a QTensor
        return tree.to(device)
    lay = projection_layout(path) if device.type == "cuda" else None
    if lay is None or in_kernel_layout(tree, lay[0], 1 + lay[1]):
        return tree.to(device)
    return kernel_layout(tree, lay[0], n_batch=1 + lay[1]).to(device)


class LayerStack:
    """Per-period param trees (or one block of a period at a time) written
    one at a time into one tree stacked on a leading layer axis of
    ``count``: each leaf is allocated at its first period and every period
    is copied into its layer, so a caller that drops each tree after
    :meth:`add` holds the stack and one tree, never the whole list.  The result is what ``torch.stack`` of
    the periods gives, value for value; with ``layout`` (a leaf's key path
    → its contracted and expert axes, as :func:`projection_layout` gives
    them, or None) the leaves it names are stacked in :func:`kernel_layout`,
    and a ``QTensor`` leaf stacks its ``qt`` and ``scale``
    (``models/layers/quant.py``)."""

    def __init__(self, count: int,
                 layout: Optional[Callable[[Tuple[str, ...]],
                                           Optional[Tuple[int, int]]]] = None):
        self.count = int(count)
        self.layout = layout
        self.tree: Any = None

    def add(self, i: int, tree: Any) -> None:
        self.tree = self._put(self.tree, tree, i, ())

    def _empty(self, leaf: Any, path: Tuple[str, ...]) -> Any:
        from repro_torch.models.layers.quant import QTensor

        n = self.count
        if isinstance(leaf, QTensor):
            return QTensor(torch.empty((n,) + tuple(leaf.qt.shape), dtype=leaf.qt.dtype,
                                       device=leaf.qt.device),
                           torch.empty((n,) + tuple(leaf.scale.shape), dtype=leaf.scale.dtype,
                                       device=leaf.scale.device),
                           leaf.n_contract, (n,) + leaf.shape)
        lay = self.layout(path) if self.layout is not None else None
        if lay is None:
            return torch.empty((n,) + tuple(leaf.shape), dtype=leaf.dtype, device=leaf.device)
        shape = (n,) + tuple(leaf.shape)
        lead = shape[:1 + lay[1]]
        K = math.prod(shape[len(lead):len(lead) + lay[0]])
        raw = torch.empty(lead + (math.prod(shape[len(lead):]) // K, K), dtype=leaf.dtype,
                          device=leaf.device)
        return raw.transpose(-1, -2).reshape(shape)

    def _put(self, out: Any, leaf: Any, i: int, path: Tuple[str, ...]) -> Any:
        if isinstance(leaf, dict):
            out = {} if out is None else out
            for k, v in leaf.items():
                out[k] = self._put(out.get(k), v, i, path + (k,))
            return out
        if out is None:
            out = self._empty(leaf, path)
        if isinstance(leaf, torch.Tensor):
            out[i].copy_(leaf)
        else:                                   # a QTensor
            out.qt[i].copy_(leaf.qt)
            out.scale[i].copy_(leaf.scale)
        return out
