"""Weight quantization for the serving path (counterpart:
``src/repro/models/layers/quant.py``).

``QTensor`` packs a weight as symmetric per-output-channel int8 plus fp32
scales.  Both carry any leading stacked layer axis, and
:meth:`QTensor.layer` slices one layer out, as the reference's ``lax.scan``
slices its pytree children.

Layers dispatch on type: a ``QTensor`` goes through ``ops.quant_linear``
(the CUDA kernels on the card, their exact plain versions on the CPU): the
reference's ``quantize_rows`` → ``quant_matmul`` → ``astype(x.dtype)``, bit
for bit.  A plain tensor of x's dtype goes through ``ops.fixed_linear`` at
every row count on every device (the kernel on the card, its plain version
on the CPU): the same sum of exact products, in one fp32 order fixed by K,
so a row's result does not depend on how many rows share the call (cuBLAS
picks its order by shape; the continuous-batching engine must give the
slot-at-a-time oracle's streams, whose prefills run other row counts than
the served waves).  Projections that read the same input (q/k/v, gate/up)
go through :func:`linear_or_quant_group`, one kernel call for the group:
the reference has no grouped call, and grouping changes no bit, because
the activation quantization is per row and each product is independent.  It saves the repeated quantization of x, and at a decode step
the group is one kernel launch.  At a decode step the block hands the
group a ``PreNorm`` (``norms.py``): ``fixed_linear``'s launch computes the
norm itself (``norm=``); the int8 groups apply it first.

Weight layout convention (true for every projection in ``models/layers``):
the *contracted* axes lead and the *output-channel* axes trail, so
``n_contract`` pins the split — wq/wk/wv ``(d | h, hd)`` → n_contract 1,
wo ``(h, hd | d)`` → 2, mlp w_gate/w_up/w_down ``(d | f)`` / ``(f | d)``
→ 1.  ``scale`` has the output-channel (and any stacked) axes only.

Layout of the port's own: ``QTensor`` stores the int8 weight as ``qt``,
``(..., N, K)`` contiguous — the transposed, flattened form the CUDA kernel
reads with both operands contiguous along K — and ``q`` is a view of it in
the reference's shape.  Weights are static, so this costs one transpose at
quantization time, no memory, and adds no feature.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers.norms import PreNorm

__all__ = ["QTensor", "quantize_weight", "linear_or_quant", "linear_or_quant_group",
           "quantize_model_params"]


class QTensor:
    """int8 weight + per-output-channel fp32 scales.  ``q`` has the
    original weight shape; ``scale`` drops the ``n_contract`` contracted
    axes (which sit immediately after any stacked batch axes)."""

    def __init__(self, qt: torch.Tensor, scale: torch.Tensor, n_contract: int,
                 shape: Tuple[int, ...]):
        self.qt = qt                       # (*batch, N, K) int8, contiguous
        self.scale = scale                 # (*batch, *out_dims) fp32
        self.n_contract = n_contract
        self.shape = tuple(shape)          # the reference's shape of q

    @classmethod
    def from_q(cls, q: torch.Tensor, scale: torch.Tensor, n_contract: int,
               n_batch: int = 0) -> "QTensor":
        """Wrap an int8 weight ``q`` in the reference's layout."""
        lead = q.shape[:n_batch]
        K = math.prod(q.shape[n_batch:n_batch + n_contract])
        qt = q.reshape(*lead, K, -1).transpose(-1, -2).contiguous()
        return cls(qt, scale, n_contract, tuple(q.shape))

    @property
    def q(self) -> torch.Tensor:
        """The int8 weight in the reference's shape (a view of ``qt``)."""
        return self.qt.transpose(-1, -2).reshape(self.shape)

    def to(self, device) -> "QTensor":
        """The same QTensor on ``device`` (itself where it lies there)."""
        return QTensor(self.qt.to(device), self.scale.to(device), self.n_contract, self.shape)

    def layer(self, i: int) -> "QTensor":
        """Layer ``i`` of a QTensor stacked on a leading layer axis."""
        return QTensor(self.qt[i], self.scale[i], self.n_contract, self.shape[1:])

    def __repr__(self):
        return (f"QTensor(q={self.shape}, scale={tuple(self.scale.shape)}, "
                f"n_contract={self.n_contract})")


def quantize_weight(w: torch.Tensor, n_contract: int,
                    n_batch: int = 0) -> QTensor:
    """Symmetric int8 quantization over the contracted axes (per output
    channel).  ``n_batch`` leading axes (the stacked layer axis) are kept on
    both ``q`` and ``scale``.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    axes = tuple(range(n_batch, n_batch + n_contract))
    wf = w.float()
    scale = wf.abs().amax(dim=axes) / 127.0 + 1e-8
    sb = scale.reshape(scale.shape[:n_batch] + (1,) * n_contract
                       + scale.shape[n_batch:])
    q = torch.clamp(torch.round(wf / sb), -127, 127).to(torch.int8)
    return QTensor.from_q(q, scale, n_contract, n_batch)


def _unnormed(x):
    """x's tensor, and the kernels' ``norm=`` keyword for a ``PreNorm``."""
    return (x.x, {"norm": x.norm}) if isinstance(x, PreNorm) else (x, {})


def _n_contract(eq: str) -> int:
    """The contracted axes of an einsum ``"x,w->out"`` (they trail in x and
    lead in w, the convention above)."""
    ins, out = eq.split("->")
    xs, ws = ins.split(",")
    return sum(1 for c in ws if c in xs and c not in out)


def _quant_contract(x, ws) -> list:
    """Contract ``x``'s trailing ``n_contract`` axes against the leading ones
    of each ``QTensor`` of ``ws`` (all of one ``n_contract`` and K) as 2-D
    products: ``quant_linear`` quantizes the activation rows, runs the
    products against the (N, K) weights, dequantizes in their epilogue and
    returns ``x``'s dtype, as the reference does.  A ``PreNorm`` is applied
    first, by the ``rmsnorm`` kernel (a norm folded into ``qmm_group`` read
    slower than the two launches; PERF.md §6)."""
    if isinstance(x, PreNorm):
        x = x.apply()
    nc = ws[0].n_contract
    K = math.prod(ws[0].shape[:nc])
    lead = tuple(x.shape[:x.ndim - nc])
    outs = ops.quant_linear(x.reshape(-1, K),
                            [(w.qt.t(), w.scale.reshape(-1)) for w in ws])
    return [o.reshape(lead + w.shape[nc:]) for o, w in zip(outs, ws)]


def _fixed_contract(x, ws, nc: int, fp32_out: bool) -> list:
    """The same contraction for plain weights through ``fixed_linear`` (the
    norm of a ``PreNorm`` folded in): fp32 out with ``fp32_out``, else x's
    dtype."""
    xt, kw = _unnormed(x)
    K = math.prod(ws[0].shape[:nc])
    lead = tuple(xt.shape[:xt.ndim - nc])
    dtype = torch.float32 if fp32_out else xt.dtype
    outs = ops.fixed_linear(xt.reshape(-1, K), [w.reshape(K, -1) for w in ws],
                            [dtype] * len(ws), **kw)
    return [o.reshape(lead + tuple(w.shape[nc:])) for o, w in zip(outs, ws)]


def _fixed_rows(x: torch.Tensor, ws, eqs) -> int:
    """The contraction's n_contract when it takes ``fixed_linear`` (plain
    weights of x's dtype over one set of contracted axes), else 0."""
    ncs = {_n_contract(eq) for eq in eqs}
    if len(ncs) != 1 or any(isinstance(w, QTensor) or w.dtype != x.dtype for w in ws):
        return 0
    nc = ncs.pop()
    return nc if len({tuple(w.shape[:nc]) for w in ws}) == 1 else 0


def linear_or_quant(x, w, eq: str, fp32_out: bool = False) -> torch.Tensor:
    """The layer-side dispatch point: the quantized product for a
    ``QTensor``; ``fixed_linear`` for a plain tensor of x's dtype, the
    literal einsum for any other.  ``fp32_out`` stands for the
    reference's ``preferred_element_type=jnp.float32``: ``torch.einsum`` on bf16
    returns bf16, so the operands are cast to fp32 first (a product of two
    bf16 values is exact in fp32, so only the summation order differs);
    ``fixed_linear`` writes fp32.  A ``QTensor`` ignores it and returns
    ``x``'s dtype, as the reference's does.  ``x`` may be a ``PreNorm``."""
    return linear_or_quant_group(x, (w,), (eq,), fp32_out)[0]


def linear_or_quant_group(x, ws, eqs, fp32_out: bool = False) -> list:
    """:func:`linear_or_quant` of ``x`` with each weight of ``ws`` (and its
    einsum of ``eqs``): the ``QTensor``s of one contraction in one
    ``quant_linear`` call, plain weights of x's dtype in one
    ``fixed_linear`` call with a ``PreNorm``'s norm folded in; any other
    plain weight keeps its einsum on the normed x."""
    if all(isinstance(w, QTensor) for w in ws) and \
            len({(w.n_contract, w.shape[:w.n_contract]) for w in ws}) == 1:
        return _quant_contract(x, list(ws))
    nc = _fixed_rows(_unnormed(x)[0], ws, eqs)
    if nc:
        return _fixed_contract(x, list(ws), nc, fp32_out)
    if len(ws) > 1:              # mixed kinds or contractions: one at a time
        return [linear_or_quant(x, w, eq, fp32_out) for w, eq in zip(ws, eqs)]
    (w,), (eq,) = ws, eqs
    if isinstance(x, PreNorm):
        x = x.apply()
    if fp32_out:
        return [torch.einsum(eq, x.float(), w.float())]
    return [torch.einsum(eq, x, w)]


# weight name → n_contract, per module; everything absent stays as it is
# (biases, norms, embeddings, MoE experts, SSD/RG-LRU mixers).
_QUANT_SPECS: Dict[str, Dict[str, int]] = {
    "attn": {"wq": 1, "wk": 1, "wv": 1, "wo": 2},
    "cross": {"wq": 1, "wk": 1, "wv": 1, "wo": 2},
    "mlp": {"w_gate": 1, "w_up": 1, "w_down": 1},
}


def _quantize_blocks(blocks: Dict[str, Any], n_batch: int = 1) -> Dict[str, Any]:
    """The projections of ``_QUANT_SPECS`` as QTensors (``n_batch`` leading
    axes: 1 for blocks stacked along the layer axis, 0 for one period's);
    a weight that is a QTensor already stays as it is."""
    out = {}
    for bk, block in blocks.items():
        nb = dict(block)
        for mod, specs in _QUANT_SPECS.items():
            if mod in nb:
                m = dict(nb[mod])
                for name, nc in specs.items():
                    if name in m and not isinstance(m[name], QTensor):
                        m[name] = quantize_weight(m[name], nc, n_batch=n_batch)
                nb[mod] = m
        out[bk] = nb
    return out


def _map_float(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_float(v, fn) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return fn(tree)
    return tree


def quantize_model_params(params: Dict[str, Any], mode: str) -> Dict[str, Any]:
    """Apply the ``ArchConfig.quantize`` knob to an initialized param tree.

    ``"none"`` returns the tree unchanged; ``"bf16"`` casts every floating
    leaf to bfloat16 (weight-only — activations keep the config dtype);
    ``"int8"`` quantizes the attention, cross-attention and MLP projections
    per ``_QUANT_SPECS``, the encoder's blocks too, and leaves everything
    else as it is.  A tree that is
    quantized already (``init_model`` quantizes as ``cfg.quantize`` says)
    comes back as it is."""
    return _quantize(params, mode, period=False)


def _quantize_period(period: Dict[str, Any], mode: str) -> Dict[str, Any]:
    """One period's blocks (``{"b0": ..., ...}``, no layer axis) as
    :func:`quantize_model_params` leaves the stacked blocks, value for
    value (a single block too): ``init_model`` quantizes each block as it
    is drawn, so that a model whose plain weights do not fit the card never
    holds them all."""
    return _quantize(period, mode, period=True)


def _quantize(tree: Dict[str, Any], mode: str, period: bool) -> Dict[str, Any]:
    if mode == "none":
        return tree
    if mode == "bf16":
        return _map_float(tree, lambda a: a.to(torch.bfloat16))
    if mode != "int8":
        raise ValueError(f"quantize={mode!r} (want none|bf16|int8)")
    if period:
        return _quantize_blocks(tree, n_batch=0)
    out = {**tree, "blocks": _quantize_blocks(tree["blocks"])}
    if "encoder" in tree:            # Whisper's encoder stack, as the reference does
        out["encoder"] = {**tree["encoder"],
                          "blocks": _quantize_blocks(tree["encoder"]["blocks"])}
    return out
