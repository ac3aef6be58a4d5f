"""Mixture-of-Experts with capacity-factor token dispatch (counterpart:
``src/repro/models/layers/moe.py``): llama4's 16 experts top-1 with a
shared expert, mixtral's 8 top-2.

The reference's semantics, step for step:

* tokens (B·S, in that flat order) go in dispatch groups of ``GROUP``; a
  token count that groups do not divide is one group of all tokens;
* each expert takes ``moe_capacity`` tokens a group;
* the router's fp32 logits of the normed rows cast to fp32, a softmax over
  the E experts;
* the top k experts a token, ties to the lowest index (``jax.lax.top_k``'s
  order): a stable descending sort, its first k;
* the kept gates renormalised by ``max(sum, 1e-9)`` (top-1 gives 1.0);
* each (token, choice) takes its place in its expert's queue by the
  group's flat (s, k) arrival order, choice-major within a token; choices
  past capacity are dropped;
* an expert computes ``silu(x·W_gate)·(x·W_up)`` in fp32, rounded to x's
  dtype, then ``·W_down`` in fp32, rounded again;
* the combine: under ``moe_dispatch="einsum"`` Σ_k bf16(gate)·y summed in
  fp32 and rounded once; under ``"gather"`` the products in x's dtype and
  their sum over k in it; a dropped choice adds nothing;
* a shared expert (an MLP on the undispatched rows) is added to the
  routed output;
* ``aux = E·Σ_e f_e·p_e / k`` (fraction routed · mean gate).

Where the port differs in form: the reference builds one-hot (g, s, E, C)
dispatch and combine tensors (``"einsum"``) or sorts each group's choices
(``"gather"``).  The port does neither: each (token, choice) gets its row
in one (E·G·C + 1, d) buffer — expert e's G·C capacity rows contiguous,
group by group, and the last row taking every drop — from a running count
of its expert over the group's flat choices; the rows are copied there,
each expert's G·C rows go through its products, and the combine gathers
each choice's row back (a drop reads a zero row).  Shapes are static and
nothing is read back to the host, so a decode step with the routing inside
captures as a CUDA graph.

Products: the router through ``linear_or_quant`` (fp32 rows and weights:
``fixed_linear``'s SIMT route on the card), each expert's gate and up as
one ``linear_or_quant_group`` call (fp32 out) and its down as one more —
``fixed_linear`` on plain weights of x's dtype, 2·E launches a layer of
M = G·C rows each (C = 8 at a decode step of up to 8 slots) — and the
shared expert through ``mlp_apply``.  Experts are never quantized: the
reference's int8 mode reaches only a block's top-level ``attn``, ``cross``
and ``mlp`` (``quant.py``), as the port's does.  Every product sums a row in
one order fixed by K, and the softmax adds its E columns in
``fixed_sum``'s order, so a token's gates, choices and expert rows do not
depend on the other tokens of its batch except through capacity: in a
decode step of no more slots than C (at least 8) no choice is dropped,
since a token picks an expert at most once.  Above that, routing couples
the slots, in the reference too.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.fixed_sum import fixed_sum
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers.mlp import mlp_apply, mlp_init
from repro_torch.models.layers.quant import linear_or_quant, linear_or_quant_group
from repro_torch.models.params import linear

__all__ = ["GROUP", "Routing", "moe_capacity", "moe_groups", "moe_shapes", "moe_init",
           "moe_route", "moe_apply"]

GROUP = 2048  # tokens a dispatch group, as the reference's
#: the softmax's exp runs on rows padded to a multiple of this many columns:
#: a CPU elementwise kernel takes a tail shorter than two vectors through a
#: scalar exp that can differ from the vector one by an ulp, so a row's
#: gates would depend on how many rows share the call
_EXP_COLUMNS = 32


def moe_capacity(cfg: ArchConfig, group: int) -> int:
    cap = int(group * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, ((cap + 7) // 8) * 8)  # padded to 8, as the reference's


def moe_groups(tokens: int) -> Tuple[int, int]:
    """(groups, tokens a group) for ``tokens`` routed together."""
    group = min(GROUP, tokens)
    if tokens % group:
        group = tokens           # the reference's fallback: one group
    return tokens // group, group


def moe_shapes(cfg: ArchConfig) -> Dict[str, object]:
    """Every leaf of one MoE block and its shape (the shared expert's
    nested under ``"shared"``): the layout that :func:`moe_init` draws and
    ``weights.lm_from_reference`` checks."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    shapes: Dict[str, object] = {"router": (d, e), "w_gate": (e, d, f), "w_up": (e, d, f),
                                 "w_down": (e, f, d)}
    if cfg.shared_expert:
        shapes["shared"] = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    return shapes


def moe_init(gen: torch.Generator, cfg: ArchConfig, dtype) -> Dict[str, torch.Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    params = {
        "router": linear(gen, (d, e), fan_in=d, dtype=torch.float32),
        "w_gate": linear(gen, (e, d, f), fan_in=d, dtype=dtype),
        "w_up": linear(gen, (e, d, f), fan_in=d, dtype=dtype),
        "w_down": linear(gen, (e, f, d), fan_in=f, dtype=dtype),
    }
    if cfg.shared_expert:
        params["shared"] = mlp_init(gen, cfg, dtype)
    return params


class Routing(NamedTuple):
    """One call's routing: ``gates`` (T, E) fp32, the kept ``top_gates``
    (T, k) renormalised and their experts ``top_idx`` (T, k), each choice's
    buffer row ``dest`` (T·k,) in (token, choice) order (``drop`` where it
    was dropped), and the groups, group size and capacity."""
    gates: torch.Tensor
    top_gates: torch.Tensor
    top_idx: torch.Tensor
    dest: torch.Tensor
    groups: int
    group: int
    capacity: int

    @property
    def drop(self) -> int:
        """The buffer row of a dropped choice (the last, E·G·C)."""
        return self.gates.shape[-1] * self.groups * self.capacity


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the E columns of (T, E) fp32 logits, each row on its
    own: the max, exp of the shifted row (padded columns exp to 0), the
    sum in ``fixed_sum``'s order, a division."""
    E = logits.shape[-1]
    width = -(-E // _EXP_COLUMNS) * _EXP_COLUMNS
    shifted = logits - logits.amax(dim=-1, keepdim=True)
    ex = torch.exp(F.pad(shifted, (0, width - E), value=float("-inf")))[:, :E]
    return ex / fixed_sum(ex)[:, None]


def _top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest gates of each row and their experts, ties to the lowest
    index, renormalised by ``max(sum, 1e-9)``."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top, idx = vals[:, :k], idx[:, :k]
    total = top[:, 0]
    for j in range(1, k):
        total = total + top[:, j]
    return top / torch.clamp(total, min=1e-9)[:, None], idx


def moe_route(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig) -> Routing:
    """The routing of ``x`` (B, S, D), as :func:`moe_apply` takes it."""
    E, k = cfg.num_experts, cfg.top_k
    D = x.shape[-1]
    rows = x.reshape(-1, D)
    G, group = moe_groups(rows.shape[0])
    C = moe_capacity(cfg, group)
    logits = linear_or_quant(rows.float(), params["router"], "td,de->te", fp32_out=True)
    gates = _softmax(logits)
    top_gates, top_idx = _top_k(gates, k)
    # each choice's place in its expert's queue: the running count of that
    # expert over the group's flat (s, k) choices before it
    flat = top_idx.reshape(G, group * k)
    onehot = (flat[..., None] == torch.arange(E, device=x.device)).to(torch.int32)
    before = (onehot.cumsum(dim=1) - onehot).gather(-1, flat[..., None])[..., 0]
    row = flat * (G * C) + torch.arange(G, device=x.device)[:, None] * C + before
    dest = torch.where(before < C, row, torch.full_like(row, E * G * C))
    return Routing(gates, top_gates, top_idx, dest.reshape(-1), G, group, C)


def _aux(route: Routing, cfg: ArchConfig) -> torch.Tensor:
    E, k = cfg.num_experts, cfg.top_k
    T = route.gates.shape[0]
    chosen = (route.top_idx[..., None] == torch.arange(E, device=route.gates.device))
    frac = chosen.sum(dim=(0, 1)).float() / T
    prob = route.gates.mean(dim=0)
    return E * torch.sum(frac * prob) / k


def _dispatch(x: torch.Tensor, route: Routing, E: int) -> torch.Tensor:
    """The (E·G·C + 1, D) expert buffer of ``x``'s rows: each kept choice's
    row at its place, zeros where no token came, the drops on the last
    row."""
    D = x.shape[-1]
    k = route.top_idx.shape[-1]
    buf = torch.zeros((E * route.groups * route.capacity + 1, D), dtype=x.dtype,
                      device=x.device)
    buf.index_copy_(0, route.dest, x.reshape(-1, D)[:, None].expand(-1, k, -1).reshape(-1, D))
    return buf


def _experts(params: Dict[str, torch.Tensor], buf: torch.Tensor, E: int) -> torch.Tensor:
    """Each expert's MLP on its G·C rows of ``buf``, in its dtype, and a
    zero last row (what a drop reads)."""
    GC, dt = (buf.shape[0] - 1) // E, buf.dtype
    ys = []
    for e in range(E):
        xe = buf[e * GC:(e + 1) * GC]
        g, u = linear_or_quant_group(xe, (params["w_gate"][e], params["w_up"][e]),
                                     ("sd,df->sf",) * 2, fp32_out=True)
        h = (F.silu(g) * u).to(dt)
        ys.append(linear_or_quant(h, params["w_down"][e], "sf,fd->sd", fp32_out=True).to(dt))
    ys.append(torch.zeros((1, buf.shape[1]), dtype=dt, device=buf.device))
    return torch.cat(ys)


def _combine(y: torch.Tensor, route: Routing, dispatch: str) -> torch.Tensor:
    """Each token's kept expert rows of ``y`` weighted by its gates and
    added over its k choices: (T, D) in y's dtype."""
    k, dt = route.top_idx.shape[-1], y.dtype
    picked = y.index_select(0, route.dest).view(-1, k, y.shape[-1])
    if dispatch == "gather":
        w = route.top_gates.to(dt)
        out = picked[:, 0] * w[:, :1]
        for j in range(1, k):
            out = out + picked[:, j] * w[:, j:j + 1]
        return out
    w = route.top_gates.to(dt).float()
    acc = picked[:, 0].float() * w[:, :1]
    for j in range(1, k):
        acc = acc + picked[:, j].float() * w[:, j:j + 1]
    return acc.to(dt)


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig, *,
              aux: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D) -> (out, aux loss); ``aux=False`` (a decode step, which
    reads no loss) skips the loss and returns None for it."""
    route = moe_route(params, x, cfg)
    y = _experts(params, _dispatch(x, route, cfg.num_experts), cfg.num_experts)
    out = _combine(y, route, cfg.moe_dispatch).view(x.shape)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], x)
    return out, (_aux(route, cfg) if aux else None)
