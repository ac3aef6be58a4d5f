"""Optimizers as first-class citizens (paper §III-C, reference impl Fig. A4).

Counterpart: ``src/repro/core/optimizer.py`` (``soft_threshold``,
``StochasticGradientDescent`` with ``_local_round``, ``GradientDescent``).

  * ``StochasticGradientDescent`` — Fig. A4: partition-local SGD over the
    rows in sub-batches of ``local_batch_size``, then averaging;
  * ``GradientDescent`` — the MATLAB reference: full-batch gradient, global
    sum, one update per round.

Both iterate through :class:`repro_torch.core.runner.DistributedRunner`.

The gradient contract differs from the reference in one way: the
reference's ``grad(row, w)`` is one row's gradient, ``vmap``ped over rows
and partitions.  Here ``grad(chunk, w)`` takes a ``(P, m, cols)`` stack of
row chunks and returns ``(P, d)``: for every partition the *sum* of its
rows' gradients.  ``w`` is ``(d,)`` when all partitions share it (GD) or
``(P, d)`` when each partition holds a private copy (SGD).  The SGD step
divides by ``m`` — the reference's mean — and GD uses the sum directly.
``MinibatchSGD``, the streaming paths and the trial-stackable round wait.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import DistributedRunner

__all__ = [
    "Optimizer",
    "StochasticGradientDescentParameters",
    "StochasticGradientDescent",
    "GradientDescentParameters",
    "GradientDescent",
    "soft_threshold",
]

# grad_fn(chunks (P, m, cols), w (d,) | (P, d)) -> (P, d) per-partition sum
GradFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# prox_fn(weights, step) -> weights  (proximal operator, e.g. L1 soft-threshold)
ProxFn = Callable[[torch.Tensor, float], torch.Tensor]


def soft_threshold(lam: float) -> ProxFn:
    """Proximal operator of ``lam * ||w||_1`` (paper §IV: 'adding a proximal
    operator in the case of L1-regularization')."""

    def prox(w: torch.Tensor, step: float) -> torch.Tensor:
        t = lam * step
        return torch.sign(w) * torch.clamp(torch.abs(w) - t, min=0.0)

    return prox


class Optimizer(abc.ABC):
    """MLOpt: optimize parameters against an MLNumericTable."""

    @abc.abstractmethod
    def apply(self, data: MLNumericTable, params) -> torch.Tensor:
        ...

    def __call__(self, data: MLNumericTable, params) -> torch.Tensor:
        return self.apply(data, params)


# --------------------------------------------------------------------------- #
# StochasticGradientDescent (paper Fig. A4)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class StochasticGradientDescentParameters:
    w_init: torch.Tensor
    grad: GradFn
    learning_rate: float = 0.1
    max_iter: int = 10
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.GATHER_BROADCAST
    local_batch_size: int = 1      # 1 == per-point SGD, exactly the paper
    prox: Optional[ProxFn] = None
    lr_decay: float = 1.0          # multiplicative per-round decay


class StochasticGradientDescent(Optimizer):
    """Partition-local SGD + global parameter averaging (paper Fig. A4).

    Each round, every partition folds over its rows in order (in chunks of
    ``local_batch_size``) updating a private copy of the weights; the
    copies are then averaged.  All partitions step together: chunk ``i`` of
    every partition is one ``(P, local_batch_size, cols)`` slice.
    """

    def __init__(self, params: StochasticGradientDescentParameters):
        self.params = params

    @staticmethod
    def _local_round(p: StochasticGradientDescentParameters):
        """Build the partition-local pass (Fig. A4 ``localSGD``):
        ``local_sgd(blocks (P, rows, cols), w (d,), r) -> (P, d)``, with
        ``lr = learning_rate * lr_decay**r`` and the prox after each step."""
        bs = int(p.local_batch_size)

        def local_sgd(blocks: torch.Tensor, w: torch.Tensor, r: int
                      ) -> torch.Tensor:
            num_parts, rows = blocks.shape[0], blocks.shape[1]
            if rows % bs != 0:
                raise ValueError(
                    f"rows-per-shard {rows} must be divisible by local_batch_size {bs}"
                )
            lr = p.learning_rate * (p.lr_decay ** r)
            W = w.expand(num_parts, -1).clone()
            for start in range(0, rows, bs):
                g = p.grad(blocks[:, start:start + bs], W) / bs
                W = W - lr * g
                if p.prox is not None:
                    W = p.prox(W, lr)
            return W

        return local_sgd

    def apply(self, data: MLNumericTable, params=None) -> torch.Tensor:
        p = params or self.params
        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        return runner.run_rounds(data, p.w_init, self._local_round(p),
                                 p.max_iter, combine="mean")


# --------------------------------------------------------------------------- #
# GradientDescent (the MATLAB reference, vectorized full-batch)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class GradientDescentParameters:
    w_init: torch.Tensor
    grad: GradFn
    learning_rate: float = 0.1
    max_iter: int = 10
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
    prox: Optional[ProxFn] = None


class GradientDescent(Optimizer):
    """Full-batch GD: each partition computes the sum of its rows'
    gradients; partitions combine with a global sum; one update per round."""

    def __init__(self, params: GradientDescentParameters):
        self.params = params

    def apply(self, data: MLNumericTable, params=None) -> torch.Tensor:
        p = params or self.params

        # The weight update needs the *summed* gradient, so the per-round
        # combine is a global sum and the update happens after the combine.
        def local_grad(blocks: torch.Tensor, w: torch.Tensor, r: int
                       ) -> torch.Tensor:
            return p.grad(blocks, w)

        def update(w: torch.Tensor, g: torch.Tensor, r: int) -> torch.Tensor:
            w = w - p.learning_rate * g
            if p.prox is not None:
                w = p.prox(w, p.learning_rate)
            return w

        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        return runner.run_rounds(data, p.w_init, local_grad, p.max_iter,
                                 combine="sum", update=update)
