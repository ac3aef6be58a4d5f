"""Generalized linear models (paper §IV: '...naturally extend to a diverse
group of ML algorithms, e.g., linear SVMs, linear regression, and (L1, L2,
elastic net)-regularized variants therein, simply by changing the expression
of the gradient function (and adding a proximal operator in the case of
L1-regularization)').

Counterpart: ``src/repro/core/algorithms/linear_models.py`` (the whole
file): one GLM trainer parameterized by a loss-gradient expression and a
:class:`Regularization`, on the port's SGD.

The port's SGD takes a chunk gradient (see
:mod:`repro_torch.core.optimizer`): for a ``(P, m, 1 + d)`` stack of row
chunks and per-partition weights ``W`` (P, d), each partition's *sum* of
row gradients, which the step divides by m.  The reference adds ``l2·w``
to every row's gradient before it averages them, so the chunk sum here
adds ``m·l2·W``.  L1 is the soft-threshold prox after every step.

``GeneralizedLinearModel.predict`` sums ``x·w`` in :func:`fixed_dot`'s
order, so a served row is bitwise its offline prediction.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.fixed_sum import fixed_dot
from repro_torch.core.interfaces import Model, NumericAlgorithm
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.optimizer import (
    StochasticGradientDescent,
    StochasticGradientDescentParameters,
    soft_threshold,
)

__all__ = [
    "Regularization",
    "GeneralizedLinearModel",
    "LinearRegressionParameters",
    "LinearRegressionAlgorithm",
    "LinearRegression",
    "LinearSVMParameters",
    "LinearSVMAlgorithm",
    "LinearSVM",
]

# loss_grad(x (P, m, d), y (P, m), W (P, d)) -> (P, d): each partition's sum
# of its rows' loss gradients
LossGrad = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass
class Regularization:
    l1: float = 0.0
    l2: float = 0.0

    @classmethod
    def elastic_net(cls, alpha: float, l1_ratio: float) -> "Regularization":
        return cls(l1=alpha * l1_ratio, l2=alpha * (1.0 - l1_ratio))


def _identity(z: torch.Tensor) -> torch.Tensor:
    return z


class GeneralizedLinearModel(Model):
    def __init__(self, weights: torch.Tensor,
                 link: Callable[[torch.Tensor], torch.Tensor] = _identity):
        self.weights = weights
        self.link = link

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.link(fixed_dot(x, self.weights))

    @property
    def partial(self):
        return {"weights": self.weights}


def _margins(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """x·w for every row of every partition: (P, m, d), (P, d) → (P, m)."""
    return torch.bmm(x, W.unsqueeze(-1)).squeeze(-1)


def _weighted_rows(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Σ_rows c·x for every partition: (P, m, d), (P, m) → (P, d)."""
    return torch.bmm(c.unsqueeze(1), x).squeeze(1)


def _train_glm(data: MLNumericTable, loss_grad: LossGrad, reg: Regularization,
               learning_rate: float, max_iter: int, local_batch_size: int,
               schedule) -> torch.Tensor:
    d = data.num_cols - 1

    def gradient(chunks: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
        g = loss_grad(chunks[..., 1:], chunks[..., 0], W)
        if reg.l2:
            g = g + (chunks.shape[-2] * reg.l2) * W
        return g

    prox = soft_threshold(reg.l1) if reg.l1 else None
    opt = StochasticGradientDescent(StochasticGradientDescentParameters(
        w_init=torch.zeros((d,), dtype=torch.float32, device=data.device),
        grad=gradient, learning_rate=learning_rate, max_iter=max_iter,
        local_batch_size=local_batch_size, schedule=schedule, prox=prox))
    return opt.apply(data, None)


# --------------------------------------------------------------------------- #
# Linear regression (squared loss)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class LinearRegressionParameters:
    learning_rate: float = 0.1
    max_iter: int = 20
    reg: Regularization = dataclasses.field(default_factory=Regularization)
    local_batch_size: int = 1
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE


def _squared_loss_grad(x: torch.Tensor, y: torch.Tensor, W: torch.Tensor
                       ) -> torch.Tensor:
    """Σ x·(x·w − y) over each partition's rows."""
    return _weighted_rows(x, _margins(x, W) - y)


def _hinge_grad(x: torch.Tensor, y: torch.Tensor, W: torch.Tensor
                ) -> torch.Tensor:
    """The hinge loss's subgradient Σ −y·x over each partition's rows with
    y·(x·w) < 1."""
    margin = y * _margins(x, W)
    return _weighted_rows(x, torch.where(margin < 1.0, -y, torch.zeros_like(y)))


class LinearRegressionAlgorithm(
    NumericAlgorithm[LinearRegressionParameters, GeneralizedLinearModel]
):
    """Instance-based Estimator: ``LinearRegressionAlgorithm(
    learning_rate=0.1).fit(table)``; the label is column 0."""

    Parameters = LinearRegressionParameters
    supervised = True

    def fit(self, data: MLNumericTable) -> GeneralizedLinearModel:
        p = self.params
        w = _train_glm(data, _squared_loss_grad, p.reg, p.learning_rate,
                       p.max_iter, p.local_batch_size, p.schedule)
        return GeneralizedLinearModel(w)

    def rebuild(self, partial) -> GeneralizedLinearModel:
        return GeneralizedLinearModel(partial["weights"])


# --------------------------------------------------------------------------- #
# Linear SVM (hinge loss subgradient)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class LinearSVMParameters:
    learning_rate: float = 0.1
    max_iter: int = 20
    reg: Regularization = dataclasses.field(default_factory=lambda: Regularization(l2=1e-3))
    local_batch_size: int = 1
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE


class LinearSVMAlgorithm(
    NumericAlgorithm[LinearSVMParameters, GeneralizedLinearModel]
):
    """Labels are expected in {-1, +1} in column 0; the model's link is
    ``torch.sign``."""

    Parameters = LinearSVMParameters
    supervised = True

    def fit(self, data: MLNumericTable) -> GeneralizedLinearModel:
        p = self.params
        w = _train_glm(data, _hinge_grad, p.reg, p.learning_rate,
                       p.max_iter, p.local_batch_size, p.schedule)
        return GeneralizedLinearModel(w, link=torch.sign)

    def rebuild(self, partial) -> GeneralizedLinearModel:
        return GeneralizedLinearModel(partial["weights"], link=torch.sign)


#: estimator-style aliases
LinearRegression = LinearRegressionAlgorithm
LinearSVM = LinearSVMAlgorithm
