"""Estimator / Model interfaces — the MLI contract (paper §III-C).

Counterpart: ``src/repro/core/interfaces.py`` (``Model``, ``Estimator``,
``Algorithm`` and ``NumericAlgorithm``):

    est = SomeEstimator(learning_rate=0.3)     # hyperparameters in the ctor
    fitted = est.fit(table)                    # -> fitted Model
    fitted.predict(x)                          # replayable on any rows

Fitted objects expose ``partial`` (their state as a dict of tensors) and
estimators ``rebuild(partial)`` a fitted object from it.  The transformer,
streaming and search mixins and the deprecated ``train`` shims wait for
later slices.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, ClassVar, Generic, Optional, TypeVar

import torch

__all__ = ["Estimator", "FittedEstimator", "Algorithm", "NumericAlgorithm",
           "Model"]

P_ = TypeVar("P_")  # hyperparameter dataclass
M_ = TypeVar("M_", bound="Model")


class Model(abc.ABC):
    """A fitted estimator: an object which makes predictions (paper §III-C)."""

    @abc.abstractmethod
    def predict(self, x: torch.Tensor) -> torch.Tensor:
        ...

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict(x)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Transformer spelling of the fitted replay (defaults to predict)."""
        return self.predict(x)

    @property
    def partial(self) -> Any:
        """The fitted state as a dict of tensors (for checkpointing)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not expose partial state")


#: the fitted half of the Estimator contract (predict/transform + partial)
FittedEstimator = Model


class Estimator(abc.ABC):
    """fit(data) -> FittedEstimator; hyperparameters live in the instance."""

    @abc.abstractmethod
    def fit(self, data: Any) -> FittedEstimator:
        ...

    def rebuild(self, partial: Any) -> FittedEstimator:
        """Reconstruct a fitted object from its ``partial`` state."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support rebuild()")


class Algorithm(Estimator, Generic[P_, M_]):
    """An Estimator whose hyperparameters are a ``Parameters`` dataclass,
    built from a full dataclass or from field overrides::

        LogisticRegression(learning_rate=0.3, max_iter=20)
        KMeans(KMeansParameters(k=8, seed=1))
    """

    #: the hyperparameter dataclass of this algorithm (set by subclasses)
    Parameters: ClassVar[Optional[type]] = None
    #: whether fit() expects the label in column 0 (library convention)
    supervised: ClassVar[bool] = False

    def __init__(self, params: Optional[P_] = None, **overrides: Any) -> None:
        cls = type(self)
        if cls.Parameters is None:
            raise TypeError(f"{cls.__name__} declares no Parameters class")
        if params is None:
            params = cls.Parameters(**overrides)
        elif overrides:
            params = dataclasses.replace(params, **overrides)
        self.params: P_ = params

    def overrides(self) -> dict:
        """The hyperparameters that differ from the defaults."""
        base = type(self).Parameters()
        return {f.name: getattr(self.params, f.name)
                for f in dataclasses.fields(self.params)
                if getattr(self.params, f.name) != getattr(base, f.name)}

    @classmethod
    def default_parameters(cls) -> P_:
        return cls.Parameters()


class NumericAlgorithm(Algorithm[P_, M_]):
    """An Algorithm whose ``fit`` expects an MLNumericTable (each row is a
    feature vector; column 0 is the label when the algorithm is supervised,
    matching Fig. A4's ``vec(0)``)."""
