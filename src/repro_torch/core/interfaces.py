"""Estimator / Model interfaces — the MLI contract (paper §III-C).

Counterpart: ``src/repro/core/interfaces.py`` (``Model``, ``Estimator``,
``StreamFitable``, ``Transformer``, ``FittedTransformer``, ``Algorithm``
and ``NumericAlgorithm``):

    est = SomeEstimator(learning_rate=0.3)     # hyperparameters in the ctor
    fitted = est.fit(table)                    # -> fitted Model
    fitted.predict(x)                          # replayable on any rows

Fitted objects expose ``partial`` (their state as a dict of tensors) and
estimators ``rebuild(partial)`` a fitted object from it.  Featurizers are
``Transformer``s whose ``fit`` returns a ``FittedTransformer``; a pipeline composes them with one terminal
estimator.  ``StreamFitable`` marks an estimator that trains from a stream
of per-epoch windows, ``Searchable`` one that describes a model-search
trial (:mod:`repro_torch.tune`).  ``Algorithm`` keeps the reference's
deprecated classmethod spellings, ``train`` and ``defaultParameters``, as
shims that warn and delegate, and its quiet ``train_stream``.
"""
from __future__ import annotations

import abc
import dataclasses
import warnings
from typing import Any, ClassVar, Generic, Optional, TypeVar

import torch

__all__ = ["Estimator", "FittedEstimator", "StreamFitable", "Searchable", "Transformer",
           "FittedTransformer", "Algorithm", "NumericAlgorithm", "Model"]

P_ = TypeVar("P_")  # hyperparameter dataclass
M_ = TypeVar("M_", bound="Model")


def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} — the instance-based Estimator "
        f"contract (hyperparameters in the constructor, fit() returning a "
        f"fitted model). The shim delegates and is bit-identical.",
        DeprecationWarning, stacklevel=3)


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


class StreamFitable(abc.ABC):
    """Capability mixin: the estimator trains from a stream of per-epoch
    minibatch windows (:class:`repro_torch.data.pipeline.BatchIterator`)
    through :meth:`repro_torch.core.runner.DistributedRunner.run_epochs`,
    and inherits its checkpoint and resume."""

    @abc.abstractmethod
    def fit_stream(self, stream: Any, **kwargs: Any) -> FittedEstimator:
        ...


class Searchable(abc.ABC):
    """Capability mixin: the estimator describes one model-search trial as
    a :class:`repro_torch.tune.trials.TrialSpec` (stackable where shapes
    allow; see :mod:`repro_torch.tune`)."""

    @classmethod
    @abc.abstractmethod
    def trial_spec(cls, config: dict, metric: Optional[str] = None):
        ...


class FittedTransformer(abc.ABC):
    """A fitted feature transformer: corpus statistics (vocabulary, IDF
    weights, column means/stds) are computed once at ``fit`` and *replayed*
    at ``transform`` on any table or raw serving row — never refit, so a
    transformer fit on train folds cannot leak validation statistics.

    ``tier`` declares where the transform runs: ``"host"`` stages are
    schema-changing row programs (text → counts) executed on the MLTable
    tier; ``"device"`` stages are pure numeric maps whose :meth:`apply`
    runs on label-free feature rows on the table's device (inside the
    serving microbatch).
    """

    tier: ClassVar[str] = "device"

    @abc.abstractmethod
    def transform(self, table: Any) -> Any:
        """Replay the fitted statistics over a whole table."""

    def __call__(self, table: Any) -> Any:
        return self.transform(table)

    def apply(self, feats: torch.Tensor) -> torch.Tensor:
        """Device-tier row replay on label-free feature rows.  Host-tier
        transformers raise; use :meth:`transform_rows`."""
        raise NotImplementedError(
            f"{type(self).__name__} has no device-tier apply()")

    def transform_rows(self, rows: Any) -> Any:
        """Host-tier row replay (e.g. raw text → count vectors)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no host-tier transform_rows()")

    @property
    def partial(self) -> Any:
        """Fitted state as a dict of tensors (may be empty)."""
        return {}

    def host_state(self) -> dict:
        """Fitted state that is not tensors (vocabulary, column indices) as
        a JSON-able dict; together with ``partial`` it fully determines the
        fitted transformer (see ``from_state``)."""
        return {}


class Transformer(Estimator):
    """An Estimator whose fitted form transforms tables (same contract as
    the algorithms: statistics at fit, replay at transform)."""

    tier: ClassVar[str] = "device"

    def fit_transform(self, table: Any):
        """Convenience: fit on ``table`` and transform it; returns
        ``(fitted, transformed_table)``."""
        fitted = self.fit(table)
        return fitted, fitted.transform(table)

    def clone_with(self, **overrides: Any) -> "Transformer":
        """A new transformer of the same type with some constructor
        hyperparameters replaced (how model search addresses nested stage
        params, ``"tfidf.skip"``)."""
        cfg = dict(getattr(self, "_config", {}))
        for k in overrides:
            if k not in cfg:
                raise ValueError(
                    f"{type(self).__name__} has no hyperparameter {k!r} "
                    f"(searchable: {sorted(cfg)})")
        cfg.update(overrides)
        return type(self)(**cfg)


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

    # legacy classmethod contract (deprecation shims) ------------------------ #
    @classmethod
    def train(cls, data: Any, params: Optional[P_] = None, **kwargs: Any) -> M_:
        """Deprecated: ``cls.train(data, params)`` → ``cls(params).fit(data)``
        (it *is* the new path, so the result is bit-identical)."""
        _warn_deprecated(f"{cls.__name__}.train(data, params)",
                         f"{cls.__name__}(params).fit(data)")
        return cls(params).fit(data, **kwargs)

    @classmethod
    def train_stream(cls, stream: Any, params: Optional[P_] = None,
                     **kwargs: Any) -> M_:
        """Legacy spelling of :meth:`StreamFitable.fit_stream` (quiet, as
        in the reference: its launchers routed through it)."""
        return cls(params).fit_stream(stream, **kwargs)

    @classmethod
    def defaultParameters(cls) -> P_:  # paper spelling
        _warn_deprecated(f"{cls.__name__}.defaultParameters()",
                         f"{cls.__name__}.default_parameters()")
        return cls.default_parameters()


class NumericAlgorithm(Algorithm[P_, M_]):
    """An Algorithm whose ``fit`` expects an MLNumericTable (each row is a
    feature vector; column 0 is the label when the algorithm is supervised,
    matching Fig. A4's ``vec(0)``)."""
