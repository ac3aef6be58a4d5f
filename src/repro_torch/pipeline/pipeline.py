"""Pipeline — the paper's Fig. A2 program as ONE fitted object.

Counterpart: ``src/repro/pipeline/pipeline.py`` (``Pipeline`` and
``FittedPipeline``: ``fit``, ``transform``, ``featurize_rows``,
``apply_features``, ``predict``, ``__getitem__``, ``describe``,
``partial``, ``estimator``, ``stage_names``).  ``fit_stream``,
``save``/``load`` and the search plumbing (``split_config``,
``with_stage_config``) wait for the streaming and search slices.

``Pipeline([NGrams(...), TfIdf(), Standardizer(), LogisticRegression(...)])``
composes fitted transformers and a terminal estimator:

  * **fit** — transformer statistics (vocabulary, IDF weights, column
    means/stds) are computed stage by stage on the training table (host
    tier for the schema-changing text stages; device tier once the table
    is committed to ``device`` before the first device stage), then the
    estimator trains through the emulated
    :class:`repro_torch.core.runner.DistributedRunner`;
  * **serve** — the fitted pipeline is a model whose ``predict`` accepts
    raw serving rows: host-tier vocab lookup, then the device-tier tf-idf
    → standardize → predict chain on the fitted device, which is how
    :class:`repro_torch.serve.ModelPredictor` serves raw text.

Where the reference takes ``mesh=`` the port takes ``num_shards=`` (the
emulated partitions of the numeric commit) and ``device=`` (the CUDA card
unless ``device="cpu"``).  Supervised pipelines follow the library
convention: the label sits in column 0 of the raw table, passes through
every featurizer unscathed, and is stripped before the fitted model's
``predict``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.interfaces import (
    Algorithm,
    Estimator,
    FittedEstimator,
    FittedTransformer,
    Transformer,
)
from repro_torch.core.mltable import MLTable
from repro_torch.device import DeviceLike, to_tensor
from repro_torch.features.scaling import FittedBiasAdder, FittedStandardizer
from repro_torch.features.text import (
    FittedHashingVectorizer,
    FittedNGrams,
    FittedTfIdf,
)

__all__ = ["Pipeline", "FittedPipeline", "FITTED_KINDS"]

#: default stage names — the keys nested search params address
_DEFAULT_NAMES = {
    "NGrams": "ngrams",
    "HashingVectorizer": "hashing",
    "TfIdf": "tfidf",
    "Standardizer": "standardizer",
    "BiasAdder": "bias",
    "LogisticRegressionAlgorithm": "logreg",
    "KMeans": "kmeans",
    "PCA": "pca",
    "GaussianNaiveBayes": "naive_bayes",
    "BroadcastALS": "als",
    "LinearRegressionAlgorithm": "linreg",
    "LinearSVMAlgorithm": "svm",
}

#: host-state ``kind`` → fitted transformer class (``from_state``)
FITTED_KINDS = {
    "ngrams": FittedNGrams,
    "hashing": FittedHashingVectorizer,
    "tfidf": FittedTfIdf,
    "standardizer": FittedStandardizer,
    "bias": FittedBiasAdder,
}


def _auto_name(stage: Any) -> str:
    cls = type(stage).__name__
    return _DEFAULT_NAMES.get(cls, cls.lower())


def _is_raw_rows(x: Any) -> bool:
    """True for raw serving input: a str, a sequence of str, or an
    object/str-dtype array — anything the host featurizers must map to
    numbers before the device chain runs."""
    if isinstance(x, str):
        return True
    if isinstance(x, (list, tuple)):
        return bool(x) and isinstance(x[0], str)
    if isinstance(x, torch.Tensor):
        return False
    dtype = getattr(x, "dtype", None)
    return dtype is not None and np.dtype(dtype).kind in "OUS"


class FittedPipeline(FittedEstimator):
    """The fitted form of :class:`Pipeline`: fitted transformer stages plus
    the trained terminal model, replayable on tables or raw serving rows.
    ``device`` is where the training table was committed: raw and host
    rows are featurized there."""

    def __init__(self, pipeline: "Pipeline",
                 stages: Sequence[Tuple[str, FittedTransformer]],
                 model: Optional[FittedEstimator],
                 num_cols: int, device: torch.device) -> None:
        self.pipeline = pipeline
        self.stages: List[Tuple[str, FittedTransformer]] = list(stages)
        self.model = model
        #: column count of the fully-featurized training table (labels
        #: included)
        self.num_cols = int(num_cols)
        self.device = torch.device(device)

    def __getitem__(self, name: str) -> FittedTransformer:
        for n, f in self.stages:
            if n == name:
                return f
        raise KeyError(f"no fitted stage named {name!r}")

    # ------------------------------------------------------------------ #
    # replay
    # ------------------------------------------------------------------ #
    def transform(self, table: Any, *, num_shards: Optional[int] = None,
                  device: DeviceLike = None):
        """Replay every fitted transformer over ``table`` (host stages on
        the MLTable tier, device stages after the numeric commit); the
        terminal model is not applied.  ``num_shards`` / ``device`` default
        to the pipeline's."""
        return self.pipeline._transform_stages(self.stages, table,
                                               num_shards=num_shards,
                                               device=device)

    def featurize_rows(self, rows: Any) -> np.ndarray:
        """Host-tier replay of raw serving rows (vocab lookup): text →
        count matrix, ready for :meth:`apply_features`."""
        out = rows
        for _, f in self.stages:
            if f.tier == "host":
                out = f.transform_rows(out)
        return np.asarray(out, np.float32)

    def apply_features(self, feats: Any) -> torch.Tensor:
        """Device-tier replay on label-free feature rows (a tensor where it
        lies, or host rows copied to the fitted device)."""
        out = feats if isinstance(feats, torch.Tensor) else to_tensor(feats, self.device)
        for _, f in self.stages:
            if f.tier == "device":
                out = f.apply(out)
        return out

    def predict(self, x: Any) -> torch.Tensor:
        """Raw serving rows (str / list of str) run vocab lookup → device
        feature chain → model predict; numeric rows are taken at the
        post-host-featurization level (count rows) and run the device
        chain directly."""
        if _is_raw_rows(x):
            x = self.featurize_rows(x)
        feats = self.apply_features(x)
        if self.model is None:
            return feats
        return self.model.predict(feats)

    @property
    def partial(self) -> Dict[str, Any]:
        tree: Dict[str, Any] = {
            "stages": {n: f.partial for n, f in self.stages}}
        if self.model is not None:
            tree["model"] = self.model.partial
        return tree

    def host_state(self) -> dict:
        state = {
            "stages": [[n, f.host_state()] for n, f in self.stages],
            "num_cols": self.num_cols,
        }
        if self.model is not None:
            state["model_shapes"] = {
                k: [list(v.shape), str(v.dtype).replace("torch.", "")]
                for k, v in self.model.partial.items()}
        return state


class Pipeline(Estimator):
    """Composable Estimator: transformer stages + one terminal estimator.

    Parameters
    ----------
    stages:
        Transformer / estimator instances, or ``(name, stage)`` pairs; the
        final stage may be an :class:`Algorithm` instance (the trained
        model) — a transformer-only pipeline is a pure featurizer.  Names
        default per class (``ngrams``, ``tfidf``, ``standardizer``,
        ``bias``, ``logreg`` …).
    num_shards / device:
        Layout of the numeric commit: once the first device-tier stage is
        reached, the (by then fully numeric) table goes to ``device`` (the
        CUDA card unless ``device="cpu"``), split into ``num_shards``
        emulated partitions.
    supervised:
        Whether column 0 of the raw table is the label (passed through
        every featurizer, stripped before predict).  Defaults to the
        terminal estimator's declaration.
    """

    def __init__(self, stages: Sequence[Any], *,
                 num_shards: Optional[int] = None, device: DeviceLike = None,
                 supervised: Optional[bool] = None) -> None:
        if not stages:
            raise ValueError("Pipeline needs at least one stage")
        named: List[Tuple[str, Any]] = []
        seen: Dict[str, int] = {}
        for item in stages:
            name, stage = (item if isinstance(item, tuple) else
                           (_auto_name(item), item))
            if isinstance(stage, type):
                raise TypeError(
                    f"stage {name!r} is a class — pass an instance "
                    f"(hyperparameters in the constructor)")
            seen[name] = seen.get(name, 0) + 1
            if seen[name] > 1:
                name = f"{name}{seen[name]}"
            named.append((name, stage))
        self._estimator_name: Optional[str] = None
        self._estimator: Optional[Estimator] = None
        last_name, last = named[-1]
        if not isinstance(last, Transformer):
            if not isinstance(last, Estimator):
                raise TypeError(
                    f"final stage {last_name!r} is neither a Transformer "
                    f"nor an Estimator")
            self._estimator_name, self._estimator = last_name, last
            named = named[:-1]
        for name, stage in named:
            if not isinstance(stage, Transformer):
                raise TypeError(
                    f"stage {name!r} must be a Transformer (only the final "
                    f"stage may be an estimator)")
        self._stages: List[Tuple[str, Transformer]] = named
        self.num_shards = num_shards
        self.device = device
        if supervised is None:
            supervised = bool(getattr(self._estimator, "supervised", False))
        self.supervised = bool(supervised)

    # ------------------------------------------------------------------ #
    # introspection
    # ------------------------------------------------------------------ #
    @property
    def estimator(self) -> Optional[Estimator]:
        return self._estimator

    @property
    def estimator_name(self) -> Optional[str]:
        return self._estimator_name

    def stage_names(self) -> List[str]:
        return [n for n, _ in self._stages]

    def describe(self) -> dict:
        """JSON-able identity of the pipeline (stage classes + configs)."""
        desc = {
            "stages": [[n, type(s).__name__,
                        {k: str(v) for k, v in
                         sorted(getattr(s, "_config", {}).items())}]
                       for n, s in self._stages],
            "supervised": self.supervised,
        }
        if self._estimator is not None:
            desc["estimator"] = [
                self._estimator_name, type(self._estimator).__name__,
                {k: str(v) for k, v in
                 sorted(self._estimator.overrides().items())}
                if isinstance(self._estimator, Algorithm) else {}]
        return desc

    # ------------------------------------------------------------------ #
    # tier plumbing
    # ------------------------------------------------------------------ #
    def _default_skip(self) -> Tuple[int, ...]:
        return (0,) if self.supervised else ()

    @staticmethod
    def _commit(table: Any, num_shards: Optional[int], device: DeviceLike):
        if isinstance(table, MLTable):
            return table.to_numeric(num_shards=num_shards, device=device)
        return table

    def _fit_stages(self, table: Any):
        """Fit every transformer stage in order (host tier first, device
        tier after the numeric commit); returns ``(fitted, final_table)``
        with ``final_table`` committed to the numeric tier."""
        fitted: List[Tuple[str, FittedTransformer]] = []
        current = table
        skip = self._default_skip()
        for name, stage in self._stages:
            if stage.tier == "host":
                if not isinstance(current, MLTable):
                    raise TypeError(
                        f"host-tier stage {name!r} needs an MLTable, but "
                        f"the table was already committed to the device "
                        f"tier — put text stages before numeric ones")
            else:
                current = self._commit(current, self.num_shards, self.device)
            f = stage.fit(current, default_skip=skip)
            current = f.transform(current)
            fitted.append((name, f))
        current = self._commit(current, self.num_shards, self.device)
        return fitted, current

    def _transform_stages(self, fitted: Sequence[Tuple[str, Any]],
                          table: Any, *, num_shards: Optional[int] = None,
                          device: DeviceLike = None):
        """Replay fitted stages over a table (validation views, serving
        tables), with an optional layout override for views whose row
        counts do not divide the training partitions."""
        num_shards = num_shards if num_shards is not None else self.num_shards
        device = device if device is not None else self.device
        current = table
        for name, f in fitted:
            if f.tier == "host":
                if not isinstance(current, MLTable):
                    raise TypeError(
                        f"host-tier stage {name!r} needs an MLTable input")
            else:
                current = self._commit(current, num_shards, device)
            current = f.transform(current)
        return self._commit(current, num_shards, device)

    # ------------------------------------------------------------------ #
    # fit
    # ------------------------------------------------------------------ #
    def fit(self, data: Any) -> FittedPipeline:
        """Fit transformers stage-by-stage, then train the terminal
        estimator through the runner on the featurized table."""
        fitted, final = self._fit_stages(data)
        model = self._estimator.fit(final) if self._estimator else None
        return FittedPipeline(self, fitted, model, final.num_cols, final.device)
