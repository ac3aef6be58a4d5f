"""Pipeline — the paper's Fig. A2 program as ONE fitted object.

Counterpart: ``src/repro/pipeline/pipeline.py`` (``Pipeline`` and
``FittedPipeline``: ``fit``, ``fit_stream``, ``transform``,
``featurize_rows``, ``apply_features``, ``predict``, ``__getitem__``,
``describe``, ``partial``, ``estimator``, ``stage_names``, ``save``,
``load``, the restore helpers ``_stage_templates``, ``_rebuild_stages``
and ``_restore_stages``, and the search plumbing ``split_config`` and
``with_stage_config``, which :class:`repro_torch.tune.ModelSearch` reads).

``Pipeline([NGrams(...), TfIdf(), Standardizer(), LogisticRegression(...)])``
composes fitted transformers and a terminal estimator:

  * **fit** — transformer statistics (vocabulary, IDF weights, column
    means/stds) are computed stage by stage on the training table (host
    tier for the schema-changing text stages; device tier once the table
    is committed to ``device`` before the first device stage), then the
    estimator trains through the emulated
    :class:`repro_torch.core.runner.DistributedRunner`;
  * **fit_stream** — the same featurization, then the estimator trains
    from per-epoch windows of the featurized table; with a
    :class:`repro_torch.core.runner.CheckpointPolicy` every snapshot is ONE
    atomic file holding the featurizer state, the model carry and the
    stream position, and ``resume=True`` restores all three from it (the
    featurizers are *restored*, never refit);
  * **save / load** — ``FittedPipeline.save`` publishes the whole fitted
    pipeline as one atomic artifact in the reference's format, and
    ``Pipeline.load`` restores it value- and dtype-exactly (an artifact the
    reference saved loads too);
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

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.interfaces import (
    Algorithm,
    Estimator,
    FittedEstimator,
    FittedTransformer,
    StreamFitable,
    Transformer,
)
from repro_torch.core.mltable import MLTable
from repro_torch.core.runner import CheckpointPolicy
from repro_torch.device import DeviceLike, resolve_device, to_tensor
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

    def save(self, ckpt_dir: str) -> str:
        """Publish the whole fitted pipeline (featurizer statistics + model
        state + configuration) as ONE atomic artifact through
        :mod:`repro_torch.checkpoint.store`; :meth:`Pipeline.load` restores
        it value- and dtype-exactly."""
        from repro_torch.checkpoint.store import save_artifact

        return save_artifact(ckpt_dir, self.partial,
                             metadata={"pipeline": self.host_state()})


class Pipeline(Estimator, StreamFitable):
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

    def split_config(self, config: Dict[str, Any]
                     ) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, Any]]:
        """Split a nested search config (``{"ngrams.top": 32,
        "logreg.learning_rate": 0.3}``) into per-transformer overrides and
        the estimator config.  Bare keys go to the estimator."""
        stage_names = set(self.stage_names())
        feat: Dict[str, Dict[str, Any]] = {}
        est: Dict[str, Any] = {}
        for key, v in config.items():
            if "." in key:
                stage, param = key.split(".", 1)
                if stage == self._estimator_name:
                    est[param] = v
                elif stage in stage_names:
                    feat.setdefault(stage, {})[param] = v
                else:
                    raise KeyError(
                        f"config key {key!r} addresses unknown stage "
                        f"{stage!r} (stages: {sorted(stage_names)}, "
                        f"estimator: {self._estimator_name!r})")
            else:
                est[key] = v
        return feat, est

    def with_stage_config(self, feat_cfgs: Dict[str, Dict[str, Any]]
                          ) -> "Pipeline":
        """A clone with transformer hyperparameters replaced (the estimator
        instance is shared — its trials carry their own config)."""
        stages: List[Any] = [
            (n, s.clone_with(**feat_cfgs[n]) if n in feat_cfgs else s)
            for n, s in self._stages]
        if self._estimator is not None:
            stages.append((self._estimator_name, self._estimator))
        return Pipeline(stages, num_shards=self.num_shards, device=self.device,
                        supervised=self.supervised)

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

    def fit_stream(self, data: Any, *, num_epochs: Optional[int] = None,
                   chunks_per_epoch: int = 1,
                   checkpoint: Union[None, str, CheckpointPolicy] = None,
                   resume: bool = False, **stream_kwargs: Any
                   ) -> FittedPipeline:
        """Streaming fit: the transformers fit (or, on resume, are
        *restored*) as in :meth:`fit`, then the estimator trains from
        per-epoch windows of the featurized table through
        :meth:`repro_torch.core.runner.DistributedRunner.run_epochs` (the
        window is the table on its device, so no epoch copies it).

        With a checkpoint, every snapshot is ONE atomic file holding the
        featurizer state, the model state and the stream position
        (:class:`CheckpointPolicy` ``extra_state``); ``resume=True``
        restores all three from the newest snapshot and continues bit for
        bit — the featurizers are rebuilt from the snapshot, never refit,
        and a snapshot without pipeline state refuses."""
        from repro_torch.data.pipeline import BatchIterator

        est = self._estimator
        if not isinstance(est, StreamFitable):
            raise TypeError(
                f"terminal estimator {type(est).__name__} does not "
                f"support fit_stream")
        if isinstance(checkpoint, str):
            checkpoint = CheckpointPolicy(checkpoint)
        if resume and checkpoint is None:
            raise ValueError("resume=True requires a checkpoint")

        if resume:
            fitted, num_cols = self._restore_stages(checkpoint, est)
            final = self._transform_stages(fitted, data)
            if final.num_cols != num_cols:
                raise ValueError(
                    f"resumed featurizers produce {final.num_cols} columns "
                    f"but the snapshot was written with {num_cols} — "
                    f"different raw data?")
        else:
            fitted, final = self._fit_stages(data)
            num_cols = final.num_cols
            if checkpoint is not None:
                checkpoint.extra_state = {
                    "stages": {n: f.partial for n, f in fitted}}
                checkpoint.extra_metadata = {"pipeline": {
                    "stages": [[n, f.host_state()] for n, f in fitted],
                    "num_cols": int(num_cols)}}

        X = final.data
        stream = BatchIterator(lambda step: {"data": X}, device=final.device)
        model = est.fit_stream(stream, num_epochs=num_epochs,
                               num_shards=final.num_shards,
                               chunks_per_epoch=chunks_per_epoch,
                               checkpoint=checkpoint, resume=resume,
                               **stream_kwargs)
        return FittedPipeline(self, fitted, model, num_cols, final.device)

    # ------------------------------------------------------------------ #
    # restore
    # ------------------------------------------------------------------ #
    @staticmethod
    def _stage_templates(pmeta: dict) -> Dict[str, Any]:
        return {name: FITTED_KINDS[hs["kind"]].partial_template(hs)
                for name, hs in pmeta["stages"]}

    @staticmethod
    def _rebuild_stages(pmeta: dict, arrays: Dict[str, Any],
                        device: torch.device) -> List[Tuple[str, FittedTransformer]]:
        return [(name, FITTED_KINDS[hs["kind"]].from_state(
                     hs, arrays.get(name, {}), device=device))
                for name, hs in pmeta["stages"]]

    def _restore_stages(self, policy: CheckpointPolicy, est: Any):
        """Rebuild the fitted featurizers from the newest streaming
        snapshot (one atomic file: the model carry restores beside them in
        :meth:`DistributedRunner.resume`) and prime the policy so later
        snapshots keep carrying the same state."""
        from repro_torch.checkpoint.store import load_metadata, \
            restore_with_metadata

        meta = load_metadata(policy.ckpt_dir)
        if not meta or "pipeline" not in (meta.get("extra") or {}):
            raise ValueError(
                f"newest checkpoint under {policy.ckpt_dir} carries no "
                f"pipeline state — was it written by Pipeline.fit_stream?")
        pmeta = meta["extra"]["pipeline"]
        num_cols = int(pmeta["num_cols"])
        device = resolve_device(self.device)
        templates = {"stages": self._stage_templates(pmeta)}
        tree, _, _ = restore_with_metadata(
            policy.ckpt_dir,
            {"state": est.stream_state_template(num_cols), "extra": templates},
            device=device)
        fitted = self._rebuild_stages(pmeta, tree["extra"]["stages"], device)
        policy.extra_state = tree["extra"]
        policy.extra_metadata = meta["extra"]
        return fitted, num_cols

    def load(self, ckpt_dir: str) -> FittedPipeline:
        """Restore a fitted pipeline published by :meth:`FittedPipeline.save`
        (by either package) onto the pipeline's device — featurizer
        statistics and model state come back value- and dtype-exact."""
        from repro_torch.checkpoint.store import ARTIFACT_STEP, load_artifact, \
            load_metadata

        meta = load_metadata(ckpt_dir, ARTIFACT_STEP)
        if not meta or "pipeline" not in meta:
            raise ValueError(f"{ckpt_dir} holds no pipeline artifact")
        pmeta = meta["pipeline"]
        device = resolve_device(self.device)
        template: Dict[str, Any] = {"stages": self._stage_templates(pmeta)}
        if "model_shapes" in pmeta:
            # only the structure of a template is read
            template["model"] = {k: torch.empty(0) for k in pmeta["model_shapes"]}
        tree, _ = load_artifact(ckpt_dir, template, device=device)
        fitted = self._rebuild_stages(pmeta, tree["stages"], device)
        model = None
        if "model" in template:
            if self._estimator is None:
                raise ValueError(
                    "artifact carries a trained model but this pipeline "
                    "has no terminal estimator to rebuild it")
            model = self._estimator.rebuild(tree["model"])
        return FittedPipeline(self, fitted, model, int(pmeta["num_cols"]), device)
