"""Carry a model of the JAX reference into the port.

No counterpart module in ``src/repro/``.  Three entry points:

* :func:`from_reference` — a fitted model's state: the reference's models
  expose it as ``partial`` — ``{"weights": (d,)}`` for logistic
  regression and the two GLMs, ``{"centroids": (k, d)}`` for k-means,
  ``{"components", "mean", "explained_variance"}`` for PCA, ``{"priors",
  "means", "variances"}`` for naive Bayes, ``{"U", "V"}`` for ALS — and
  this turns it into the port's fitted model on ``device``.
* :func:`pipeline_from_reference` — a fitted pipeline: the reference's
  ``FittedPipeline.host_state()`` (the vocabulary, ``n``, ``column``,
  ``keep_columns``, the skip and label indices, each stage's kind) and
  its ``partial`` (the IDF weights, ``shift`` / ``scale``, the terminal
  model's state) — the two halves its ``save`` writes — as the port's
  ``FittedPipeline`` on ``device``.
* :func:`lm_from_reference` — the param tree of the reference's
  ``init_model`` (optionally after its ``quantize_model_params``) as the
  port's transformer params, leaf for leaf under the same key names.

The caller converts the reference's arrays to host (numpy) arrays; this
module imports nothing of the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.algorithms.als import (
    ALSParameters,
    BroadcastALS,
    MatrixFactorizationModel,
)
from repro_torch.core.algorithms.kmeans import KMeans, KMeansModel, KMeansParameters
from repro_torch.core.algorithms.linear_models import (
    GeneralizedLinearModel,
    LinearRegressionAlgorithm,
    LinearRegressionParameters,
    LinearSVMAlgorithm,
    LinearSVMParameters,
)
from repro_torch.core.algorithms.logistic_regression import (
    LogisticRegressionAlgorithm,
    LogisticRegressionModel,
    LogisticRegressionParameters,
)
from repro_torch.core.algorithms.naive_bayes import (
    GaussianNaiveBayes,
    NaiveBayesModel,
    NaiveBayesParameters,
)
from repro_torch.core.algorithms.pca import PCA, PCAModel, PCAParameters
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.models.layers.quant import QTensor
from repro_torch.models.layers.ssd import ssd_shapes
from repro_torch.models.params import place

__all__ = ["from_reference", "pipeline_from_reference", "lm_from_reference"]

#: kind → (its partial's keys, its parameters class, the model's builder
#: ``(state dict, params) -> model``)
_KINDS = {
    "logistic_regression": (("weights",), LogisticRegressionParameters,
                            lambda s, p: LogisticRegressionModel(p, s["weights"])),
    "kmeans": (("centroids",), KMeansParameters,
               lambda s, p: KMeansModel(s["centroids"], p)),
    "linear_regression": (("weights",), LinearRegressionParameters,
                          lambda s, p: GeneralizedLinearModel(s["weights"])),
    "linear_svm": (("weights",), LinearSVMParameters,
                   lambda s, p: GeneralizedLinearModel(s["weights"], link=torch.sign)),
    "pca": (("components", "mean", "explained_variance"), PCAParameters,
            lambda s, p: PCAModel(s["components"], s["mean"], s["explained_variance"])),
    "naive_bayes": (("priors", "means", "variances"), NaiveBayesParameters,
                    lambda s, p: NaiveBayesModel(s["priors"], s["means"], s["variances"])),
    "als": (("U", "V"), ALSParameters,
            lambda s, p: MatrixFactorizationModel(s["U"], s["V"], p)),
}

#: the port's estimator classes → their kind
_KIND_OF = {LogisticRegressionAlgorithm: "logistic_regression", KMeans: "kmeans",
            LinearRegressionAlgorithm: "linear_regression",
            LinearSVMAlgorithm: "linear_svm", PCA: "pca",
            GaussianNaiveBayes: "naive_bayes", BroadcastALS: "als"}


def from_reference(kind: str, partial: Mapping[str, Any],
                   params: Optional[Any] = None,
                   device: DeviceLike = None):
    """The port's fitted model of ``kind`` (one of ``_KINDS``:
    ``"logistic_regression"``, ``"kmeans"``, ``"linear_regression"``,
    ``"linear_svm"``, ``"pca"``, ``"naive_bayes"``, ``"als"``) from the
    reference model's ``partial`` state, on ``device`` (the CUDA card
    unless ``device="cpu"``).  ``params`` are the port's parameters for the
    model (defaults when omitted)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown model kind {kind!r} (one of {sorted(_KINDS)})")
    keys, params_cls, build = _KINDS[kind]
    if set(partial) != set(keys):
        raise ValueError(f"a {kind} partial holds exactly {sorted(keys)}, got "
                         f"{sorted(partial)}")
    dev = resolve_device(device)
    state = {k: to_tensor(partial[k], dev) for k in keys}
    return build(state, params if params is not None else params_cls())


def pipeline_from_reference(pipeline: Any, host_state: Mapping[str, Any],
                            partial: Mapping[str, Any],
                            device: DeviceLike = None):
    """The port's fitted form of ``pipeline`` (a port
    :class:`~repro_torch.pipeline.Pipeline` with the reference pipeline's
    stages) from the reference ``FittedPipeline``'s ``host_state()`` and
    ``partial`` (host arrays), on ``device`` (the CUDA card unless
    ``device="cpu"``).  The terminal model comes through
    :func:`from_reference` with the port estimator's parameters."""
    from repro_torch.pipeline.pipeline import FITTED_KINDS, FittedPipeline

    dev = resolve_device(device)
    names = [name for name, _ in host_state["stages"]]
    if names != pipeline.stage_names():
        raise ValueError(f"the reference's stages {names} are not the "
                         f"pipeline's {pipeline.stage_names()}")
    arrays = partial.get("stages", {})
    stages = [(name, FITTED_KINDS[hs["kind"]].from_state(
                   hs, arrays.get(name, {}), device=dev))
              for name, hs in host_state["stages"]]
    model = None
    if "model" in partial:
        est = pipeline.estimator
        if est is None:
            raise ValueError("the reference carries a trained model but the "
                             "pipeline has no terminal estimator")
        model = from_reference(_KIND_OF[type(est)], partial["model"],
                               est.params, dev)
    return FittedPipeline(pipeline, stages, model, host_state["num_cols"], dev)


def _lm_leaf(leaf, device: torch.device):
    if isinstance(leaf, tuple):
        # a QTensor as (q, scale, n_contract); every quantized projection
        # is stacked on the layer axis, so one leading batch axis
        q, scale, nc = leaf
        return QTensor.from_q(_lm_leaf(q, device), _lm_leaf(scale, device),
                              int(nc), n_batch=1)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":     # ml_dtypes' bfloat16: same bits
        bits = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        return bits.view(torch.bfloat16).to(device)
    return to_tensor(arr, device)


def lm_from_reference(params: Mapping[str, Any], cfg=None,
                      device: DeviceLike = None):
    """The port's transformer params from the reference's ``init_model``
    tree, on ``device`` (the CUDA card unless ``device="cpu"``).

    ``params`` is the reference's nested dict with host leaves: numpy
    arrays (bf16 as ``ml_dtypes.bfloat16`` or cast to float32 by the
    caller) and each ``QTensor`` as the tuple ``(q, scale, n_contract)``.
    ``cfg`` (the port's ``ArchConfig``), when given, is checked against the
    tree's widths: the embedding table, and every SSD block's leaves (key
    set and shapes, stacked on the layer axis).  The leaves reach the
    device through ``models/params.py``'s ``place`` (on the card the plain
    projection weights take ``kernel_layout`` on the host, before they
    move)."""
    dev = resolve_device(device)
    cpu = torch.device("cpu")

    def walk(tree, path=()):
        if isinstance(tree, Mapping):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return _lm_leaf(tree, dev)
        return place(_lm_leaf(tree, cpu), dev, path)

    out = walk(params)
    if cfg is not None:
        tok = out["embed"]["tok"]
        if tuple(tok.shape) != (cfg.vocab_size, cfg.d_model):
            raise ValueError(f"embed/tok {tuple(tok.shape)} does not match "
                             f"{cfg.name}'s ({cfg.vocab_size}, {cfg.d_model})")
        want = {k: (cfg.num_periods,) + v for k, v in ssd_shapes(cfg).items()}
        for name, block in out["blocks"].items():
            if "ssd" not in block:
                continue
            got = {k: tuple(v.shape) for k, v in block["ssd"].items()}
            if got != want:
                raise ValueError(f"blocks/{name}/ssd {got} does not match "
                                 f"{cfg.name}'s {want}")
    return out

