"""Carry a model of the JAX reference into the port.

No counterpart module in ``src/repro/``.  Two entry points:

* :func:`from_reference` — a fitted model's state: the reference's models
  expose it as ``partial`` — ``{"weights": (d,)}`` for logistic
  regression, ``{"centroids": (k, d)}`` for k-means — and this turns it
  into the port's fitted model on ``device``.
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

from repro_torch.core.algorithms.kmeans import KMeansModel, KMeansParameters
from repro_torch.core.algorithms.logistic_regression import (
    LogisticRegressionModel,
    LogisticRegressionParameters,
)
from repro_torch.device import DeviceLike, resolve_device, to_tensor
from repro_torch.models.layers.quant import QTensor
from repro_torch.models.layers.ssd import ssd_shapes
from repro_torch.models.params import place

__all__ = ["from_reference", "lm_from_reference"]

_KINDS = {
    "logistic_regression": ("weights", LogisticRegressionParameters),
    "kmeans": ("centroids", KMeansParameters),
}


def from_reference(kind: str, partial: Mapping[str, Any],
                   params: Optional[Any] = None,
                   device: DeviceLike = None):
    """The port's fitted model of ``kind`` (``"logistic_regression"`` or
    ``"kmeans"``) from the reference model's ``partial`` state, on
    ``device`` (the CUDA card unless ``device="cpu"``).  ``params`` are the
    port's parameters for the model (defaults when omitted)."""
    if kind not in _KINDS:
        raise ValueError(f"unknown model kind {kind!r} (one of {sorted(_KINDS)})")
    key, params_cls = _KINDS[kind]
    if set(partial) != {key}:
        raise ValueError(f"a {kind} partial holds exactly {{{key!r}}}, got "
                         f"{sorted(partial)}")
    dev = resolve_device(device)
    state = to_tensor(partial[key], dev)
    params = params if params is not None else params_cls()
    if kind == "kmeans":
        return KMeansModel(state, params)
    return LogisticRegressionModel(params, state)


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

