"""Carry a model fitted by the JAX reference into the port.

No counterpart module in ``src/repro/``: the reference's fitted models
expose their state as ``partial`` — ``{"weights": (d,)}`` for logistic
regression, ``{"centroids": (k, d)}`` for k-means — and
:func:`from_reference` turns that state, as host (numpy) arrays, into the
port's fitted model on ``device``.  The caller converts the reference's
arrays with ``np.asarray``; this module imports nothing of the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional

from repro_torch.core.algorithms.kmeans import KMeansModel, KMeansParameters
from repro_torch.core.algorithms.logistic_regression import (
    LogisticRegressionModel,
    LogisticRegressionParameters,
)
from repro_torch.device import DeviceLike, resolve_device, to_tensor

__all__ = ["from_reference"]

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
