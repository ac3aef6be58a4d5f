"""Synthetic datasets matching the paper's experimental data — the port's own
numpy copy of ``src/repro/data/synthetic.py`` (``synth_classification`` and
``synth_imagenet_features``), so the port needs nothing from the reference
package.  Same seeds give the same arrays as the reference.

  * ``synth_imagenet_features`` — the paper's §IV-A data: dense feature
    vectors (they used 160K-dim featurized ImageNet) with labels from a
    planted linear model.
  * ``synth_classification`` — small dense classification sets for tests.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["synth_classification", "synth_imagenet_features"]


def synth_classification(n: int, d: int, seed: int = 0, noise: float = 0.05
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Linearly separable-ish binary data.  Returns (X, y, w_true)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=d) / np.sqrt(d)
    X = rng.normal(size=(n, d)).astype(np.float32)
    margin = X @ w
    flip = rng.random(n) < noise
    y = ((margin > 0) ^ flip).astype(np.float32)
    return X, y, w.astype(np.float32)


def synth_imagenet_features(n: int, d: int = 4096, seed: int = 0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense featurized-image stand-in (paper used d=160K; tests scale d
    down).  Features are ReLU'd gaussians (non-negative, sparse-ish like
    conv features); labels from a planted linear model."""
    rng = np.random.default_rng(seed)
    X = np.maximum(rng.normal(size=(n, d)), 0).astype(np.float32)
    w = rng.normal(size=d) / np.sqrt(d)
    y = ((X @ w) > np.median(X @ w)).astype(np.float32)
    return X, y
