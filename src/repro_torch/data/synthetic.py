"""Synthetic datasets matching the paper's experimental data — the port's own
numpy copy of ``src/repro/data/synthetic.py`` (``synth_classification``,
``synth_imagenet_features``, ``synth_netflix_tiled``, ``synth_text_corpus``
and ``synth_labeled_text``; ``SyntheticLMDataset`` waits), so the port
needs nothing from the reference package.  Same seeds give the same arrays
and strings as the reference.

  * ``synth_imagenet_features`` — the paper's §IV-A data: dense feature
    vectors (they used 160K-dim featurized ImageNet) with labels from a
    planted linear model.
  * ``synth_netflix_tiled`` — the paper's §IV-B collaborative-filtering
    data: a low-rank + noise ratings matrix with Netflix-like sparsity,
    tiled t× as the paper scales it.  It draws a dense matrix on the host,
    so it serves the tests' sizes; ``chip_smoke.py`` draws the Netflix
    shape on the card with the same recipe.
  * ``synth_classification`` — small dense classification sets for tests.
  * ``synth_text_corpus`` / ``synth_labeled_text`` — text for the Fig. A2
    pipeline (topic- or class-biased draws from a 26-word vocabulary).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["synth_classification", "synth_imagenet_features",
           "synth_netflix_tiled", "synth_text_corpus", "synth_labeled_text"]


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


def synth_netflix_tiled(
    users: int = 480, items: int = 178, rank: int = 10, tiles: int = 1,
    density: float = 0.011, seed: int = 0,
) -> np.ndarray:
    """Dense (users·t, items·t) fp32 ratings matrix with zeros for
    unobserved entries: a rank-``rank`` base U·Vᵀ plus 0.1·noise, mapped to
    2.5 + 1.5·(that) and clipped to [1, 5], kept where a Bernoulli(density)
    mask is set.  ``tiles`` repeats the base block-diagonally, which keeps
    every row's and column's degree (the paper's "repeatedly tiling the
    Netflix dataset")."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(users, rank)) / np.sqrt(rank)
    V = rng.normal(size=(items, rank)) / np.sqrt(rank)
    base = U @ V.T + 0.1 * rng.normal(size=(users, items))
    base = np.clip(2.5 + 1.5 * base, 1.0, 5.0)
    mask = rng.random((users, items)) < density
    base = np.where(mask, base, 0.0).astype(np.float32)
    if tiles == 1:
        return base
    out = np.zeros((users * tiles, items * tiles), np.float32)
    for t in range(tiles):
        out[t * users:(t + 1) * users, t * items:(t + 1) * items] = base
    return out


_WORDS = ("the quick brown fox jumps over lazy dog machine learning api "
          "distributed table matrix gradient descent cluster spark data "
          "feature model train test scale pod mesh kernel").split()


def synth_text_corpus(n_docs: int = 64, words_per_doc: int = 30,
                      seed: int = 0) -> List[str]:
    """Tiny synthetic corpus for the Fig. A2 pipeline (nGrams → tfIdf →
    KMeans).  Docs are drawn from topic-biased word distributions so
    clustering has structure to find."""
    rng = np.random.default_rng(seed)
    n_topics = 4
    topic_bias = rng.dirichlet(np.ones(len(_WORDS)) * 0.3, size=n_topics)
    docs = []
    for i in range(n_docs):
        p = topic_bias[i % n_topics]
        docs.append(" ".join(rng.choice(_WORDS, size=words_per_doc, p=p)))
    return docs


def synth_labeled_text(n_docs: int = 64, words_per_doc: int = 20,
                       seed: int = 0) -> List[Tuple[float, str]]:
    """Binary text-classification corpus for the Fig. A2 end-to-end story:
    ``(label, text)`` rows whose word distributions are class-biased (each
    class favors half the vocabulary), so a served text pipeline has
    signal to learn.  Pure function of the arguments."""
    rng = np.random.default_rng(seed)
    half = len(_WORDS) // 2
    bias = np.full(len(_WORDS), 0.25 / (len(_WORDS) - half))
    p0, p1 = bias.copy(), bias.copy()
    p0[:half] = 0.75 / half
    p1[half:] = 0.75 / (len(_WORDS) - half)
    p0, p1 = p0 / p0.sum(), p1 / p1.sum()
    rows = []
    for i in range(n_docs):
        label = i % 2
        p = p1 if label else p0
        rows.append((float(label),
                     " ".join(rng.choice(_WORDS, size=words_per_doc, p=p))))
    return rows
