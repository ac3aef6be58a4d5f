"""Gaussian Naive Bayes through the MLI contract (the API extends to
non-gradient algorithms, as ``pca.py`` shows).

Counterpart: ``src/repro/core/algorithms/naive_bayes.py`` (the whole file).

ONE pass of the local function :func:`_local_stats` emits every
partition's sufficient statistics for every class (count, Σx, Σx²) as a
fixed-shape block; :class:`repro_torch.core.runner.DistributedRunner` sums
them; closed-form class-conditional Gaussians follow.  Labels sit in column
0 as integers 0..C−1.

Two spellings follow the reference's semantics rather than PyTorch's:
the label converts to int32 by truncation toward zero (``astype``), and
the one-hot is ``y == arange(C)``, which gives a zero row for a label
outside 0..C−1 where ``jax.nn.one_hot`` does (``F.one_hot`` raises).
``predict_log_proba`` sums over the features in :func:`fixed_sum`'s order,
so a served row is bitwise its offline prediction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.fixed_sum import fixed_sum
from repro_torch.core.interfaces import Model, NumericAlgorithm
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import DistributedRunner

__all__ = ["NaiveBayesParameters", "NaiveBayesModel", "GaussianNaiveBayes"]

# elements of the (rows, C, d) log-likelihood terms held at once
_CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass
class NaiveBayesParameters:
    num_classes: int = 2
    var_smoothing: float = 1e-6
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE


def _local_stats(blocks: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Every partition's (C, 1+2d) block [count | Σx | Σx²]: (P, rows,
    1+d) → (P, C, 1+2d)."""
    y = blocks[..., 0].to(torch.int32)                     # truncates, as astype
    x = blocks[..., 1:]
    classes = torch.arange(num_classes, dtype=torch.int32, device=blocks.device)
    onehot = (y.unsqueeze(-1) == classes).to(x.dtype)      # (P, rows, C)
    cnt = onehot.sum(dim=1).unsqueeze(-1)                  # (P, C, 1)
    s1 = torch.bmm(onehot.transpose(1, 2), x)              # (P, C, d)
    s2 = torch.bmm(onehot.transpose(1, 2), x * x)          # (P, C, d)
    return torch.cat([cnt, s1, s2], dim=-1)


class NaiveBayesModel(Model):
    def __init__(self, priors, means, variances):
        self.priors = priors          # (C,)
        self.means = means            # (C, d)
        self.variances = variances    # (C, d)

    def predict_log_proba(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) -> (n, C) unnormalized log posterior, the reference's
        broadcast (n, C, d) formula over row chunks."""
        C, d = self.means.shape
        step = max(1, _CHUNK_ELEMENTS // max(1, C * d))
        log_norm = torch.log(2 * math.pi * self.variances)
        log_priors = torch.log(self.priors)
        out = []
        for i in range(0, x.shape[0], step):
            xc = x[i:i + step, None, :]                                # (n, 1, d)
            ll = -0.5 * (log_norm + (xc - self.means) ** 2 / self.variances)
            out.append(fixed_sum(ll) + log_priors)
        return torch.cat(out) if out else x.new_zeros((0, C))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """The most likely class (int32; ties go to the first)."""
        return torch.argmax(self.predict_log_proba(x), dim=-1).to(torch.int32)

    @property
    def partial(self):
        return {"priors": self.priors, "means": self.means,
                "variances": self.variances}


class GaussianNaiveBayes(NumericAlgorithm[NaiveBayesParameters, NaiveBayesModel]):
    """Instance-based Estimator: ``GaussianNaiveBayes(num_classes=3)
    .fit(table)``."""

    Parameters = NaiveBayesParameters
    supervised = True

    def fit(self, data: MLNumericTable) -> NaiveBayesModel:
        p = self.params
        d = data.num_cols - 1
        n = data.num_rows
        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        tot = runner.run_once(data, _local_stats, p.num_classes,
                              combine="sum")                    # (C, 1+2d)
        cnt = torch.clamp(tot[:, 0], min=1.0)                   # (C,)
        mean = tot[:, 1:1 + d] / cnt[:, None]
        var = tot[:, 1 + d:] / cnt[:, None] - mean ** 2
        var = torch.clamp(var, min=0.0) + p.var_smoothing
        priors = cnt / n
        return NaiveBayesModel(priors, mean, var)

    def rebuild(self, partial) -> NaiveBayesModel:
        return NaiveBayesModel(partial["priors"], partial["means"],
                               partial["variances"])
