"""Principal Component Analysis through the MLI contract (supporting the
paper's §IV claim that the API 'naturally extends to a diverse group of ML
algorithms').

Counterpart: ``src/repro/core/algorithms/pca.py`` (the whole file).

The local function :func:`_local_moments` emits each partition's
[Σx ; XᵀX] block; one global sum through
:class:`repro_torch.core.runner.DistributedRunner`, then a local
eigendecomposition of the d×d covariance (only O(d²) crosses the wire,
never the data).

The covariance is the reference's fp32 formula ``total/n − outer(mean,
mean)``, kept as it is: it cancels where the mean's square is near the
second moment, as ``Standardizer``'s variance does.  ``torch.linalg.eigh``
(LAPACK on the CPU, cuSOLVER on the card) may return a component with the
other sign than the reference's; a component is defined up to its sign.
"""
from __future__ import annotations

import dataclasses
from typing import Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.interfaces import Model, NumericAlgorithm
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import DistributedRunner

__all__ = ["PCAParameters", "PCAModel", "PCA"]


@dataclasses.dataclass
class PCAParameters:
    n_components: int = 2
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE


def _local_moments(blocks: torch.Tensor) -> torch.Tensor:
    """Every partition's (d+1, d) block [Σx ; XᵀX]: (P, rows, d) →
    (P, d+1, d)."""
    s = blocks.sum(dim=1, keepdim=True)                        # (P, 1, d)
    gram = torch.bmm(blocks.transpose(1, 2), blocks)           # (P, d, d)
    return torch.cat([s, gram], dim=1)


class PCAModel(Model):
    def __init__(self, components: torch.Tensor, mean: torch.Tensor,
                 explained_variance: torch.Tensor):
        self.components = components                    # (k, d) rows = PCs
        self.mean = mean                                # (d,)
        self.explained_variance = explained_variance    # (k,)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        """Project (n, d) -> (n, k)."""
        return (x - self.mean) @ self.components.T

    transform = predict

    def inverse_transform(self, z: torch.Tensor) -> torch.Tensor:
        return z @ self.components + self.mean

    @property
    def partial(self):
        return {"components": self.components, "mean": self.mean,
                "explained_variance": self.explained_variance}


class PCA(NumericAlgorithm[PCAParameters, PCAModel]):
    """Instance-based Estimator: ``PCA(n_components=2).fit(table)``."""

    Parameters = PCAParameters
    supervised = False

    def fit(self, data: MLNumericTable) -> PCAModel:
        p = self.params
        n = data.num_rows
        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        total = runner.run_once(data, _local_moments, combine="sum")  # (d+1, d)
        mean = total[0] / n
        cov = total[1:] / n - torch.outer(mean, mean)

        evals, evecs = torch.linalg.eigh(cov)                          # ascending
        # the reference's argsort(evals)[::-1]: descending, ties reversed
        order = torch.argsort(evals, stable=True).flip(0)[: p.n_components]
        return PCAModel(evecs[:, order].T, mean, evals[order])

    def rebuild(self, partial) -> PCAModel:
        return PCAModel(partial["components"], partial["mean"],
                        partial["explained_variance"])
