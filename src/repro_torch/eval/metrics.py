"""Shard-aware evaluation metrics over row-partitioned tables.

Counterpart: ``src/repro/eval/metrics.py`` (``predictions``, ``accuracy``,
``log_loss``, ``rmse``, ``silhouette_lite`` and ``MetricHistory``).  Every
metric is a *sufficient-statistics* computation in MLI form: a local
function turns each partition's block into partial sums, one global
``combine="sum"`` through :class:`repro_torch.core.runner.DistributedRunner`
accumulates them, and a closed form gives the scalar.  No metric gathers
rows to one place.  The local functions take one partition's ``(rows,
cols)`` block, as the reference's do, and run partition after partition.

Predictors may be **stacked**: a prediction function (or centroid tensor)
with a leading (K, …) trial axis gives a (K,) score vector from the same
single pass.

Library convention (paper Fig. A4): supervised tables carry the label in
column 0 and the features in columns 1..d; ``predict`` receives only the
feature columns.
"""
from __future__ import annotations

from typing import Any, Callable, Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.runner import DistributedRunner
from repro_torch.device import to_tensor

__all__ = ["accuracy", "log_loss", "rmse", "silhouette_lite", "predictions",
           "MetricHistory"]

#: predict(X_block) -> (rows,) predictions, or (K, rows) for K stacked trials
PredictFn = Callable[[torch.Tensor], torch.Tensor]
Schedule = Union[str, CollectiveSchedule]

_EPS = 1e-7  # log-loss probability clip


def _per_block(local_fn: Callable[[torch.Tensor], torch.Tensor]):
    """``local_fn`` of one (rows, cols) block, run over every partition of
    the runner's (P, rows, cols) stack → (P, ...)."""
    return lambda blocks: torch.stack([torch.as_tensor(local_fn(b))
                                       for b in blocks])


def _sum_stats(table: Any, local_fn: Callable[[torch.Tensor], Any],
               schedule: Schedule) -> torch.Tensor:
    """One combined pass: ``local_fn(block) -> partial sums`` per partition,
    globally summed under ``schedule``."""
    runner = DistributedRunner.for_table(table, schedule=schedule)
    return runner.run_once(table, _per_block(local_fn), combine="sum")


def predictions(table: Any, predict: PredictFn, *,
                schedule: Schedule = CollectiveSchedule.GATHER_BROADCAST
                ) -> torch.Tensor:
    """Shard-aware batched predict: run ``predict`` on every partition's
    feature block and concatenate the per-partition outputs in row order
    (``combine="concat"``).  The whole table is treated as features — no
    label column is stripped."""
    runner = DistributedRunner.for_table(table, schedule=schedule)
    return runner.partition_apply(table.data, _per_block(predict), (), "concat")


def accuracy(table: Any, predict: PredictFn, *,
             schedule: Schedule = CollectiveSchedule.ALLREDUCE) -> torch.Tensor:
    """Fraction of rows whose predicted label matches column 0.

    ``predict(X)`` returns hard labels shaped ``(rows,)`` — or ``(K, rows)``
    for K stacked models, giving a ``(K,)`` result from one pass.
    """
    def local(block: torch.Tensor) -> torch.Tensor:
        pred = predict(block[:, 1:])
        return torch.sum((pred == block[:, 0]).to(torch.float32), dim=-1)

    return _sum_stats(table, local, schedule) / table.num_rows


def log_loss(table: Any, predict_proba: PredictFn, *,
             schedule: Schedule = CollectiveSchedule.ALLREDUCE) -> torch.Tensor:
    """Mean binary cross-entropy of ``predict_proba(X)`` against the 0/1
    label column (clipped at 1e-7).  Stacked probabilities ``(K, rows)``
    give a ``(K,)`` result."""
    def local(block: torch.Tensor) -> torch.Tensor:
        y = block[:, 0]
        p = torch.clamp(predict_proba(block[:, 1:]), _EPS, 1.0 - _EPS)
        nll = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
        return torch.sum(nll, dim=-1)

    return _sum_stats(table, local, schedule) / table.num_rows


def rmse(table: Any, predict: PredictFn, *,
         schedule: Schedule = CollectiveSchedule.ALLREDUCE) -> torch.Tensor:
    """Root-mean-squared error of ``predict(X)`` against column 0.  Stacked
    predictions ``(K, rows)`` give a ``(K,)`` result."""
    def local(block: torch.Tensor) -> torch.Tensor:
        err = predict(block[:, 1:]) - block[:, 0]
        return torch.sum(err * err, dim=-1)

    return torch.sqrt(_sum_stats(table, local, schedule) / table.num_rows)


def silhouette_lite(table: Any, centroids: Any, *,
                    schedule: Schedule = CollectiveSchedule.ALLREDUCE
                    ) -> torch.Tensor:
    """Centroid-based silhouette score in one pass (higher is better).

    Per row, ``a`` = distance to its nearest centroid, ``b`` = distance to
    the second-nearest, score ``(b - a) / max(a, b)`` — a shard-local
    computation whose mean is one global sum (the classic silhouette needs
    all pairwise distances, a full gather).

    ``centroids`` is ``(k, d)`` — or ``(K, k, d)`` for K stacked k-means
    trials, giving a ``(K,)`` score vector from the same pass.  The whole
    table is treated as features (no label column).
    """
    C = (centroids.to(table.data.device) if isinstance(centroids, torch.Tensor)
         else to_tensor(centroids, table.data.device))

    def row_scores(X: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
        d2 = torch.sum((X[:, None, :] - cents[None, :, :]) ** 2, dim=-1)
        two = torch.topk(-d2, 2, dim=-1).values      # two smallest, negated
        two = torch.clamp(-two, min=0.0)             # clamp fp-negative d²
        a = torch.sqrt(two[:, 0])
        b = torch.sqrt(two[:, 1])
        denom = torch.clamp(torch.maximum(a, b), min=_EPS)
        return (b - a) / denom

    def local(block: torch.Tensor) -> torch.Tensor:
        if C.ndim == 3:
            return torch.stack([torch.sum(row_scores(block, c), dim=-1) for c in C])
        return torch.sum(row_scores(block, C), dim=-1)

    return _sum_stats(table, local, schedule) / table.num_rows


class MetricHistory:
    """Per-rung metric snapshots keyed by ``(trial, metric, epoch)``.

    Each evaluation boundary records one value per (trial, metric).
    Recording the same key twice **overwrites** — the idempotence a
    killed-and-resumed search relies on when it replays boundaries it
    already recorded.  ``series`` returns one trial's trajectory as
    ``[(epoch, value), …]`` in epoch order, regardless of recording order.
    """

    def __init__(self) -> None:
        # trial -> metric -> {epoch: value}
        self._h: dict = {}

    def record(self, trial: int, metric: str, epoch: int, value: float) -> None:
        self._h.setdefault(int(trial), {}).setdefault(str(metric), {})[
            int(epoch)] = float(value)

    def trials(self) -> list:
        return sorted(self._h)

    def metrics(self, trial: int) -> list:
        return sorted(self._h.get(int(trial), {}))

    def series(self, trial: int, metric: str) -> list:
        points = self._h.get(int(trial), {}).get(str(metric), {})
        return sorted(points.items())

    def last(self, trial: int, metric: str):
        series = self.series(trial, metric)
        return series[-1][1] if series else None

    def to_dict(self) -> dict:
        """JSON-able nested dict (epoch keys become strings)."""
        return {str(t): {m: {str(e): v for e, v in sorted(points.items())}
                         for m, points in metrics.items()}
                for t, metrics in self._h.items()}

    def __len__(self) -> int:
        return sum(len(points) for metrics in self._h.values()
                   for points in metrics.values())
