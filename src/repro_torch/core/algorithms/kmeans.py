"""K-Means clustering (the terminal stage of the paper's Fig. A2 pipeline:
``KMeans(featurizedTable, k=50)``).

Counterpart: ``src/repro/core/algorithms/kmeans.py`` (parameters, model,
``_assign``, ``_local_stats``, ``_centroid_update``, ``fit``,
``fit_stream`` and ``stream_state_template``; ``trial_spec`` waits for the
model-search slice).

Lloyd's algorithm in MLI primitives: :func:`_local_stats` computes every
partition's (per-cluster sum, count) statistics against the current
centroids, the runner sums them across partitions and the update rebuilds
the centroids; empty clusters keep their previous centroid.

The assignment has two forms, as in the reference, and they may disagree on
near-ties only: the default is the direct difference form
``argmin ||x − c||²``; ``use_kernel`` takes the expanded form
``argmin (||c||² − 2·x·c)`` through the ``kmeans_assign`` CUDA kernel, one
launch per round for all partitions.

Initialisation differs from the reference, which draws rows with
``jax.random.permutation``: ``fit`` draws ``k`` distinct rows with a
``torch.Generator`` seeded from ``seed``, or starts from ``init_centroids``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.interfaces import Model, NumericAlgorithm, StreamFitable
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import CheckpointPolicy, DistributedRunner
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels import kmeans_assign as kka

__all__ = ["KMeansParameters", "KMeansModel", "KMeans"]

# elements of the (rows, k, d) difference tensor the direct form holds at
# once; it is computed over row chunks of at most this size
_DIRECT_CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass
class KMeansParameters:
    k: int = 8
    max_iter: int = 20
    seed: int = 0
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
    use_kernel: bool = False  # route assignment through the CUDA kernel


def _direct_sq_dists(x: torch.Tensor, centroids: torch.Tensor,
                     reduce) -> torch.Tensor:
    """``reduce(Σ_d (x − c)², dim=-1)`` for rows ``x`` (..., n, d), in row
    chunks so the (rows, k, d) difference never exceeds
    ``_DIRECT_CHUNK_ELEMENTS``."""
    k, d = centroids.shape
    flat = x.reshape(-1, d)
    step = max(1, _DIRECT_CHUNK_ELEMENTS // max(1, k * d))
    out = [reduce(((flat[i:i + step, None, :] - centroids[None]) ** 2).sum(-1),
                  dim=-1)
           for i in range(0, flat.shape[0], step)]
    return torch.cat(out).reshape(x.shape[:-1])


def _assign(x: torch.Tensor, centroids: torch.Tensor,
            use_kernel: bool = False) -> torch.Tensor:
    """Nearest-centroid assignment of rows ``x`` (..., n, d) — THE Lloyd hot
    path (O(rows·k·d) per round) → (..., n) int32.  ``use_kernel`` routes it
    through the fused expanded-form kernel; the default is the direct
    difference form."""
    if use_kernel:
        return kka.kmeans_assign(x, centroids)
    return _direct_sq_dists(x, centroids, torch.argmin).to(torch.int32)


class KMeansModel(Model):
    def __init__(self, centroids: torch.Tensor, params: KMeansParameters):
        self.centroids = centroids
        self.params = params

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return _assign(x, self.centroids, self.params.use_kernel)

    def inertia(self, x: torch.Tensor) -> torch.Tensor:
        return _direct_sq_dists(x, self.centroids, torch.amin).sum()

    @property
    def partial(self):
        return {"centroids": self.centroids}


def _local_stats(blocks: torch.Tensor, centroids: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    """Per-partition (k, d+1) [cluster sums | counts] for blocks
    (P, rows, d) → (P, k, d+1)."""
    k = centroids.shape[0]
    assign = _assign(blocks, centroids, use_kernel)                  # (P, rows)
    onehot = F.one_hot(assign.long(), k).to(blocks.dtype)            # (P, rows, k)
    sums = onehot.transpose(1, 2) @ blocks                           # (P, k, d)
    counts = onehot.sum(dim=1).unsqueeze(-1)                         # (P, k, 1)
    return torch.cat([sums, counts], dim=-1)


def _centroid_update(centroids: torch.Tensor, tot: torch.Tensor) -> torch.Tensor:
    """Rebuild centroids from combined (sums | counts) statistics; empty
    clusters keep their previous centroid."""
    d = centroids.shape[1]
    sums, counts = tot[:, :d], tot[:, d:]
    return torch.where(counts > 0, sums / torch.clamp(counts, min=1.0),
                       centroids)


class KMeans(NumericAlgorithm[KMeansParameters, KMeansModel], StreamFitable):
    """Instance-based Estimator: ``KMeans(k=4, seed=0).fit(table) ->
    KMeansModel``."""

    Parameters = KMeansParameters
    supervised = False

    def fit(self, data: MLNumericTable,
            init_centroids: Optional[torch.Tensor] = None) -> KMeansModel:
        """Lloyd rounds from ``init_centroids`` ((k, d), moved to the
        table's device), or from ``k`` distinct rows drawn with a
        ``torch.Generator`` seeded from ``params.seed``."""
        p = self.params
        n = data.num_rows
        if p.k > n:
            raise ValueError("k exceeds number of rows")
        if init_centroids is None:
            gen = torch.Generator().manual_seed(p.seed)
            rows = torch.randperm(n, generator=gen)[: p.k]
            centroids = data.data[rows.to(data.device)]
        else:
            centroids = torch.as_tensor(init_centroids).to(
                device=data.device, dtype=data.data.dtype)
            if tuple(centroids.shape) != (p.k, data.num_cols):
                raise ValueError(
                    f"init_centroids{tuple(centroids.shape)} must be "
                    f"({p.k}, {data.num_cols})")

        def local_step(blocks, centroids, r):
            return _local_stats(blocks, centroids, p.use_kernel)

        def update(centroids, tot, r):
            return _centroid_update(centroids, tot)

        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        centroids = runner.run_rounds(data, centroids, local_step, p.max_iter,
                                      combine="sum", update=update)
        return KMeansModel(centroids, p)

    def rebuild(self, partial) -> KMeansModel:
        return KMeansModel(partial["centroids"], self.params)

    def stream_state_template(self, num_cols: int) -> torch.Tensor:
        """Shape and dtype template of the streaming carry (the centroids)
        for a table of ``num_cols`` feature columns."""
        return torch.zeros((self.params.k, num_cols), dtype=torch.float32)

    def fit_stream(self, stream, *, num_epochs: Optional[int] = None,
                   num_shards: int = 1,
                   chunks_per_epoch: Optional[int] = None,
                   checkpoint: Optional[CheckpointPolicy] = None,
                   resume: bool = False,
                   init_centroids: Optional[torch.Tensor] = None
                   ) -> KMeansModel:
        """Streaming Lloyd rounds over minibatch windows: every round
        re-assigns one window chunk of each partition to the current
        centroids (one ``kmeans_assign`` launch for all partitions with
        ``use_kernel``), sums the per-partition (cluster sums, counts)
        statistics and rebuilds the centroids — mini-batch k-means in MLI
        primitives.  ``checkpoint``/``resume`` make long runs
        preemption-safe.

        Centroids start from the first ``k`` rows of the stream's current
        window (peeked without consuming it) unless ``init_centroids`` is
        given; on resume the snapshot overwrites them, so only the shape
        matters.  The centroids live on the stream's device."""
        p = self.params
        device = getattr(stream, "device", None)
        if init_centroids is None:
            if not hasattr(stream, "source"):
                raise ValueError("pass init_centroids= for non-peekable streams")
            first = stream.source(stream.step)["data"]
            if p.k > first.shape[0]:
                raise ValueError("k exceeds rows in the first window")
            init_centroids = first[: p.k]
        if isinstance(init_centroids, torch.Tensor):
            centroids = init_centroids.to(device or init_centroids.device)
        else:
            centroids = to_tensor(init_centroids, resolve_device(device))

        def local_step(blocks, centroids, r):
            return _local_stats(blocks, centroids, p.use_kernel)

        def update(centroids, tot, r):
            return _centroid_update(centroids, tot)

        runner = DistributedRunner(num_shards=num_shards, schedule=p.schedule)
        epochs = num_epochs if num_epochs is not None else p.max_iter
        if resume:
            if checkpoint is None:
                raise ValueError("resume=True requires a CheckpointPolicy")
            centroids = runner.resume(checkpoint.ckpt_dir, stream, centroids,
                                      local_step, epochs, combine="sum",
                                      update=update,
                                      chunks_per_epoch=chunks_per_epoch,
                                      checkpoint=checkpoint)
        else:
            centroids = runner.run_epochs(stream, centroids, local_step, epochs,
                                          combine="sum", update=update,
                                          chunks_per_epoch=chunks_per_epoch or 1,
                                          checkpoint=checkpoint)
        return KMeansModel(centroids, p)
