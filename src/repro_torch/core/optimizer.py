"""Optimizers as first-class citizens (paper §III-C, reference impl Fig. A4).

Counterpart: ``src/repro/core/optimizer.py`` (``soft_threshold``,
``StochasticGradientDescent`` with ``_local_round`` and ``apply_stream``,
``GradientDescent``, ``MinibatchSGD``, ``_stream_fit`` and
``sgd_trial_round``).

  * ``StochasticGradientDescent`` — Fig. A4: partition-local SGD over the
    rows in sub-batches of ``local_batch_size``, then averaging;
  * ``GradientDescent`` — the MATLAB reference: full-batch gradient, global
    sum, one update per round;
  * ``MinibatchSGD`` — one minibatch per partition a round (the paper's
    "matrix/vector multiplication in the case of mini-batch SGD").

All iterate through :class:`repro_torch.core.runner.DistributedRunner`;
SGD and minibatch SGD also train from a stream of per-epoch windows
(``apply_stream``, through ``run_epochs`` / ``resume``).

The gradient contract differs from the reference in one way: the
reference's ``grad(row, w)`` is one row's gradient, ``vmap``ped over rows
and partitions.  Here ``grad(chunk, w)`` takes a ``(P, m, cols)`` stack of
row chunks and returns ``(P, d)``: for every partition the *sum* of its
rows' gradients.  ``w`` is ``(d,)`` when all partitions share it (GD) or
``(P, d)`` when each partition holds a private copy (SGD).  The SGD and
minibatch steps divide by ``m`` (the rows of the minibatch) — the
reference's mean — and GD uses the sum directly.  The streaming paths take
the reference's ``store`` and ``staleness`` (the stale-synchronous lane),
``allow_resize`` (an elastic resume) and ``trace``, and run on the
stream's mesh when it has one (``BatchIterator(mesh=)``).
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.runner import CheckpointPolicy, DistributedRunner

__all__ = [
    "Optimizer",
    "StochasticGradientDescentParameters",
    "StochasticGradientDescent",
    "GradientDescentParameters",
    "GradientDescent",
    "MinibatchSGDParameters",
    "MinibatchSGD",
    "soft_threshold",
    "sgd_trial_round",
]

# grad_fn(chunks (P, m, cols), w (d,) | (P, d)) -> (P, d) per-partition sum
GradFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
# prox_fn(weights, step) -> weights  (proximal operator, e.g. L1 soft-threshold)
ProxFn = Callable[[torch.Tensor, float], torch.Tensor]
# hyper_grad(chunks (P, m, cols), W (P, d), hyper) -> (P, d) per-partition sum
HyperGradFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]


def soft_threshold(lam: float) -> ProxFn:
    """Proximal operator of ``lam * ||w||_1`` (paper §IV: 'adding a proximal
    operator in the case of L1-regularization')."""

    def prox(w: torch.Tensor, step: float) -> torch.Tensor:
        t = lam * step
        return torch.sign(w) * torch.clamp(torch.abs(w) - t, min=0.0)

    return prox


class Optimizer(abc.ABC):
    """MLOpt: optimize parameters against an MLNumericTable."""

    @abc.abstractmethod
    def apply(self, data: MLNumericTable, params) -> torch.Tensor:
        ...

    def __call__(self, data: MLNumericTable, params) -> torch.Tensor:
        return self.apply(data, params)


def _stream_fit(stream, w_init: torch.Tensor, num_epochs: int, local_round,
                schedule: Union[str, CollectiveSchedule], *,
                num_shards: int = 1,
                chunks_per_epoch: Optional[int] = None,
                checkpoint: Optional[CheckpointPolicy] = None,
                resume: bool = False, store=None, staleness: int = 0,
                allow_resize: bool = False,
                trace: Optional[list] = None) -> torch.Tensor:
    """Streaming counterpart of ``apply``: one window per epoch from
    ``stream`` (a :class:`repro_torch.data.pipeline.BatchIterator`, on its
    mesh when it has one), iterated by :meth:`DistributedRunner.run_epochs`
    with mean-combined weights.  With ``resume=True`` the run restarts from
    ``checkpoint.ckpt_dir``; ``chunks_per_epoch=None`` then inherits the
    checkpointed layout, while an explicit value is cross-checked against
    it (a mismatch raises).

    ``store`` (a :class:`repro_torch.core.exchange.ParamStore`) switches to
    the stale-synchronous lane: independent hosts exchanging post-epoch
    weights under the ``staleness`` bound
    (:meth:`DistributedRunner.run_epochs_ssp`).  ``allow_resize`` lets a
    resume repartition onto another world size (the elastic path)."""
    runner = DistributedRunner(num_shards=num_shards, schedule=schedule,
                               mesh=getattr(stream, "mesh", None))
    if store is not None:
        if resume:
            if checkpoint is None:
                raise ValueError("resume=True requires a CheckpointPolicy")
            return runner.resume_ssp(checkpoint.ckpt_dir, stream, w_init,
                                     local_round, num_epochs, store=store,
                                     staleness=staleness, combine="mean",
                                     checkpoint=checkpoint, trace=trace)
        return runner.run_epochs_ssp(stream, w_init, local_round, num_epochs,
                                     store=store, staleness=staleness,
                                     combine="mean",
                                     chunks_per_epoch=chunks_per_epoch or 1,
                                     checkpoint=checkpoint, trace=trace)
    if resume:
        if checkpoint is None:
            raise ValueError("resume=True requires a CheckpointPolicy")
        return runner.resume(checkpoint.ckpt_dir, stream, w_init, local_round,
                             num_epochs, combine="mean",
                             chunks_per_epoch=chunks_per_epoch,
                             checkpoint=checkpoint, allow_resize=allow_resize)
    return runner.run_epochs(stream, w_init, local_round, num_epochs,
                             combine="mean",
                             chunks_per_epoch=chunks_per_epoch or 1,
                             checkpoint=checkpoint)


# --------------------------------------------------------------------------- #
# trial-stackable SGD round (model search; repro_torch.tune)
# --------------------------------------------------------------------------- #
def sgd_trial_round(grad: HyperGradFn, local_batch_size: int = 1):
    """Trial form of the Fig. A4 partition-local SGD pass: the fold over
    rows of :meth:`StochasticGradientDescent._local_round`, with every
    hyperparameter read from the trial's ``hyper`` tree of 0-d tensors:

      * ``hyper["lr"]`` / ``hyper["decay"]`` — the round's step
        ``lr * decay**r`` (r the trial-local round);
      * ``hyper["l1"]`` — the L1 soft threshold after every step; at
        ``l1 = 0`` it is the exact identity (sign(w)·max(|w| − 0, 0) = w
        bit for bit), so unregularized configs stack with regularized ones;
      * anything ``grad(chunks, W, hyper)`` reads (e.g. ``hyper["l2"]``).

    ``grad`` keeps the port's chunk-sum contract (module docstring).
    Returns ``local_round(blocks (P, rows, cols), w (d,), r, hyper) ->
    (P, d)``, one trial's round; the stacked runner calls it lane by lane.
    """
    bs = int(local_batch_size)

    def local_round(blocks: torch.Tensor, w: torch.Tensor, r: int,
                    hyper: dict) -> torch.Tensor:
        num_parts, rows = blocks.shape[0], blocks.shape[1]
        if rows % bs != 0:
            raise ValueError(
                f"rows-per-shard {rows} must be divisible by "
                f"local_batch_size {bs}")
        lr = hyper["lr"] * hyper["decay"] ** r
        t = hyper["l1"] * lr
        W = w.expand(num_parts, -1).clone()
        for start in range(0, rows, bs):
            g = grad(blocks[:, start:start + bs], W, hyper) / bs
            W = W - lr * g
            W = torch.sign(W) * torch.clamp(torch.abs(W) - t, min=0.0)
        return W

    return local_round


# --------------------------------------------------------------------------- #
# StochasticGradientDescent (paper Fig. A4)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class StochasticGradientDescentParameters:
    w_init: torch.Tensor
    grad: GradFn
    learning_rate: float = 0.1
    max_iter: int = 10
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.GATHER_BROADCAST
    local_batch_size: int = 1      # 1 == per-point SGD, exactly the paper
    prox: Optional[ProxFn] = None
    lr_decay: float = 1.0          # multiplicative per-round decay


class StochasticGradientDescent(Optimizer):
    """Partition-local SGD + global parameter averaging (paper Fig. A4).

    Each round, every partition folds over its rows in order (in chunks of
    ``local_batch_size``) updating a private copy of the weights; the
    copies are then averaged.  All partitions step together: chunk ``i`` of
    every partition is one ``(P, local_batch_size, cols)`` slice.
    """

    def __init__(self, params: StochasticGradientDescentParameters):
        self.params = params

    @staticmethod
    def _local_round(p: StochasticGradientDescentParameters):
        """Build the partition-local pass (Fig. A4 ``localSGD``):
        ``local_sgd(blocks (P, rows, cols), w (d,), r) -> (P, d)``, with
        ``lr = learning_rate * lr_decay**r`` and the prox after each step."""
        bs = int(p.local_batch_size)

        def local_sgd(blocks: torch.Tensor, w: torch.Tensor, r: int
                      ) -> torch.Tensor:
            num_parts, rows = blocks.shape[0], blocks.shape[1]
            if rows % bs != 0:
                raise ValueError(
                    f"rows-per-shard {rows} must be divisible by local_batch_size {bs}"
                )
            lr = p.learning_rate * (p.lr_decay ** r)
            W = w.expand(num_parts, -1).clone()
            for start in range(0, rows, bs):
                g = p.grad(blocks[:, start:start + bs], W) / bs
                W = W - lr * g
                if p.prox is not None:
                    W = p.prox(W, lr)
            return W

        return local_sgd

    def apply(self, data: MLNumericTable, params=None) -> torch.Tensor:
        p = params or self.params
        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        return runner.run_rounds(data, p.w_init, self._local_round(p),
                                 p.max_iter, combine="mean")

    def apply_stream(self, stream, num_epochs: int, *, num_shards: int = 1,
                     chunks_per_epoch: Optional[int] = None,
                     checkpoint: Optional[CheckpointPolicy] = None,
                     resume: bool = False, params=None, store=None,
                     staleness: int = 0, allow_resize: bool = False,
                     trace: Optional[list] = None) -> torch.Tensor:
        """Streaming fit: each epoch's window is split into
        ``chunks_per_epoch`` rounds; every round each partition folds over
        its chunk's rows exactly as the resident path folds over its
        partition, then the weights are mean-combined.  ``lr_decay`` reads
        the global round index.  ``checkpoint``/``resume`` make the run
        preemption-safe (see :class:`repro_torch.core.runner.
        CheckpointPolicy`).  ``store`` + ``staleness`` select the
        stale-synchronous lane; ``allow_resize`` permits an elastic resume
        on a resized mesh."""
        p = params or self.params
        return _stream_fit(stream, p.w_init, num_epochs, self._local_round(p),
                           p.schedule, num_shards=num_shards,
                           chunks_per_epoch=chunks_per_epoch,
                           checkpoint=checkpoint, resume=resume, store=store,
                           staleness=staleness, allow_resize=allow_resize,
                           trace=trace)


# --------------------------------------------------------------------------- #
# GradientDescent (the MATLAB reference, vectorized full-batch)
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class GradientDescentParameters:
    w_init: torch.Tensor
    grad: GradFn
    learning_rate: float = 0.1
    max_iter: int = 10
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
    prox: Optional[ProxFn] = None


class GradientDescent(Optimizer):
    """Full-batch GD: each partition computes the sum of its rows'
    gradients; partitions combine with a global sum; one update per round."""

    def __init__(self, params: GradientDescentParameters):
        self.params = params

    def apply(self, data: MLNumericTable, params=None) -> torch.Tensor:
        p = params or self.params

        # The weight update needs the *summed* gradient, so the per-round
        # combine is a global sum and the update happens after the combine.
        def local_grad(blocks: torch.Tensor, w: torch.Tensor, r: int
                       ) -> torch.Tensor:
            return p.grad(blocks, w)

        def update(w: torch.Tensor, g: torch.Tensor, r: int) -> torch.Tensor:
            w = w - p.learning_rate * g
            if p.prox is not None:
                w = p.prox(w, p.learning_rate)
            return w

        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        return runner.run_rounds(data, p.w_init, local_grad, p.max_iter,
                                 combine="sum", update=update)


# --------------------------------------------------------------------------- #
# MinibatchSGD
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class MinibatchSGDParameters:
    w_init: torch.Tensor
    grad: GradFn
    learning_rate: float = 0.1
    max_iter: int = 100
    batch_per_shard: int = 32
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
    prox: Optional[ProxFn] = None


def _minibatch_step(p: MinibatchSGDParameters, mb: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """One step per partition on a ``(P, m, cols)`` minibatch stack: the
    chunk gradient's sum over ``m`` rows, divided by ``m`` (the reference's
    mean), a step of ``learning_rate`` and the prox → ``(P, d)``."""
    g = p.grad(mb, w) / mb.shape[1]
    W = w - p.learning_rate * g
    if p.prox is not None:
        W = p.prox(W, p.learning_rate)
    return W


class MinibatchSGD(Optimizer):
    """Each round every partition takes one contiguous rotating minibatch,
    computes its mean gradient, steps; the partitions' weights average."""

    def __init__(self, params: MinibatchSGDParameters):
        self.params = params

    def apply(self, data: MLNumericTable, params=None) -> torch.Tensor:
        p = params or self.params
        bs = int(p.batch_per_shard)
        rows = data.rows_per_shard
        if rows < bs:
            raise ValueError(f"batch_per_shard {bs} exceeds rows-per-shard {rows}")
        n_batches = rows // bs

        def local_round(blocks: torch.Tensor, w: torch.Tensor, r: int
                        ) -> torch.Tensor:
            start = (r % n_batches) * bs
            return _minibatch_step(p, blocks[:, start:start + bs], w)

        runner = DistributedRunner.for_table(data, schedule=p.schedule)
        return runner.run_rounds(data, p.w_init, local_round, p.max_iter,
                                 combine="mean")

    @staticmethod
    def _streaming_round(p: MinibatchSGDParameters):
        """Streaming local round: the window chunk IS the minibatch (its
        rows are fresh every round), so ``batch_per_shard`` is implied by
        the window size and ``chunks_per_epoch``."""

        def local_round(chunk: torch.Tensor, w: torch.Tensor, r: int
                        ) -> torch.Tensor:
            return _minibatch_step(p, chunk, w)

        return local_round

    def apply_stream(self, stream, num_epochs: int, *, num_shards: int = 1,
                     chunks_per_epoch: Optional[int] = None,
                     checkpoint: Optional[CheckpointPolicy] = None,
                     resume: bool = False, params=None, store=None,
                     staleness: int = 0, allow_resize: bool = False,
                     trace: Optional[list] = None) -> torch.Tensor:
        """Streaming minibatch SGD: each of the window's
        ``chunks_per_epoch`` chunks is one minibatch per partition — mean
        gradient, local step, mean-combined weights.  Preemption-safe
        through ``checkpoint``/``resume``; ``store``, ``staleness``,
        ``allow_resize`` and ``trace`` as :meth:`StochasticGradientDescent.
        apply_stream`."""
        p = params or self.params
        return _stream_fit(stream, p.w_init, num_epochs,
                           self._streaming_round(p), p.schedule,
                           num_shards=num_shards,
                           chunks_per_epoch=chunks_per_epoch,
                           checkpoint=checkpoint, resume=resume, store=store,
                           staleness=staleness, allow_resize=allow_resize,
                           trace=trace)
