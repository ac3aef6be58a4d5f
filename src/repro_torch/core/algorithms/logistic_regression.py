"""Logistic regression via partition-local SGD (paper §IV-A, Fig. A4).

Counterpart: ``src/repro/core/algorithms/logistic_regression.py``
(parameters, model, ``_make_gradient``, ``fit``, ``fit_stream`` and
``stream_state_template``; ``trial_spec`` waits for the model-search
slice).

Library convention (as in Fig. A4): the table carries the label in column 0
and the features in columns 1..d.  The paper's gradient closure

    def gradient(vec, w):
        x = vec[1:]
        return x * (sigmoid(x · w) - vec[0])

becomes a chunk gradient here (see :mod:`repro_torch.core.optimizer`): for
a ``(P, m, 1 + d)`` stack of row chunks, each partition's sum of row
gradients.  With ``use_kernel`` that is one launch each of the
``logreg_margin`` and ``logreg_xt_z`` CUDA kernels for the whole stack,
where the reference calls its Pallas kernel once per row on a (1, d) block
under ``vmap``; the mean the SGD step takes is the same.  Like the
reference, the kernel path drops ``l2`` (``l1`` still applies, as a prox).
``fit_stream`` trains the same SGD from a stream of windows; its chunks
are views of the window with a partition stride, which the kernels take
as they are.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.interfaces import Model, NumericAlgorithm, StreamFitable
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.optimizer import (
    GradientDescent,
    GradientDescentParameters,
    StochasticGradientDescent,
    StochasticGradientDescentParameters,
    soft_threshold,
)
from repro_torch.kernels import logreg_grad as klg

__all__ = [
    "LogisticRegressionParameters",
    "LogisticRegressionModel",
    "LogisticRegressionAlgorithm",
    "LogisticRegression",
]


@dataclasses.dataclass
class LogisticRegressionParameters:
    learning_rate: float = 0.5
    max_iter: int = 10
    l2: float = 0.0
    l1: float = 0.0
    local_batch_size: int = 1
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.GATHER_BROADCAST
    solver: str = "sgd"  # "sgd" (paper) | "gd" (MATLAB reference)
    lr_decay: float = 1.0
    use_kernel: bool = False  # route the gradient through the CUDA kernels


class LogisticRegressionModel(Model):
    def __init__(self, params: LogisticRegressionParameters,
                 weights: torch.Tensor):
        self.params = params
        self.weights = weights

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        """σ(x·w) for rows ``x`` (n, d) or one row (d,).  With
        ``use_kernel`` the product goes through the ``logreg_margin`` kernel
        with zero labels (σ(xw) − 0); the reference computes it as a plain
        product, and the two agree to fp32 rounding."""
        if self.params.use_kernel:
            rows = x if x.ndim == 2 else x.unsqueeze(0)
            zeros = torch.zeros(rows.shape[0], dtype=torch.float32,
                                device=rows.device)
            proba = klg.logreg_margin(rows, zeros, self.weights)
            return proba if x.ndim == 2 else proba[0]
        return torch.sigmoid(x @ self.weights)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return (self.predict_proba(x) > 0.5).to(torch.float32)

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Mean negative log likelihood."""
        logits = x @ self.weights
        return torch.mean(torch.logaddexp(torch.zeros_like(logits), logits)
                          - y * logits)

    @property
    def partial(self):
        return {"weights": self.weights}


def _make_gradient(p: LogisticRegressionParameters):
    """The chunk gradient ``grad(chunks (P, m, 1 + d), w) -> (P, d)``: the
    paper's closure summed over each partition's rows — through the CUDA
    kernels with ``use_kernel``, else through their plain versions."""
    if p.use_kernel:
        def gradient(chunks: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            # the reference's kernel path drops l2 (kept as is; ROADMAP faults)
            return klg.logreg_grad(chunks[..., 1:], chunks[..., 0], w)
    else:
        def gradient(chunks: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
            g = klg.logreg_grad_plain(chunks[..., 1:], chunks[..., 0], w)
            if p.l2:
                g = g + (chunks.shape[-2] * p.l2) * w
            return g

    return gradient


class LogisticRegressionAlgorithm(
    NumericAlgorithm[LogisticRegressionParameters, LogisticRegressionModel],
    StreamFitable,
):
    """Instance-based Estimator: ``LogisticRegression(learning_rate=0.3)
    .fit(table) -> LogisticRegressionModel``.  The model's weights are fp32
    on the table's device."""

    Parameters = LogisticRegressionParameters
    supervised = True

    def fit(self, data: MLNumericTable) -> LogisticRegressionModel:
        p = self.params
        d = data.num_cols - 1
        gradient = _make_gradient(p)
        prox = soft_threshold(p.l1) if p.l1 else None
        w0 = torch.zeros((d,), dtype=torch.float32, device=data.device)

        if p.solver == "gd":
            opt = GradientDescent(GradientDescentParameters(
                w_init=w0, grad=gradient, learning_rate=p.learning_rate,
                max_iter=p.max_iter, schedule=p.schedule, prox=prox))
        else:
            opt = StochasticGradientDescent(StochasticGradientDescentParameters(
                w_init=w0, grad=gradient, learning_rate=p.learning_rate,
                max_iter=p.max_iter, schedule=p.schedule,
                local_batch_size=p.local_batch_size, prox=prox,
                lr_decay=p.lr_decay))
        weights = opt.apply(data, None)
        return LogisticRegressionModel(p, weights)

    def rebuild(self, partial) -> LogisticRegressionModel:
        return LogisticRegressionModel(self.params, partial["weights"])

    def stream_state_template(self, num_cols: int) -> torch.Tensor:
        """Shape and dtype template of the streaming carry for a table of
        ``num_cols`` columns (label included) — what a checkpointed
        pipeline restores into (on the CPU: only its structure is read)."""
        return torch.zeros((num_cols - 1,), dtype=torch.float32)

    def fit_stream(self, stream, *, num_epochs: Optional[int] = None,
                   num_features: Optional[int] = None, num_shards: int = 1,
                   chunks_per_epoch: Optional[int] = None,
                   checkpoint=None, resume: bool = False
                   ) -> LogisticRegressionModel:
        """Streaming training over a :class:`repro_torch.data.pipeline.
        BatchIterator` whose windows follow the library convention (label
        in column 0): one window per epoch, ``chunks_per_epoch`` SGD rounds
        per window, optional checkpoint and resume (see
        :meth:`repro_torch.core.runner.DistributedRunner.run_epochs`).

        ``num_features`` may be omitted when the stream has a peekable
        ``source``: it is read off ``stream.source(stream.step)`` without
        consuming the window.  Only the ``"sgd"`` solver streams — full-
        batch GD needs the whole table resident.  The weights live on the
        stream's device."""
        p = self.params
        if p.solver != "sgd":
            raise ValueError(
                f"streaming supports solver='sgd' only, got {p.solver!r} "
                f"(full-batch GD is a resident-table method)")
        if num_features is None:
            if not hasattr(stream, "source"):
                raise ValueError("pass num_features= for non-peekable streams")
            num_features = stream.source(stream.step)["data"].shape[1] - 1
        prox = soft_threshold(p.l1) if p.l1 else None
        w0 = torch.zeros((num_features,), dtype=torch.float32,
                         device=getattr(stream, "device", None))
        opt = StochasticGradientDescent(StochasticGradientDescentParameters(
            w_init=w0, grad=_make_gradient(p), learning_rate=p.learning_rate,
            max_iter=p.max_iter, schedule=p.schedule,
            local_batch_size=p.local_batch_size, prox=prox,
            lr_decay=p.lr_decay))
        weights = opt.apply_stream(
            stream, num_epochs if num_epochs is not None else p.max_iter,
            num_shards=num_shards, chunks_per_epoch=chunks_per_epoch,
            checkpoint=checkpoint, resume=resume)
        return LogisticRegressionModel(p, weights)


#: estimator-style name for the paper's Fig. A2 terminal stage
LogisticRegression = LogisticRegressionAlgorithm
