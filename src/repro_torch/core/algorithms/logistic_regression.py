"""Logistic regression via partition-local SGD (paper §IV-A, Fig. A4).

Counterpart: ``src/repro/core/algorithms/logistic_regression.py``
(parameters, model, ``_make_gradient``, ``fit``, ``fit_stream``,
``stream_state_template``, and the trial form: ``_hyper_gradient``,
``_trial_round``, ``_scorer``, ``trial_spec``).

Library convention (as in Fig. A4): the table carries the label in column 0
and the features in columns 1..d.  The paper's gradient closure

    def gradient(vec, w):
        x = vec[1:]
        return x * (sigmoid(x · w) - vec[0])

becomes a chunk gradient here (see :mod:`repro_torch.core.optimizer`): for
a ``(P, m, 1 + d)`` stack of row chunks, each partition's sum of row
gradients.  With ``use_kernel`` that is one launch of the ``logreg_grad``
CUDA kernel for the whole stack (X read once), where the reference calls
its Pallas kernels once per row on a (1, d) block under ``vmap``; the mean
the SGD step takes is the same.  Like the
reference, the kernel path drops ``l2`` (``l1`` still applies, as a prox).
``fit_stream`` trains the same SGD from a stream of windows; its chunks
are views of the window with a partition stride, which the kernels take
as they are.

The trial form (model search) adds L2 as ``m·l2·W`` per lane to the chunk
sum — the step the GLMs take (`linear_models.py`) — and, like the reference,
refuses ``use_kernel``.  Its scorer predicts each lane with its own
``X @ w``, so a lane's score never depends on the stack.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.interfaces import (
    Model,
    NumericAlgorithm,
    Searchable,
    StreamFitable,
)
from repro_torch.core.numeric_table import MLNumericTable
from repro_torch.core.optimizer import (
    GradientDescent,
    GradientDescentParameters,
    StochasticGradientDescent,
    StochasticGradientDescentParameters,
    sgd_trial_round,
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
        with no labels (σ(xw): one launch, no fill of zero labels beside
        it); the reference computes it as a plain product, and the two agree
        to fp32 rounding."""
        if self.params.use_kernel:
            rows = x if x.ndim == 2 else x.unsqueeze(0)
            proba = klg.logreg_margin(rows, None, self.weights)
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


# --------------------------------------------------------------------------- #
# trial form (model search; repro_torch.tune)
# --------------------------------------------------------------------------- #
def _hyper_gradient(chunks: torch.Tensor, W: torch.Tensor, hyper: dict
                    ) -> torch.Tensor:
    """The chunk gradient with L2 as a hyperparameter: each partition's sum
    of the paper's row gradients plus ``m·l2·W`` (``l2 = 0`` adds zeros,
    so regularized and unregularized configs share one stack)."""
    g = klg.logreg_grad_plain(chunks[..., 1:], chunks[..., 0], W)
    return g + (chunks.shape[-2] * hyper["l2"]) * W


# one local round per local_batch_size: every trial of a stack group (and
# every fold and rung segment) shares the same function object
_TRIAL_ROUNDS: dict = {}


def _trial_round(local_batch_size: int):
    if local_batch_size not in _TRIAL_ROUNDS:
        _TRIAL_ROUNDS[local_batch_size] = sgd_trial_round(
            _hyper_gradient, local_batch_size)
    return _TRIAL_ROUNDS[local_batch_size]


_SCORERS: dict = {}


def _scorer(metric: str):
    """``(val_table, stacked W (K, d), schedule) -> (K,)`` higher-is-better
    scores (:mod:`repro_torch.eval.metrics`), lane by lane."""
    if metric in _SCORERS:
        return _SCORERS[metric]
    from repro_torch.eval import metrics as M

    if metric == "accuracy":
        def one(val_table, w, schedule):
            return M.accuracy(
                val_table,
                lambda X: (torch.sigmoid(X @ w) > 0.5).to(torch.float32),
                schedule=schedule)
    elif metric == "log_loss":
        def one(val_table, w, schedule):
            return -M.log_loss(val_table, lambda X: torch.sigmoid(X @ w),
                               schedule=schedule)
    else:
        raise ValueError(
            f"unknown logreg metric {metric!r} (accuracy | log_loss)")

    def score(val_table, W, schedule):
        return torch.stack([one(val_table, w, schedule) for w in W])

    _SCORERS[metric] = score
    return score


class LogisticRegressionAlgorithm(
    NumericAlgorithm[LogisticRegressionParameters, LogisticRegressionModel],
    StreamFitable, Searchable,
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

    @classmethod
    def trial_spec(cls, config: dict, metric: str = "accuracy"):
        """One model-search trial (:mod:`repro_torch.tune`): ``config``
        overrides :class:`LogisticRegressionParameters` fields;
        ``learning_rate``, ``lr_decay``, ``l1`` and ``l2`` ride in the
        trial's hyper tree (0-d fp32 CPU tensors), so configs differing
        only there stack; ``local_batch_size`` changes the fold and rides
        in the stack key.  Only the paper's ``"sgd"`` solver is searchable,
        and not the kernel path (its L2 is dropped, as in the reference)."""
        from repro_torch.tune.trials import TrialSpec

        p = dataclasses.replace(cls.default_parameters(), **config)
        if p.solver != "sgd":
            raise ValueError(
                f"model search supports solver='sgd' only, got {p.solver!r}")
        if p.use_kernel:
            raise ValueError("model search does not stack the kernel "
                             "gradient (its L2 term is not a hyperparameter)")
        hyper = {name: torch.tensor(float(v), dtype=torch.float32)
                 for name, v in (("lr", p.learning_rate), ("decay", p.lr_decay),
                                 ("l1", p.l1), ("l2", p.l2))}

        def init(table) -> torch.Tensor:
            return torch.zeros((table.num_cols - 1,), dtype=torch.float32,
                               device=table.device)

        return TrialSpec(
            config=dict(config), hyper=hyper, init=init,
            local_step=_trial_round(p.local_batch_size), combine="mean",
            stack_key=("logreg", "sgd", int(p.local_batch_size)),
            score=_scorer(metric),
            finalize=lambda w: LogisticRegressionModel(p, w))

    def fit_stream(self, stream, *, num_epochs: Optional[int] = None,
                   num_features: Optional[int] = None, num_shards: int = 1,
                   chunks_per_epoch: Optional[int] = None,
                   checkpoint=None, resume: bool = False, store=None,
                   staleness: int = 0, allow_resize: bool = False,
                   trace: Optional[list] = None
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
        stream's device; on a stream with a mesh every host holds them.

        ``store`` (a :class:`repro_torch.core.exchange.ParamStore`) selects
        the stale-synchronous multi-host lane: this host trains on its own
        windows each epoch and averages weights with its peers under the
        ``staleness`` bound.  ``allow_resize=True`` lets a resumed run
        continue on a mesh of another world size (elastic restart)."""
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
            checkpoint=checkpoint, resume=resume, store=store,
            staleness=staleness, allow_resize=allow_resize, trace=trace)
        return LogisticRegressionModel(p, weights)


#: estimator-style name for the paper's Fig. A2 terminal stage
LogisticRegression = LogisticRegressionAlgorithm
