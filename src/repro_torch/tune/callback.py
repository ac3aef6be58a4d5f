"""LightGBM-style callback protocol for training and search loops.

Counterpart: ``src/repro/tune/callback.py`` (``CallbackEnv``,
``EvalEntry``, ``EarlyStopException``, ``split_callbacks``,
``fire_callbacks``, ``early_stopping``, ``record_evaluation``,
``hyper_schedule``), the same protocol and firing order.

The training loops (:meth:`repro_torch.core.runner.DistributedRunner.
run_epochs` and ``run_stacked_epochs``) and the search driver
(:class:`repro_torch.tune.search.ModelSearch`) call every registered
callback between epochs with a frozen :class:`CallbackEnv` snapshot.  A
callback may

  * **observe** — metric streaming, progress lines
    (:func:`record_evaluation` appends per-rung snapshots to a
    :class:`repro_torch.eval.metrics.MetricHistory`);
  * **stop** — raise :class:`EarlyStopException` to end the loop early
    (:func:`early_stopping`); the loop still writes its tail checkpoint;
  * **steer** — return a ``{"state": ...}`` / ``{"hyper": ...}`` dict to
    swap that carry component before the next epoch
    (:func:`hyper_schedule` reschedules a hyperparameter; its swap is a
    tensor on the hyper tree's device).

A callback is any callable ``cb(env) -> None | dict``; ``cb.order`` (int,
default 10) sorts callbacks ascending, ``cb.before_epoch`` (default False)
fires it before the epoch instead of after.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "CallbackEnv",
    "EvalEntry",
    "EarlyStopException",
    "early_stopping",
    "record_evaluation",
    "hyper_schedule",
    "split_callbacks",
    "fire_callbacks",
]


class EvalEntry(NamedTuple):
    """One evaluation result: ``(trial, metric, value, higher_better)``.

    ``trial`` is the trial's search-wide index (0 for plain single-model
    training loops); scores follow the tune convention — ``higher_better``
    says which direction improves, the stored value is untransformed.
    """

    trial: int
    metric: str
    value: float
    higher_better: bool = True


@dataclasses.dataclass(frozen=True)
class CallbackEnv:
    """Frozen snapshot handed to every callback at a hook point.

    Fields
    ------
    epoch:
        Epochs completed so far (after-epoch hooks) or the epoch about to
        run (before-epoch hooks).
    begin_epoch / end_epoch:
        The segment bounds of the surrounding loop call — rung-segmented
        searches fire hooks with the rung's bounds.
    round:
        Global round index at this boundary (``epoch * chunks_per_epoch``).
    state:
        The model-state handle: the raw carry pytree for plain loops, the
        stacked (K, …) trial tree for stacked loops.  A handle, not a
        copy — read freely, mutate never; return ``{"state": new}`` to
        swap it.
    hyper:
        The (K,)-stacked hyperparameter tree (stacked loops) or
        ``None``; return ``{"hyper": new}`` to swap it.
    active:
        Host copy of the (K,) bool active mask, or ``None``.
    unit / trial_ids:
        Search context: the execution-unit ordinal and the search-wide
        trial indices in lane order (``(0,)`` for plain loops).
    evals:
        Tuple of :class:`EvalEntry` for this boundary — empty unless the
        loop was given an ``eval_fn`` (or the search computed rung
        scores).
    """

    epoch: int
    begin_epoch: int = 0
    end_epoch: int = 0
    round: int = 0
    state: Any = None
    hyper: Any = None
    active: Any = None
    unit: int = 0
    trial_ids: Tuple[int, ...] = (0,)
    evals: Tuple[EvalEntry, ...] = ()


class EarlyStopException(Exception):
    """Raised by a callback to stop the surrounding loop.

    Carries the epoch the stop was decided at and a human-readable
    reason; the loop checkpoints its tail state before returning, so an
    early-stopped run is resumable/inspectable like a completed one.
    """

    def __init__(self, epoch: int, reason: str = "early stop"):
        self.epoch = int(epoch)
        self.reason = reason
        super().__init__(f"{reason} (epoch {epoch})")


def split_callbacks(callbacks: Sequence[Callable]
                    ) -> Tuple[Tuple[Callable, ...], Tuple[Callable, ...]]:
    """Partition callbacks into (before-epoch, after-epoch) groups, each
    sorted by ``order`` (stable, so equal orders keep registration
    order)."""
    before = [cb for cb in callbacks if getattr(cb, "before_epoch", False)]
    after = [cb for cb in callbacks if not getattr(cb, "before_epoch", False)]
    key = lambda cb: getattr(cb, "order", 10)  # noqa: E731
    return tuple(sorted(before, key=key)), tuple(sorted(after, key=key))


def fire_callbacks(callbacks: Sequence[Callable], env: CallbackEnv) -> dict:
    """Run one hook point: call each callback with ``env``, folding any
    returned carry swaps (``{"state": ...}`` / ``{"hyper": ...}``) into
    the env later callbacks in the same hook see.  Returns the merged
    swap dict (empty when no callback steered).  An
    :class:`EarlyStopException` propagates to the loop."""
    swaps: dict = {}
    for cb in callbacks:
        out = cb(env)
        if not out:
            continue
        unknown = set(out) - {"state", "hyper", "active"}
        if unknown:
            raise ValueError(
                f"callback {cb!r} returned unknown carry keys {unknown} — "
                f"only 'state', 'hyper', 'active' can be swapped")
        swaps.update(out)
        env = dataclasses.replace(env, **{k: v for k, v in out.items()
                                          if k in ("state", "hyper", "active")})
    return swaps


# --------------------------------------------------------------------------- #
# built-in callbacks
# --------------------------------------------------------------------------- #
def early_stopping(stopping_rounds: int, min_delta: float = 0.0,
                   verbose: bool = False) -> Callable:
    """Stop when no tracked trial improves for ``stopping_rounds``
    consecutive evaluated hook points.

    Tracks the best value of every ``(trial, metric)`` pair seen in
    ``env.evals`` (direction per entry's ``higher_better``).  A hook
    point with at least one improvement of more than ``min_delta``
    resets the stall counter; ``stopping_rounds`` stalled hook points in
    a row raise :class:`EarlyStopException`.  Hook points with no evals
    are ignored (they carry no evidence either way).

    The callback exposes its running state as ``cb.best`` (``{(trial,
    metric): value}``) and is idempotent under replay: re-feeding the
    evaluations a resumed run already saw reproduces the same counter.
    """
    if stopping_rounds < 1:
        raise ValueError(f"stopping_rounds must be >= 1, got {stopping_rounds}")
    best: dict = {}
    stall = {"count": 0}

    def cb(env: CallbackEnv) -> None:
        if not env.evals:
            return
        improved = False
        for e in env.evals:
            key = (e.trial, e.metric)
            prev = best.get(key)
            if prev is None:
                best[key] = e.value
                improved = True  # a fresh baseline is never a stall
                continue
            gain = e.value - prev if e.higher_better else prev - e.value
            if gain > 0:
                best[key] = e.value
                if gain > min_delta:
                    improved = True
        stall["count"] = 0 if improved else stall["count"] + 1
        if verbose:
            print(f"early_stopping: epoch {env.epoch} "
                  f"stall {stall['count']}/{stopping_rounds}")
        if stall["count"] >= stopping_rounds:
            raise EarlyStopException(
                env.epoch, f"no improvement > {min_delta} for "
                           f"{stopping_rounds} evaluations")

    cb.order = 30          # after observers: they must see the final env
    cb.before_epoch = False
    cb.best = best
    return cb


def record_evaluation(history: Any) -> Callable:
    """Append every :class:`EvalEntry` to ``history`` (anything with a
    ``record(trial, metric, epoch, value)`` method — canonically a
    :class:`repro_torch.eval.metrics.MetricHistory`).

    Recording is keyed by ``(trial, metric, epoch)`` and overwrites, so
    replaying a boundary a resumed search already recorded is idempotent
    — the history of a killed-and-resumed run equals the uninterrupted
    one.  ``cb.history`` exposes the target for later inspection.
    """
    if not hasattr(history, "record"):
        raise TypeError(
            f"record_evaluation needs an object with .record(trial, metric, "
            f"epoch, value) — got {type(history).__name__}; use "
            f"repro_torch.eval.metrics.MetricHistory")

    def cb(env: CallbackEnv) -> None:
        for e in env.evals:
            history.record(e.trial, e.metric, env.epoch, e.value)

    cb.order = 20          # observers fire before controllers
    cb.before_epoch = False
    cb.history = history
    return cb


def hyper_schedule(param: str, fn: Callable[[int], float]) -> Callable:
    """Reschedule one hyperparameter before every epoch.

    ``fn(epoch) -> value`` computes the upcoming epoch's value for
    ``hyper[param]`` (a learning-rate schedule being the canonical use);
    the returned ``{"hyper": ...}`` swap is a ``torch.full_like`` of the
    old leaf, on its device, which the next epoch reads.  In stacked
    loops the value broadcasts over all K lanes.  Loops
    without a hyper tree (plain ``run_epochs``) are left untouched.
    """
    import torch

    def cb(env: CallbackEnv) -> Optional[dict]:
        if env.hyper is None:
            return None
        if not isinstance(env.hyper, dict) or param not in env.hyper:
            raise KeyError(
                f"hyper_schedule: no hyperparameter {param!r} in the hyper "
                f"tree (have {sorted(env.hyper) if isinstance(env.hyper, dict) else type(env.hyper).__name__})")
        old = torch.as_tensor(env.hyper[param])
        new = dict(env.hyper)
        new[param] = torch.full_like(old, fn(env.epoch))
        return {"hyper": new}

    cb.order = 0           # schedules run first: the epoch uses their value
    cb.before_epoch = True
    return cb
