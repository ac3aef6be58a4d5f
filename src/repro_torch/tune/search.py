"""Model search: config enumeration, early stopping, and the driver.

Counterpart: ``src/repro/tune/search.py`` (``grid``, ``sample``,
``MedianStoppingRule``, ``AsyncSuccessiveHalving``, ``AshaScheduler``,
``TrialResult``, ``SearchResult``, ``ModelSearch`` with ``run``,
``_prepare``, ``_rungs``, ``_fingerprint``, ``_run_unit``,
``_run_pipeline``, ``_run_asha``, ``_apply_median_rule``, and the helpers
``_builtin_builder``, ``_tree_set``, ``_asha_history``,
``_window_source``).

:func:`grid` and :func:`sample` enumerate candidate configurations (the
numpy code of the reference: the same draws for the same seed).
:class:`ModelSearch` executes them over a row-partitioned table:

  * **folds** — k-fold or holdout splits from :mod:`repro_torch.tune.cv`;
    each fold's train rows are gathered on the table's device ONCE
    (``_prepare``), and every epoch's window is that device tensor,
    trimmed as the reference trims it.  The reference copies the whole
    table to the host and sends each window back through a
    ``BatchIterator``; the port skips the host round trip (same values);
  * **layout** — a mesh table (or a ``Pipeline(mesh=)``) keeps its mesh
    whenever every train view fills a partitions × chunks unit: each host
    holds its rows of every fold view (:func:`repro_torch.tune.cv.
    fold_view`) and the trials' rounds combine across hosts; else every
    view is one partition held whole by every host, as the reference falls
    back to one partition.  Host 0 alone writes the search's snapshots;
  * **execution** — ``"stacked"`` advances every same-shape group of
    trials together (:meth:`repro_torch.core.runner.DistributedRunner.
    run_stacked_epochs`), ``"sequential"`` one trial per unit, ``"auto"``
    stacked where shapes allow.  A lane runs the launches of its trial
    alone, so ``"stacked"`` equals ``"sequential"`` bit for bit — weights,
    scores, and therefore every stopping and promotion decision;
  * **early stopping** — the median rule (:class:`MedianStoppingRule`)
    after each rung, or asynchronous successive halving
    (:class:`AsyncSuccessiveHalving`) with slot backfill through the
    runner's ``round_offsets``;
  * **fault tolerance** — with ``ckpt_dir`` the search snapshots after
    every completed unit (under ASHA: every rung report) in the
    reference's format, and ``run(..., resume=True)`` continues trial for
    trial (rung for rung).

Scores are **higher-is-better** throughout.  The table's device is where
the search runs (the card unless the caller made the table with
``device="cpu"``); a pipeline search over a raw ``MLTable`` runs on the
pipeline's ``device``.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.collectives import CollectiveSchedule
from repro_torch.core.runner import DistributedRunner, _tree_map
from repro_torch.data.pipeline import BatchIterator
from repro_torch.tune.callback import (
    CallbackEnv,
    EarlyStopException,
    EvalEntry,
    fire_callbacks,
    split_callbacks,
)
from repro_torch.tune.cv import KFold, fold_view, holdout_split, take_rows
from repro_torch.tune.trials import (
    SearchCheckpointer,
    TrialSpec,
    fingerprint,
    group_trials,
    tree_stack,
    tree_unstack,
)

__all__ = [
    "grid",
    "sample",
    "MedianStoppingRule",
    "AsyncSuccessiveHalving",
    "AshaScheduler",
    "TrialResult",
    "SearchResult",
    "ModelSearch",
]


# --------------------------------------------------------------------------- #
# config enumeration
# --------------------------------------------------------------------------- #
def _is_range(v: Any) -> bool:
    return (isinstance(v, tuple) and len(v) == 3
            and v[0] in ("uniform", "loguniform"))


def grid(space: Dict[str, Sequence[Any]]) -> List[Dict[str, Any]]:
    """Cartesian product of a ``{param: [values…]}`` space, in sorted-key
    order — a pure function of the space."""
    for k, v in space.items():
        if _is_range(v):
            raise ValueError(
                f"{k}={v!r} is a continuous range — ranges are for "
                f"sample(); a grid needs an explicit value list")
    keys = sorted(space)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(space[k] for k in keys))]


def sample(space: Dict[str, Any], num_samples: int, seed: int = 0
           ) -> List[Dict[str, Any]]:
    """Random search: ``num_samples`` draws from ``space`` with a seeded
    numpy generator.  Per key, a list/tuple of values is sampled
    uniformly; ``("uniform", lo, hi)`` and ``("loguniform", lo, hi)`` draw
    continuous values."""
    rng = np.random.default_rng(seed)
    configs = []
    for _ in range(num_samples):
        cfg: Dict[str, Any] = {}
        for k in sorted(space):
            v = space[k]
            if _is_range(v):
                lo, hi = float(v[1]), float(v[2])
                if lo > hi:
                    raise ValueError(f"{k}: range lower bound {lo} exceeds "
                                     f"upper bound {hi}")
                if v[0] == "loguniform":
                    if lo <= 0:
                        raise ValueError(
                            f"{k}: loguniform bounds must be positive, got "
                            f"[{lo}, {hi}]")
                    cfg[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
                else:
                    cfg[k] = float(rng.uniform(lo, hi))
            else:
                options = list(v)
                choice = options[int(rng.integers(len(options)))]
                cfg[k] = choice.item() if hasattr(choice, "item") else choice
        configs.append(cfg)
    return configs


# --------------------------------------------------------------------------- #
# median early stopping
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class MedianStoppingRule:
    """Stop a trial whose rung score falls below the median of its peers:
    after rung ``r`` (rungs before ``min_rungs`` always survive), a trial
    stops when at least ``min_trials`` other trials have a score at the
    same rung and its score is strictly below their median.  Stopped trials
    keep their last score and their state freezes."""

    min_rungs: int = 1
    min_trials: int = 3

    def stop(self, rung: int, score: float, peer_scores: Sequence[float]) -> bool:
        if rung < self.min_rungs:
            return False
        if len(peer_scores) < self.min_trials:
            return False
        return score < float(np.median(np.asarray(peer_scores, np.float64)))


# --------------------------------------------------------------------------- #
# asynchronous successive halving
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class AsyncSuccessiveHalving:
    """ASHA: per-rung promotion decided the moment a trial reports.

    Rungs sit at trial-local epochs ``min_rounds * reduction_factor^j``,
    capped at the search's epoch budget (always the final rung).  A trial
    reaching a rung is **promoted** when its score is at or above the top
    ``1/reduction_factor`` quantile of everything reported at that rung so
    far, else **stopped**, freeing its slot for the next pending trial.

    ``slots`` is the concurrent trial count (stacked lane width; default up
    to 8); ``epoch_budget`` the total slot-epochs (admission stops once
    spent; ``None`` runs the whole pool)."""

    reduction_factor: int = 3
    min_rounds: int = 1
    slots: Optional[int] = None
    epoch_budget: Optional[int] = None

    def __post_init__(self) -> None:
        if self.reduction_factor < 2:
            raise ValueError(
                f"reduction_factor must be >= 2, got {self.reduction_factor}")
        if self.min_rounds < 1:
            raise ValueError(f"min_rounds must be >= 1, got {self.min_rounds}")
        if self.slots is not None and self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")

    def rung_epochs(self, num_epochs: int) -> List[int]:
        """Trial-local epoch of each rung, ascending; the last is always
        ``num_epochs``."""
        out: List[int] = []
        e = self.min_rounds
        while e < num_epochs:
            out.append(e)
            e *= self.reduction_factor
        out.append(num_epochs)
        return out

    def promote(self, score: float, rung_scores: Sequence[float]) -> bool:
        """Promote iff ``score`` is at or above the top ``1/rf`` quantile
        of every score reported at this rung so far (itself included)."""
        q = 100.0 * (1.0 - 1.0 / self.reduction_factor)
        cut = float(np.percentile(np.asarray(rung_scores, np.float64), q))
        return float(score) >= cut


class AshaScheduler:
    """Host-side ASHA bookkeeping: slot table, pending queue, rung ledger.

    Pure control state — it never touches a tensor — so the SAME scheduler
    drives both execution modes through one decision sequence:

        admits = sched.admit()            # backfill free slots (FIFO)
        delta = sched.tick_size()         # epochs until the next rung
        ... advance every occupied slot by delta epochs ...
        sched.advance(delta)
        for slot, trial in sched.due():   # rung reached, in slot order
            sched.report(trial, score)    # promote | stop | done

    JSON-serializable (:meth:`state_dict` / :meth:`from_state_dict`), in
    the reference's keys."""

    def __init__(self, rule: AsyncSuccessiveHalving, num_trials: int,
                 num_epochs: int, slots: int):
        self.rule = rule
        self.rungs = rule.rung_epochs(num_epochs)
        self.num_trials = int(num_trials)
        self.slots: List[Optional[int]] = [None] * int(slots)
        self.pending: List[int] = list(range(num_trials))
        self.local_epoch: Dict[int, int] = {}
        self.next_rung: Dict[int, int] = {}
        # per rung: scores / trial ids in report order
        self.rung_scores: List[List[float]] = [[] for _ in self.rungs]
        self.rung_trials: List[List[int]] = [[] for _ in self.rungs]
        self.terminal: Dict[int, str] = {}      # trial -> "stopped" | "done"
        self.slot_epochs = 0                    # budget meter
        self.global_epoch = 0

    # -- queries ------------------------------------------------------- #
    def occupied(self) -> List[Tuple[int, int]]:
        return [(j, t) for j, t in enumerate(self.slots) if t is not None]

    def exhausted(self) -> bool:
        return (self.rule.epoch_budget is not None
                and self.slot_epochs >= self.rule.epoch_budget)

    def finished(self) -> bool:
        return not self.occupied() and (not self.pending or self.exhausted())

    def tick_size(self) -> int:
        """Epochs until the nearest occupied slot reaches its next rung."""
        rem = [self.rungs[self.next_rung[t]] - self.local_epoch[t]
               for _, t in self.occupied()]
        return min(rem) if rem else 0

    def due(self) -> List[Tuple[int, int]]:
        """Occupied slots whose trial sits exactly at its next rung, in
        slot order."""
        return [(j, t) for j, t in self.occupied()
                if self.local_epoch[t] == self.rungs[self.next_rung[t]]]

    # -- transitions --------------------------------------------------- #
    def admit(self) -> List[Tuple[int, int]]:
        """Backfill every free slot from the pending queue (FIFO), unless
        the epoch budget is spent.  Returns the (slot, trial) admissions."""
        admits: List[Tuple[int, int]] = []
        for j, occ in enumerate(self.slots):
            if occ is not None or not self.pending or self.exhausted():
                continue
            t = self.pending.pop(0)
            self.slots[j] = t
            self.local_epoch[t] = 0
            self.next_rung[t] = 0
            admits.append((j, t))
        return admits

    def advance(self, delta: int) -> None:
        occ = self.occupied()
        for _, t in occ:
            self.local_epoch[t] += delta
        self.slot_epochs += delta * len(occ)
        self.global_epoch += delta

    def report(self, trial: int, score: float) -> bool:
        """Record ``trial``'s score at its rung and decide: True when it
        keeps running (promoted), False when its slot was freed."""
        rung = self.next_rung[trial]
        self.rung_scores[rung].append(float(score))
        self.rung_trials[rung].append(int(trial))
        j = self.slots.index(trial)
        if rung == len(self.rungs) - 1:
            self.terminal[trial] = "done"
            self.slots[j] = None
            return False
        if self.rule.promote(score, self.rung_scores[rung]):
            self.next_rung[trial] = rung + 1
            return True
        self.terminal[trial] = "stopped"
        self.slots[j] = None
        return False

    # -- persistence --------------------------------------------------- #
    def state_dict(self) -> dict:
        return {
            "rungs": self.rungs,
            "num_trials": self.num_trials,
            "slots": [(-1 if t is None else t) for t in self.slots],
            "pending": list(self.pending),
            "local_epoch": {str(t): e for t, e in self.local_epoch.items()},
            "next_rung": {str(t): r for t, r in self.next_rung.items()},
            "rung_scores": self.rung_scores,
            "rung_trials": self.rung_trials,
            "terminal": {str(t): s for t, s in self.terminal.items()},
            "slot_epochs": self.slot_epochs,
            "global_epoch": self.global_epoch,
        }

    @classmethod
    def from_state_dict(cls, rule: AsyncSuccessiveHalving, num_epochs: int,
                        state: dict) -> "AshaScheduler":
        sched = cls(rule, int(state["num_trials"]), num_epochs,
                    len(state["slots"]))
        if sched.rungs != [int(r) for r in state["rungs"]]:
            raise ValueError(
                f"checkpointed rung ladder {state['rungs']} does not match "
                f"this rule's {sched.rungs} — refusing to resume")
        sched.slots = [None if t == -1 else int(t) for t in state["slots"]]
        sched.pending = [int(t) for t in state["pending"]]
        sched.local_epoch = {int(t): int(e)
                             for t, e in state["local_epoch"].items()}
        sched.next_rung = {int(t): int(r)
                           for t, r in state["next_rung"].items()}
        sched.rung_scores = [[float(s) for s in rung]
                             for rung in state["rung_scores"]]
        sched.rung_trials = [[int(t) for t in rung]
                             for rung in state["rung_trials"]]
        sched.terminal = {int(t): str(s) for t, s in state["terminal"].items()}
        sched.slot_epochs = int(state["slot_epochs"])
        sched.global_epoch = int(state["global_epoch"])
        return sched


# --------------------------------------------------------------------------- #
# results
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class TrialResult:
    """Outcome of one trial: its config, the (higher-is-better) validation
    score averaged over folds, the per-rung score history, the final state
    of fold 0, whether a rule stopped it, and its trained model
    (``spec.finalize(state)``).  A pipeline search also fills
    ``pipeline`` (no field of the reference): the
    :class:`repro_torch.pipeline.FittedPipeline` of fold 0's train-fitted
    featurizers and the trial's model, which serves raw rows."""

    index: int
    config: Dict[str, Any]
    score: float
    rung_scores: List[float]
    state: Any
    stopped: bool = False
    model: Any = None
    pipeline: Any = None


@dataclasses.dataclass
class SearchResult:
    """All trials in enumeration order, plus the winner."""

    trials: List[TrialResult]

    @property
    def best(self) -> TrialResult:
        """Highest score; ties break to the lowest trial index."""
        return max(self.trials, key=lambda t: (t.score, -t.index))

    @property
    def scores(self) -> List[float]:
        return [t.score for t in self.trials]


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #
def _builtin_builder(algorithm: str, metric: Optional[str]
                     ) -> Callable[[Dict[str, Any]], TrialSpec]:
    """A registered algorithm name's trial-spec builder."""
    if algorithm == "logreg":
        from repro_torch.core.algorithms.logistic_regression import \
            LogisticRegressionAlgorithm as A
        return lambda cfg: A.trial_spec(cfg, metric=metric or "accuracy")
    if algorithm == "kmeans":
        from repro_torch.core.algorithms.kmeans import KMeans as A
        return lambda cfg: A.trial_spec(cfg, metric=metric or "silhouette")
    raise ValueError(
        f"unknown algorithm {algorithm!r} — pass 'logreg', 'kmeans', or a "
        f"spec-builder callable")


def _tree_set(stacked: Any, lane: int, value: Any) -> Any:
    """Write one trial's tree into lane ``lane`` of a stacked (K, …) tree
    (in place; the search owns its stacked trees) — how an ASHA admission
    takes over a freed slot without touching the other lanes."""
    _tree_map(lambda s, v: s[lane].copy_(torch.as_tensor(v)), stacked, value)
    return stacked


def _lane(stacked: Any, lane: int) -> Any:
    """A copy of lane ``lane`` of a stacked tree (the stack may be
    written later)."""
    return _tree_map(lambda x: x[lane].clone(), stacked)


def _asha_history(sched: "AshaScheduler", trial: int) -> List[float]:
    """One trial's rung-score trajectory, from the scheduler's ledger."""
    return [s for scores, trials in zip(sched.rung_scores, sched.rung_trials)
            for t, s in zip(trials, scores) if t == trial]


def _window_source(window: torch.Tensor) -> Callable[[int], Dict[str, torch.Tensor]]:
    """Stream source for a fold's train view: every epoch's window is the
    view's rows, already on the device (a pure function of the step)."""
    def source(step: int) -> Dict[str, torch.Tensor]:
        return {"data": window}

    return source


def _scores(spec: TrialSpec, val_table: Any, states: Any, schedule,
            k: int) -> np.ndarray:
    """``spec.score`` as a (k,) float64 host array."""
    out = spec.score(val_table, states, schedule)
    return np.asarray(torch.as_tensor(out).detach().cpu().numpy(),
                      np.float64).reshape(k)


def _splits(n: int, folds: Optional[int], val_fraction: float,
            seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    if folds:
        return list(KFold(n, folds, seed).splits())
    return [holdout_split(n, val_fraction, seed)]


def _trim(splits, mesh: Any, shards: int, chunks: int
          ) -> Tuple[Any, int, List[np.ndarray]]:
    """The layout (mesh, partition count) and each fold's train indices
    trimmed (from the tail of the sorted index) to a multiple of partitions
    × chunks; one partition, and no mesh, when a train view cannot fill
    that unit (the reference's layout rule)."""
    unit = shards * chunks
    if any(len(tr) < unit for tr, _ in splits):
        mesh, shards, unit = None, 1, chunks
    train_idx = [tr[: len(tr) - len(tr) % unit] for tr, _ in splits]
    if any(len(tr) == 0 for tr in train_idx):
        raise ValueError(
            f"a train split is smaller than chunks_per_epoch="
            f"{chunks} — nothing left to train on")
    return mesh, shards, train_idx


def _checkpointer(ckpt_dir: Optional[str], fp: str, mesh: Any
                  ) -> Optional[SearchCheckpointer]:
    """The search's checkpointer; on a mesh every host holds the same
    trials and host 0 alone writes them, as the runner's snapshots."""
    if not ckpt_dir:
        return None
    return SearchCheckpointer(ckpt_dir, fp,
                              write=mesh is None or mesh.host_id == 0)


@dataclasses.dataclass
class ModelSearch:
    """Grid/random model search over one algorithm and one table.

    Parameters are the reference's: ``algorithm`` (``"logreg"``,
    ``"kmeans"``, a callable ``config -> TrialSpec``, or a
    :class:`repro_torch.pipeline.Pipeline` — then ``run`` takes the *raw*
    table, ``"stage.param"`` keys address nested stages, bare keys go to
    the estimator, and featurizers are fit per train fold only),
    ``configs``, ``num_epochs`` / ``chunks_per_epoch`` (streaming epochs
    per trial), ``folds`` (k-fold, or ``None`` for a ``val_fraction``
    holdout), ``metric``, ``schedule``, ``execution`` (``"auto"`` |
    ``"stacked"`` | ``"sequential"``), ``seed``, ``early_stop`` (a
    :class:`MedianStoppingRule` every ``rung_epochs`` epochs, or an
    :class:`AsyncSuccessiveHalving` rule with its own rung ladder),
    ``callbacks`` (threaded into every training segment and fired at every
    rung boundary with the rung's scores as ``EvalEntry`` evals; under
    ASHA at rung boundaries only; only a ``hyper`` swap is accepted at the
    search level), ``ckpt_dir`` and ``unit_callback`` (called after every
    completed and checkpointed unit with ``(units_done, trial_indices)``;
    not part of the fingerprint)."""

    algorithm: Union[str, Callable[[Dict[str, Any]], TrialSpec], Any]
    configs: List[Dict[str, Any]]
    num_epochs: int = 8
    chunks_per_epoch: int = 1
    folds: Optional[int] = None
    val_fraction: float = 0.25
    metric: Optional[str] = None
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
    execution: str = "auto"
    seed: int = 0
    early_stop: Union[MedianStoppingRule, AsyncSuccessiveHalving, None] = None
    rung_epochs: Optional[int] = None
    callbacks: Sequence[Callable] = ()
    ckpt_dir: Optional[str] = None
    unit_callback: Optional[Callable[[int, List[int]], None]] = None

    def __post_init__(self) -> None:
        if not self.configs:
            raise ValueError("configs must not be empty")
        if self.folds is not None and self.folds < 2:
            raise ValueError(f"folds must be >= 2, got {self.folds}")

    # ------------------------------------------------------------------ #
    def _rungs(self) -> List[Tuple[int, int]]:
        """(start_epoch, end_epoch) segments: one per rung when early
        stopping is on, else one spanning the budget."""
        step = self.rung_epochs or (1 if self.early_stop else self.num_epochs)
        edges = list(range(0, self.num_epochs, step)) + [self.num_epochs]
        return [(a, b) for a, b in zip(edges, edges[1:]) if b > a]

    def _fingerprint(self, table: Any, pipeline: Any = None) -> str:
        """Identity of this search including the dataset's shape — the
        reference's payload, so the same search hashes the same."""
        name = (self.algorithm if isinstance(self.algorithm, str)
                else getattr(self.algorithm, "__name__", "custom"))
        if pipeline is not None:
            name = {"pipeline": pipeline.describe()}
        if isinstance(self.early_stop, AsyncSuccessiveHalving):
            rule = self.early_stop
            rungs = rule.rung_epochs(self.num_epochs)
            early = ["asha", rule.reduction_factor, rule.min_rounds,
                     rule.slots, rule.epoch_budget]
        else:
            rungs = self._rungs()
            early = (None if self.early_stop is None else
                     [self.early_stop.min_rungs, self.early_stop.min_trials])
        return fingerprint({
            "algorithm": name, "configs": self.configs,
            "num_epochs": self.num_epochs,
            "chunks_per_epoch": self.chunks_per_epoch,
            "folds": self.folds, "val_fraction": self.val_fraction,
            "metric": self.metric,
            "schedule": CollectiveSchedule.parse(self.schedule).value,
            "execution": self.execution, "seed": self.seed,
            "rungs": rungs,
            "early_stop": early,
            "data_shape": [int(table.num_rows), int(table.num_cols)],
        })

    # ------------------------------------------------------------------ #
    def _prepare(self, table: Any) -> Tuple[DistributedRunner,
                                            CollectiveSchedule,
                                            List[torch.Tensor], List[Any],
                                            List[Any]]:
        """Fold splits and execution layout.  Each fold's train rows are
        gathered on the table's device once (trimmed to a multiple of
        partitions × chunks, as the reference trims them); that view's
        tensor is every epoch's window, shared by every unit.  A mesh
        table's layout is kept when every train view fills a unit, else
        the views are one partition held whole by every host.  Validation
        views are never trimmed."""
        schedule = CollectiveSchedule.parse(self.schedule)
        splits = _splits(table.num_rows, self.folds, self.val_fraction, self.seed)
        table_mesh = getattr(table, "mesh", None)
        mesh, shards, train_idx = _trim(splits, table_mesh, table.num_shards,
                                        self.chunks_per_epoch)
        runner = DistributedRunner(num_shards=shards, schedule=schedule, mesh=mesh)
        whole = table_mesh is not None and mesh is None
        init_tables = [fold_view(table, tr, whole=whole) for tr in train_idx]
        train_windows = [t.data for t in init_tables]
        val_tables = [fold_view(table, va) for _, va in splits]
        return runner, schedule, train_windows, init_tables, val_tables

    def _results(self, specs: List[TrialSpec], done_states: Dict[int, Any],
                 done_info: Dict[int, Dict[str, Any]],
                 pipelines: Optional[Callable[[int, Any], Any]] = None
                 ) -> SearchResult:
        trials = []
        for i in sorted(done_info):
            model = specs[i].finalize(done_states[i]) if specs[i].finalize else None
            trials.append(TrialResult(
                index=i, config=dict(self.configs[i]),
                score=done_info[i]["score"],
                rung_scores=list(done_info[i]["rung_scores"]),
                state=done_states[i], stopped=bool(done_info[i]["stopped"]),
                model=model,
                pipeline=pipelines(i, model) if pipelines else None))
        return SearchResult(trials=trials)

    # ------------------------------------------------------------------ #
    def run(self, table: Any, resume: bool = False) -> SearchResult:
        """Execute the search over ``table`` and return every trial; with
        ``resume=True`` (and ``ckpt_dir``) completed units restore from the
        newest snapshot and execution continues at the first unfinished
        unit."""
        from repro_torch.pipeline import Pipeline

        if isinstance(self.algorithm, Pipeline):
            if isinstance(self.early_stop, AsyncSuccessiveHalving):
                raise NotImplementedError(
                    "ASHA over a Pipeline search is not supported yet — "
                    "use a MedianStoppingRule, or search the estimator "
                    "directly")
            return self._run_pipeline(table, resume)

        builder = (self.algorithm if callable(self.algorithm)
                   else _builtin_builder(self.algorithm, self.metric))
        specs = [builder(dict(cfg)) for cfg in self.configs]
        (runner, schedule, train_windows,
         init_tables, val_tables) = self._prepare(table)

        if isinstance(self.early_stop, AsyncSuccessiveHalving):
            return self._run_asha(table, specs, runner, schedule,
                                  train_windows, init_tables, val_tables,
                                  resume)
        ckpt = _checkpointer(self.ckpt_dir, self._fingerprint(table),
                             getattr(table, "mesh", None))
        done_states, done_info = self._run_units(
            ckpt, resume, specs, runner, schedule,
            lambda i: specs[i].init(init_tables[0]),
            lambda group: (train_windows, init_tables, val_tables))
        return self._results(specs, done_states, done_info)

    def _run_units(self, ckpt: Optional[SearchCheckpointer], resume: bool,
                   specs: List[TrialSpec], runner: DistributedRunner,
                   schedule: CollectiveSchedule,
                   template: Callable[[int], Any],
                   folds_of: Callable[[List[int]], tuple]):
        """The unit loop of ``run`` and ``_run_pipeline``: restore, run
        every unfinished unit, snapshot after each."""
        groups = group_trials(specs, self.execution)
        rungs = self._rungs()
        done_states: Dict[int, Any] = {}
        done_info: Dict[int, Dict[str, Any]] = {}
        units_done = 0
        if resume:
            if ckpt is None:
                raise ValueError("resume=True requires ckpt_dir")
            snap = ckpt.resume(template)
            if snap is not None:
                done_states, done_info, units_done = snap

        for unit_no, group in enumerate(groups):
            if unit_no < units_done:
                continue  # restored from the snapshot
            windows, inits, vals = folds_of(group)
            halted = self._run_unit(runner, specs, group, windows, inits,
                                    vals, rungs, schedule, done_states,
                                    done_info, unit_no=unit_no)
            units_done = unit_no + 1
            if ckpt is not None:
                ckpt.save(done_states, done_info, units_done)
            if self.unit_callback is not None:
                self.unit_callback(units_done, list(group))
            if halted:
                break  # a callback raised EarlyStopException: end the search
        return done_states, done_info

    # ------------------------------------------------------------------ #
    # pipeline search: featurizers fit per train fold, nested stage params
    # ------------------------------------------------------------------ #
    def _run_pipeline(self, table: Any, resume: bool = False) -> SearchResult:
        """Search a :class:`repro_torch.pipeline.Pipeline` over a *raw*
        table: each config splits into transformer overrides
        (``"ngrams.top"``) and estimator params; trials sharing a
        featurizer config share one featurization, fit on each fold's TRAIN
        view only — validation rows are transformed with the train-fitted
        statistics, never refit."""
        from repro_torch.core.mltable import MLTable, _chunk
        from repro_torch.pipeline.pipeline import FittedPipeline

        pipeline = self.algorithm
        est = pipeline.estimator
        if est is None or not hasattr(type(est), "trial_spec"):
            raise ValueError(
                "pipeline search needs a terminal estimator with a "
                "trial_spec (Searchable)")
        schedule = CollectiveSchedule.parse(self.schedule)
        base_over = est.overrides()
        metric_kw = {"metric": self.metric} if self.metric else {}

        split_cfgs = [pipeline.split_config(dict(c)) for c in self.configs]
        feat_keys = [json.dumps(fc, sort_keys=True, default=str)
                     for fc, _ in split_cfgs]
        specs: List[TrialSpec] = []
        for (fc, ec), fk in zip(split_cfgs, feat_keys):
            spec = type(est).trial_spec({**base_over, **ec}, **metric_kw)
            prev = (spec.stack_key if isinstance(spec.stack_key, tuple)
                    else (spec.stack_key,))
            specs.append(dataclasses.replace(spec, stack_key=(fk,) + prev))

        splits = _splits(table.num_rows, self.folds, self.val_fraction, self.seed)
        mesh = pipeline.mesh
        mesh, shards, train_idx = _trim(
            splits, mesh, mesh.num_partitions if mesh is not None
            else (pipeline.num_shards or 1), self.chunks_per_epoch)
        runner = DistributedRunner(num_shards=shards, schedule=schedule, mesh=mesh)
        val_idx = [va for _, va in splits]

        # raw fold views are shared by every featurizer config
        raw_views: Dict[int, Any] = {}
        host_rows = table.collect() if isinstance(table, MLTable) else None

        def raw_view(key: int, idx) -> Any:
            if key not in raw_views:
                if host_rows is not None:
                    raw_views[key] = MLTable(
                        _chunk([host_rows[int(i)] for i in idx],
                               table.num_partitions), table.schema)
                else:
                    raw_views[key] = take_rows(table, idx)
            return raw_views[key]

        # one featurization per distinct transformer config, lazy and
        # cached: (train windows, init tables, val tables) per fold, plus
        # fold 0's fitted stages and pipeline (what a trial serves with)
        feat_cache: Dict[str, tuple] = {}

        def featurized(trial: int):
            fk = feat_keys[trial]
            if fk not in feat_cache:
                fp = pipeline.with_stage_config(split_cfgs[trial][0])
                fp.mesh, fp.num_shards = mesh, shards
                windows, inits, vals, fitted0 = [], [], [], None
                for f, (tr, va) in enumerate(zip(train_idx, val_idx)):
                    fitted, ftab = fp._fit_stages(raw_view(2 * f, tr))
                    if f == 0:
                        fitted0 = fitted
                    windows.append(ftab.data)
                    inits.append(ftab)
                    vals.append(fp._transform_stages(
                        fitted, raw_view(2 * f + 1, va), mesh=None,
                        num_shards=1))
                feat_cache[fk] = (windows, inits, vals, (fp, fitted0))
            return feat_cache[fk]

        def served(i: int, model: Any) -> Any:
            _, inits, _, (fp, fitted) = featurized(i)
            return FittedPipeline(fp, fitted, model, inits[0].num_cols,
                                  inits[0].device)

        ckpt = _checkpointer(self.ckpt_dir, self._fingerprint(table, pipeline),
                             pipeline.mesh)
        done_states, done_info = self._run_units(
            ckpt, resume, specs, runner, schedule,
            lambda i: specs[i].init(featurized(i)[1][0]),
            lambda group: featurized(group[0])[:3])
        return self._results(specs, done_states, done_info, pipelines=served)

    # ------------------------------------------------------------------ #
    def _run_unit(self, runner: DistributedRunner, specs: List[TrialSpec],
                  group: List[int], train_windows: List[torch.Tensor],
                  init_tables: List[Any],
                  val_tables: List[Any], rungs: List[Tuple[int, int]],
                  schedule: CollectiveSchedule,
                  done_states: Dict[int, Any],
                  done_info: Dict[int, Dict[str, Any]], *,
                  unit_no: int = 0) -> bool:
        """Advance one execution unit (a stacked group or a single trial)
        through every rung of every fold, then record its trials.  Returns
        True when a rung-boundary callback raised
        :class:`EarlyStopException` (the driver ends the search)."""
        spec0 = specs[group[0]]
        k = len(group)
        hyper = tree_stack([specs[i].hyper for i in group])
        states = [tree_stack([specs[i].init(t) for i in group])
                  for t in init_tables]
        streams = [BatchIterator(_window_source(w), device=w.device)
                   for w in train_windows]
        active = np.ones(k, dtype=bool)
        rung_scores: Dict[int, List[float]] = {i: [] for i in group}
        halted = False
        metric_name = self.metric or "score"
        _, after_cbs = split_callbacks(self.callbacks)

        for rung_no, (start, end) in enumerate(rungs):
            if not active.any():
                # every trial is frozen: later rungs would change no state
                # and record no scores
                break
            for f, stream in enumerate(streams):
                states[f] = runner.run_stacked_epochs(
                    stream, states[f], hyper, spec0.local_step, end,
                    combine=spec0.combine, update=spec0.update,
                    active=active, chunks_per_epoch=self.chunks_per_epoch,
                    start_epoch=start, callbacks=self.callbacks)
            fold_scores = np.stack([_scores(spec0, val_tables[f], states[f],
                                            schedule, k)
                                    for f in range(len(val_tables))])
            scores_now = fold_scores.mean(axis=0)  # (K,)
            for j, i in enumerate(group):
                if active[j]:
                    rung_scores[i].append(float(scores_now[j]))
            if after_cbs:
                evals = tuple(
                    EvalEntry(i, metric_name, float(scores_now[j]), True)
                    for j, i in enumerate(group) if active[j])
                env = CallbackEnv(
                    epoch=end, begin_epoch=start, end_epoch=end,
                    round=end * self.chunks_per_epoch, state=states[0],
                    hyper=hyper, active=active.copy(), unit=unit_no,
                    trial_ids=tuple(group), evals=evals)
                try:
                    swaps = fire_callbacks(after_cbs, env)
                except EarlyStopException:
                    halted = True
                    break
                hyper = self._apply_search_swaps(swaps, hyper)
            if self.early_stop is not None and rung_no < len(rungs) - 1:
                self._apply_median_rule(group, active, rung_no, rung_scores,
                                        done_info)

        final_states = tree_unstack(states[0])
        for j, i in enumerate(group):
            done_states[i] = final_states[j]
            done_info[i] = {
                "score": rung_scores[i][-1],
                "rung_scores": rung_scores[i],
                "stopped": not bool(active[j]) or
                           (halted and len(rung_scores[i]) < len(rungs)),
            }
        return halted

    @staticmethod
    def _apply_search_swaps(swaps: dict, hyper: Any) -> Any:
        """Fold a rung-boundary callback's swaps into the search: only
        ``hyper`` may be steered here."""
        if not swaps:
            return hyper
        refused = set(swaps) - {"hyper"}
        if refused:
            raise ValueError(
                f"search-level callbacks may only swap 'hyper' at rung "
                f"boundaries, got {sorted(refused)} — state/active are "
                f"owned by the search driver")
        return swaps["hyper"]

    # ------------------------------------------------------------------ #
    # ASHA driver: slot table + pending-queue backfill (no cohort barrier)
    # ------------------------------------------------------------------ #
    def _run_asha(self, table: Any, specs: List[TrialSpec],
                  runner: DistributedRunner, schedule: CollectiveSchedule,
                  train_windows: List[torch.Tensor], init_tables: List[Any],
                  val_tables: List[Any], resume: bool) -> SearchResult:
        """Execute the search under :class:`AsyncSuccessiveHalving`: a
        fixed table of slots advances resident trials; whenever one reaches
        its next rung the segment ends, the trial reports, and freed slots
        are backfilled from the pending queue.  Stacked, the slot table IS
        the stacked carry (lane j hosts slot j; ``round_offsets`` give each
        admission its own round origin; the active mask covers freed
        lanes).  Sequential execution drives the same scheduler with one
        K = 1 segment per occupied slot.  With ``ckpt_dir`` every decision
        batch snapshots {terminal trials, live slot states, scheduler
        state}; an interrupted search resumes rung for rung."""
        rule = self.early_stop
        n = len(specs)
        slots = min(rule.slots or 8, n)
        stacked = (self.execution in ("auto", "stacked")
                   and len({s.stack_key for s in specs}) == 1)
        chunks = self.chunks_per_epoch
        folds = len(init_tables)
        metric_name = self.metric or "score"
        _, after_cbs = split_callbacks(self.callbacks)
        spec0 = specs[0]

        ckpt = _checkpointer(self.ckpt_dir, self._fingerprint(table),
                             getattr(table, "mesh", None))
        done_states: Dict[int, Any] = {}
        done_info: Dict[int, Dict[str, Any]] = {}
        units_done = 0
        sched = AshaScheduler(rule, n, self.num_epochs, slots)
        live: Dict[int, List[Any]] = {}

        if resume:
            if ckpt is None:
                raise ValueError("resume=True requires ckpt_dir")
            snap = ckpt.resume(lambda i: specs[i].init(init_tables[0]),
                               with_live=True)
            if snap is not None:
                done_states, done_info, units_done, live, extra = snap
                if not extra or "asha" not in extra:
                    raise ValueError(
                        "checkpoint carries no ASHA scheduler state — was it "
                        "written by a median-rule search?")
                sched = AshaScheduler.from_state_dict(
                    rule, self.num_epochs, extra["asha"])

        streams = [BatchIterator(_window_source(w), device=w.device)
                   for w in train_windows]

        hyper = states = None
        offsets = np.zeros(slots, np.int32)
        active = np.zeros(slots, bool)
        if stacked:
            # lane tensors; on resume, occupied lanes restore from `live`
            hyper = tree_stack([
                specs[t].hyper if (t := sched.slots[j]) is not None
                else specs[0].hyper for j in range(slots)])
            states = [tree_stack([
                live[t][f] if (t := sched.slots[j]) is not None
                else specs[0].init(init_tables[f]) for j in range(slots)])
                for f in range(folds)]
            for j, t in sched.occupied():
                offsets[j] = (sched.global_epoch - sched.local_epoch[t]) * chunks
                active[j] = True

        halted = False
        while not sched.finished():
            for j, t in sched.admit():
                if stacked:
                    for f in range(folds):
                        _tree_set(states[f], j, specs[t].init(init_tables[f]))
                    _tree_set(hyper, j, specs[t].hyper)
                    # admission at an epoch boundary: the offset is a
                    # multiple of chunks, so the chunk phase (r % chunks)
                    # matches a solo run exactly
                    offsets[j] = sched.global_epoch * chunks
                    active[j] = True
                else:
                    live[t] = [specs[t].init(init_tables[f])
                               for f in range(folds)]
            if not sched.occupied():
                break  # budget exhausted with trials still pending
            delta = sched.tick_size()
            g0 = sched.global_epoch
            if stacked:
                for f, stream in enumerate(streams):
                    states[f] = runner.run_stacked_epochs(
                        stream, states[f], hyper, spec0.local_step,
                        g0 + delta, combine=spec0.combine,
                        update=spec0.update, active=active,
                        chunks_per_epoch=chunks, start_epoch=g0,
                        round_offsets=offsets)
            else:
                for j, t in sched.occupied():
                    le = sched.local_epoch[t]
                    spec = specs[t]
                    h1 = tree_stack([spec.hyper])
                    for f, stream in enumerate(streams):
                        st = runner.run_stacked_epochs(
                            stream, tree_stack([live[t][f]]), h1,
                            spec.local_step, le + delta,
                            combine=spec.combine, update=spec.update,
                            chunks_per_epoch=chunks, start_epoch=le)
                        live[t][f] = tree_unstack(st)[0]
            sched.advance(delta)
            due = sched.due()
            if not due:
                continue  # defensive: tick_size targets the nearest rung
            if stacked:
                fold_scores = np.stack([
                    _scores(spec0, val_tables[f], states[f], schedule, slots)
                    for f in range(folds)])
                lane_scores = fold_scores.mean(axis=0)
                due_scores = [float(lane_scores[j]) for j, _ in due]
            else:
                due_scores = []
                for j, t in due:
                    per_fold = [float(_scores(specs[t], val_tables[f],
                                              tree_stack([live[t][f]]),
                                              schedule, 1)[0])
                                for f in range(folds)]
                    due_scores.append(float(np.mean(per_fold)))

            newly_terminal: List[int] = []
            for (j, t), s in zip(due, due_scores):
                if sched.report(t, s):
                    continue  # promoted — keeps its slot
                if stacked:
                    done_states[t] = _lane(states[0], j)
                    active[j] = False
                else:
                    done_states[t] = live.pop(t)[0]
                hist = _asha_history(sched, t)
                done_info[t] = {
                    "score": hist[-1],
                    "rung_scores": hist,
                    "stopped": sched.terminal[t] == "stopped",
                }
                newly_terminal.append(t)

            if after_cbs:
                evals = tuple(EvalEntry(t, metric_name, s, True)
                              for (_, t), s in zip(due, due_scores))
                env = CallbackEnv(
                    epoch=sched.global_epoch, begin_epoch=0,
                    end_epoch=self.num_epochs,
                    round=sched.global_epoch * chunks,
                    state=states[0] if stacked else None,
                    hyper=hyper if stacked else None,
                    active=active.copy() if stacked else None,
                    unit=units_done, trial_ids=tuple(t for _, t in due),
                    evals=evals)
                try:
                    swaps = fire_callbacks(after_cbs, env)
                except EarlyStopException:
                    halted = True
                    swaps = {}
                if swaps:
                    if not stacked:
                        raise ValueError(
                            "hyper steering under ASHA requires stacked "
                            "execution — sequential slots have no shared "
                            "hyper tree")
                    hyper = self._apply_search_swaps(swaps, hyper)

            units_done += 1
            if ckpt is not None:
                if stacked:
                    live = {t: [_lane(states[f], j) for f in range(folds)]
                            for j, t in sched.occupied()}
                ckpt.save(done_states, done_info, units_done, live=live,
                          extra={"asha": sched.state_dict()})
            if self.unit_callback is not None:
                self.unit_callback(len(done_info), newly_terminal)
            if halted:
                break

        if halted:
            # drain: running trials end as stopped with their last rung
            # score; trials that never reached a rung are unreported
            for j, t in sched.occupied():
                hist = _asha_history(sched, t)
                if not hist:
                    continue
                done_states[t] = (_lane(states[0], j) if stacked
                                  else live[t][0])
                done_info[t] = {"score": hist[-1], "rung_scores": hist,
                                "stopped": True}

        return self._results(specs, done_states, done_info)

    def _apply_median_rule(self, group: List[int], active: np.ndarray,
                           rung_no: int,
                           rung_scores: Dict[int, List[float]],
                           done_info: Dict[int, Dict[str, Any]]) -> None:
        """Freeze every active trial scoring below the median of its peers
        at this rung (peers: completed trials with a score at the same
        rung, plus the rest of the group)."""
        def score_at(history: Sequence[float]) -> Optional[float]:
            return history[rung_no] if len(history) > rung_no else None

        peer_pool = {
            i: score_at(info["rung_scores"])
            for i, info in done_info.items()
        }
        peer_pool.update({i: score_at(rung_scores[i])
                          for j, i in enumerate(group) if active[j]})
        for j, i in enumerate(group):
            if not active[j]:
                continue
            mine = peer_pool[i]
            peers = [s for t, s in sorted(peer_pool.items())
                     if t != i and s is not None]
            if mine is not None and self.early_stop.stop(rung_no, mine, peers):
                active[j] = False
