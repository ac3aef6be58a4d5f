"""Trial execution for model search: stacked groups + checkpointing.

Counterpart: ``src/repro/tune/trials.py`` (``TrialSpec``, ``tree_stack``,
``tree_unstack``, ``group_trials``, ``fingerprint``,
``SearchCheckpointer``).

A *trial* is one candidate configuration of an algorithm, described by a
:class:`TrialSpec`: the runner's local-function contract plus a per-trial
``hyper`` tree of scalar hyperparameters.  K trials with the same
``stack_key`` form one execution unit whose states carry a leading (K, …)
trial axis and advance together through
:meth:`repro_torch.core.runner.DistributedRunner.run_stacked_epochs`.
Where the reference ``vmap``s one trial's round over that axis, the port
writes the axis out: each lane runs the same launches as the trial run
alone, so a lane's bits never depend on the stack (see the runner).
Ragged trials (different ``stack_key``) land in groups of their own.

:class:`SearchCheckpointer` snapshots a search after every completed unit
through :mod:`repro_torch.checkpoint.store`, in the reference's format and
metadata, so a killed search resumes trial for trial — and a snapshot
written by either package restores in the other.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import torch

from repro_torch.core.runner import (TrialStep, TrialUpdateFn, _first_device,
                                     _tree_leaves, _tree_map)

__all__ = [
    "TrialSpec",
    "tree_stack",
    "tree_unstack",
    "group_trials",
    "SearchCheckpointer",
    "fingerprint",
]


def tree_stack(trees: Sequence[Any]) -> Any:
    """Stack identically-structured trees into one tree whose every leaf
    has a new leading (K,) trial axis."""
    return _tree_map(lambda *xs: torch.stack([torch.as_tensor(x) for x in xs]),
                     trees[0], *trees[1:])


def tree_unstack(stacked: Any) -> List[Any]:
    """Inverse of :func:`tree_stack`: the K trees of the leading axis."""
    leaves = _tree_leaves(stacked)
    if not leaves:
        return []
    return [_tree_map(lambda x, i=i: x[i], stacked)
            for i in range(leaves[0].shape[0])]


@dataclasses.dataclass
class TrialSpec:
    """One candidate configuration, in runner form.

    Within a stack group every spec's ``local_step`` / ``update`` /
    ``score`` must be interchangeable (config differences only through
    ``hyper`` and ``init``); the executor uses the first spec's functions
    for the whole group.

    Fields
    ------
    config:
        The raw search-point dict (JSON-able; recorded in checkpoints).
    hyper:
        Tree of 0-d fp32 tensors — the per-trial hyperparameters.  Stacked
        to (K,) leaves.
    init:
        ``init(train_table) -> state tree`` (zeros for logreg, seeded rows
        for k-means centroids), on the table's device.
    local_step / combine / update:
        The runner contract for one trial:
        ``local_step(blocks, state, r, hyper) -> (P, ...) partials``
        combined under ``combine``, then ``update(state, combined, r,
        hyper)``.
    stack_key:
        Trials with equal ``stack_key`` may share one stacked unit.
    score:
        ``score(val_table, stacked_states, schedule) -> (K,)`` validation
        scores, **higher is better**; lane j's score depends on lane j's
        state only.
    finalize:
        ``finalize(state) -> Model`` for a trial's trained model.
    """

    config: Dict[str, Any]
    hyper: Any
    init: Callable[[Any], Any]
    local_step: TrialStep
    combine: str = "mean"
    update: Optional[TrialUpdateFn] = None
    stack_key: Hashable = ()
    score: Optional[Callable[[Any, Any, Any], torch.Tensor]] = None
    finalize: Optional[Callable[[Any], Any]] = None


def group_trials(specs: Sequence[TrialSpec], execution: str = "auto"
                 ) -> List[List[int]]:
    """Deal trial indices into execution units: ``"stacked"``/``"auto"``
    group by ``stack_key`` in first-occurrence order; ``"sequential"``
    gives one unit per trial.  Deterministic, so a resumed search
    re-derives the same unit order."""
    if execution == "sequential":
        return [[i] for i in range(len(specs))]
    if execution not in ("auto", "stacked"):
        raise ValueError(f"unknown execution mode {execution!r}")
    groups: Dict[Hashable, List[int]] = {}
    order: List[Hashable] = []
    for i, spec in enumerate(specs):
        if spec.stack_key not in groups:
            groups[spec.stack_key] = []
            order.append(spec.stack_key)
        groups[spec.stack_key].append(i)
    return [groups[k] for k in order]


def fingerprint(payload: Dict[str, Any]) -> str:
    """Stable hash of the search definition — the reference's: the same
    search hashes the same in both packages."""
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()


class SearchCheckpointer:
    """Search-level checkpoint and resume at execution-unit granularity.

    After every completed unit the search writes ONE atomic snapshot: the
    final state of every completed trial (keyed by trial index) plus a
    JSON record of scores, rung histories and the search fingerprint.
    ``resume`` restores the newest snapshot, refuses a mismatched
    fingerprint, and hands back the completed set."""

    def __init__(self, ckpt_dir: str, search_fingerprint: str) -> None:
        self.ckpt_dir = ckpt_dir
        self.fingerprint = search_fingerprint

    def save(self, states: Dict[int, Any], info: Dict[int, Dict[str, Any]],
             units_done: int, *,
             live: Optional[Dict[int, List[Any]]] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot all completed trials at ``units_done`` (cumulative;
        ``keep=2``).  ``live`` (``{trial: [state per fold]}``) carries the
        states of trials still in a slot (ASHA); ``extra`` is a JSON-able
        dict stored in the metadata (the slot scheduler's state)."""
        from repro_torch.checkpoint.store import save_checkpoint

        tree: Dict[str, Any] = {
            "states": {str(i): states[i] for i in sorted(states)}}
        meta: Dict[str, Any] = {
            "fingerprint": self.fingerprint,
            "units_done": units_done,
            "trials": {str(i): info[i] for i in sorted(info)},
        }
        if live is not None:
            tree["live"] = {str(t): {str(f): fs
                                     for f, fs in enumerate(live[t])}
                            for t in sorted(live)}
            meta["live_trials"] = sorted(live)
            meta["num_folds"] = (len(next(iter(live.values())))
                                 if live else 0)
        if extra is not None:
            meta["extra"] = extra
        save_checkpoint(self.ckpt_dir, units_done, tree, metadata=meta,
                        keep=2)

    def resume(self, template_init: Callable[[int], Any], *,
               with_live: bool = False) -> Optional[tuple]:
        """Restore the newest snapshot, or None when there is none.

        ``template_init(trial_index) -> state tree`` supplies the restore
        template (only structure, shape and dtype are read); the restored
        tensors land on the template's device.  Returns ``(states, info,
        units_done)``, or with ``with_live=True`` ``(states, info,
        units_done, live, extra)``."""
        from repro_torch.checkpoint.store import latest_step, load_metadata, \
            restore_checkpoint

        step = latest_step(self.ckpt_dir)
        if step is None:
            return None
        meta = load_metadata(self.ckpt_dir, step)
        if not meta or meta.get("fingerprint") != self.fingerprint:
            raise ValueError(
                f"checkpoint in {self.ckpt_dir} was written by a different "
                f"search (fingerprint mismatch) — refusing to resume")
        indices = sorted(int(i) for i in meta["trials"])
        template: Dict[str, Any] = {
            "states": {str(i): template_init(i) for i in indices}}
        live_ids = [int(t) for t in meta.get("live_trials", [])]
        num_folds = int(meta.get("num_folds", 0))
        # the template must cover live entries whenever the snapshot has
        # them — restore refuses checkpoints with unclaimed arrays
        if "live_trials" in meta:
            template["live"] = {str(t): {str(f): template_init(t)
                                         for f in range(num_folds)}
                                for t in live_ids}
        device = _first_device(template) or _first_device(template_init(0))
        tree, _ = restore_checkpoint(self.ckpt_dir, template, step,
                                     device=device)
        states = {i: tree["states"][str(i)] for i in indices}
        info = {i: meta["trials"][str(i)] for i in indices}
        if not with_live:
            return states, info, int(meta["units_done"])
        live = {t: [tree["live"][str(t)][str(f)] for f in range(num_folds)]
                for t in live_ids} if "live" in tree else {}
        return states, info, int(meta["units_done"]), live, meta.get("extra")
