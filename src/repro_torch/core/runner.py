"""DistributedRunner — the shared execution layer.

Counterpart: ``src/repro/core/runner.py`` (``partition_apply``,
``run_once``, ``run_rounds``, ``_emulated_combine``, mesh mode, the
streaming mode: ``CheckpointPolicy``, ``run_epochs``, ``_save_snapshot``,
``resume`` with ``allow_resize`` and ``_check_window``, the
stale-synchronous lane, and the stacked trials below).

Algorithms express their per-partition compute as local functions and
delegate partitioning, iteration and the combine here:

    runner = DistributedRunner.for_table(table, schedule=params.schedule)
    final = runner.run_rounds(table, init, local_step, num_rounds,
                              combine="mean")

Where the reference ``vmap``s a local function over the partition blocks,
the port writes the partition dimension out: a local function receives the
whole ``(num_shards, rows_per_shard, cols)`` stack and returns one partial
per partition stacked on a leading axis.  One kernel launch therefore
covers every partition.  The reference's ``lax.scan`` over rounds is a
Python loop.  In emulated mode the partitions lie on the table's device, so
the combine is the local reduction of each collective and the schedule does
not change the arithmetic.

Beyond the paper's resident-table loop, the runner has a **streaming mode**
(:meth:`DistributedRunner.run_epochs`): each epoch pulls one host window
from a :class:`repro_torch.data.pipeline.BatchIterator`, views it as
``(num_shards, rows_per_shard, cols)`` blocks on the device, and runs
``chunks_per_epoch`` rounds over it; round ``r`` of epoch ``e`` sees chunk
``r % chunks`` of every partition, ``blocks[:, c·cr:(c+1)·cr]`` (a view,
never a copy: the kernels take a partition stride), under the global round
index ``e·chunks + r``.  With a :class:`CheckpointPolicy` the state, the
epoch, the stream position and an optional rng key are snapshotted
atomically through :mod:`repro_torch.checkpoint.store`, in the reference's
file format and metadata, and :meth:`DistributedRunner.resume` restarts a
killed run from the newest snapshot bit for bit on the same device.  The
caller's ``init_state`` is never changed in place (the reference copies it
before donating the carry).

Between epochs, ``run_epochs`` fires the host-side hooks of
:mod:`repro_torch.tune.callback` (``callbacks`` and ``eval_fn``) in the
reference's order, with its swaps and its tail checkpoint on
:class:`repro_torch.tune.callback.EarlyStopException`.

**Stacked trials** (model search; counterpart ``_mask_tree``,
``_stacked_callback_shim``, ``_stacked_carry``, ``_stacked_fns``,
``run_stacked_rounds`` and ``run_stacked_epochs``): K trials whose states
carry a leading (K, …) axis advance together, one window and one chunk
view for all of them.  Where the reference ``vmap``s one trial's round
over that axis, the port writes the axis out: every round runs each
active lane's step, combine and update on that lane alone, exactly the
launches of the same trial run with K = 1, so lane j's bits never depend
on K or on the other lanes (cuBLAS picks its order by shape, and a
batched product over K lanes would change the shape it sees).  A frozen
lane (``active`` false) is not run at all and keeps its bits; lane j sees
the trial-local round ``r - round_offsets[j]``.  The active mask, the
offsets and the hyperparameters are host (CPU) tensors, read per lane
without waiting for the card.

**Mesh mode** (``mesh=``, a :class:`repro_torch.core.hostmesh.HostMesh`):
host processes joined by a ``torch.distributed`` group, each holding ``L``
of the ``P = H·L`` partitions.  A host's table or window holds only its
own rows; every round runs ONE local-step launch over the host's ``(L,
rows, cols)`` stack, as emulated mode does over its ``(P, rows, cols)``
stack, and the combine runs the schedule over the group
(:mod:`repro_torch.core.collectives`); every host then holds the same
state.  Host 0 alone writes the snapshots of a mesh run (one writer per
global mesh, a shared filesystem), recording the global rows and
partitions; every host returns from a snapshot once it is published (a
barrier), so a resume on any host reads it; and ``resume(..., allow_resize=True)`` picks a run up on
another world size through :func:`repro_torch.core.partition.plan_resize`.
Stacked trials run on a mesh too: each active lane's round combines across
the hosts on its own, as the same trial run alone would, so a stacked
search on a mesh equals the sequential one bit for bit (the lanes'
partials are not packed into one collective: under ``gather_broadcast``
that would be the same bits but under the reduction schedules each lane's
sum would change with the stack).

**Stale-synchronous lane** (counterpart ``_ssp_merge``, ``run_epochs_ssp``,
``resume_ssp``): independent hosts, each with its own runner (emulated or
its own mesh), exchange through a shared
:class:`repro_torch.core.exchange.ParamStore` under a staleness bound
instead of lock-step collectives; merges stack the entries in host-id order
and reduce on the device, so ``staleness=0`` is bitwise a sequential replay
of the hosts.

The reference's ``_canonical_state`` has no twin (there is no compiled
epoch whose input sharding could drift), nor has ``epoch_fn``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Sequence, Union

import torch

from repro_torch.core import collectives as coll
from repro_torch.core import partition as pt
from repro_torch.core.collectives import CollectiveSchedule, _tree_map, ssp_read_round

__all__ = ["CheckpointPolicy", "DistributedRunner"]

# local_step(blocks (P, rows, cols), state, round_index) -> (P, ...) partials
LocalStep = Callable[[torch.Tensor, Any, int], torch.Tensor]
# update(state, combined, round_index) -> next state (defaults to `combined`)
UpdateFn = Callable[[Any, torch.Tensor, int], Any]
# trial_step(blocks, state, round_index, hyper) -> (P, ...) partials of ONE
# trial; the stacked entry points run it lane by lane
TrialStep = Callable[[torch.Tensor, Any, int, Any], Any]
# trial_update(state, combined, round_index, hyper) -> next state of ONE trial
TrialUpdateFn = Callable[[Any, Any, int, Any], Any]
# round_fn(blocks, state, round_index) -> next state: one whole round
RoundFn = Callable[[torch.Tensor, Any, int], Any]


def _tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in :func:`_tree_map`'s order."""
    out: List[Any] = []
    _tree_map(out.append, tree)
    return out


def _emulated_combine(stacked: Any, combine: str) -> Any:
    """Combine a (shards, ...) stack (or a tree of them) without a mesh —
    the local form of each collective."""
    if not isinstance(stacked, torch.Tensor):
        return _tree_map(lambda x: _emulated_combine(x, combine), stacked)
    if combine == "mean":
        return stacked.mean(dim=0)
    if combine == "sum":
        return stacked.sum(dim=0)
    if combine == "concat":
        return pt.unpartition_rows(stacked)
    raise ValueError(f"unknown combine {combine!r}")


_MESH_COMBINERS = {
    "mean": coll.combine_mean,
    "sum": coll.combine_sum,
    "concat": coll.combine_concat,
}


def _mask_tree(active: Sequence[bool], new: dict, old: Any) -> Any:
    """Write each active lane's new state into lane j of the stacked tree
    ``old`` (in place; ``new`` maps lane → that lane's tree).  Frozen lanes
    keep their bits — the reference's per-leaf ``where`` over the (K,)
    mask, done by lane writes since a frozen lane is never run."""
    for j, lane in new.items():
        if active[j]:
            _tree_map(lambda dst, src: dst[j].copy_(src), old, lane)
    return old


def _host(x: Any, dtype: torch.dtype) -> torch.Tensor:
    """A private CPU copy of a mask or offsets (a list, a numpy array or a
    tensor anywhere): the carry's control state, read per lane."""
    return torch.as_tensor(x).to("cpu", dtype).clone()


def _own(tree: Any) -> Any:
    """A private copy of a stacked tree, which the lane writes may change
    in place (the caller's tensors never are)."""
    return _tree_map(lambda x: torch.as_tensor(x).clone(), tree)


def _stacked_callback_shim(cb: Callable) -> Callable:
    """Adapt a trial-level callback to the stacked carry: the env the
    callback sees carries the (K, …) trial tree, the hyper tree and a host
    copy of the active mask instead of the carry dict, and a ``state`` /
    ``hyper`` / ``active`` swap it returns is folded back into the carry.
    ``order`` and ``before_epoch`` are kept."""
    def shim(env):
        carry = env.state
        tenv = dataclasses.replace(env, state=carry["trial"], hyper=carry["hyper"],
                                   active=carry["active"].numpy().copy())
        out = cb(tenv)
        if not out:
            return None
        new = dict(carry)
        if "state" in out:
            new["trial"] = _own(out["state"])
        if "hyper" in out:
            new["hyper"] = out["hyper"]
        if "active" in out:
            new["active"] = _host(out["active"], torch.bool)
        return {"state": new}

    shim.order = getattr(cb, "order", 10)
    shim.before_epoch = getattr(cb, "before_epoch", False)
    return shim


@dataclasses.dataclass
class CheckpointPolicy:
    """When and where the streaming loop snapshots its state.

    Every ``every_epochs`` completed epochs,
    :meth:`DistributedRunner.run_epochs` writes one atomic checkpoint
    through :mod:`repro_torch.checkpoint.store` carrying the state tree
    **and** the host-side loop counters (epoch, stream step, rng key, chunk
    layout, schedule) — everything :meth:`DistributedRunner.resume` needs
    to restart the run bit for bit.  ``keep`` prunes all but the newest
    ``keep`` snapshots after each publish.

    ``extra_state`` (a tree of tensors) and ``extra_metadata`` (a JSON-able
    dict) ride in every snapshot beside the training carry — one atomic
    file, so a composite artifact (a fitted pipeline's featurizer
    statistics + model state + stream position) can never be torn apart by
    a crash.  On resume the restored extra tree replaces ``extra_state``,
    so the caller reads the snapshot's values back off the policy.
    """

    ckpt_dir: str
    every_epochs: int = 1
    keep: Optional[int] = None
    extra_state: Any = None
    extra_metadata: Optional[dict] = None

    def __post_init__(self) -> None:
        if self.every_epochs < 1:
            raise ValueError(f"every_epochs must be >= 1, got {self.every_epochs}")
        if self.keep is not None and self.keep < 1:
            raise ValueError(f"keep must be >= 1, got {self.keep}")


def _first_device(tree: Any) -> Optional[torch.device]:
    """The device of the first tensor leaf of a state tree, if any."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            d = _first_device(v)
            if d is not None:
                return d
    return None


@dataclasses.dataclass
class DistributedRunner:
    """Owns data partitioning, the round loop and the per-round combine.

    ``mesh`` is a :class:`repro_torch.core.hostmesh.HostMesh`, or None for
    emulated partitions on one device; ``num_shards`` is the emulated
    partition count (with a mesh, the mesh's ``H·L`` partitions);
    ``schedule`` the :class:`CollectiveSchedule` of every global combine.
    """

    num_shards: int = 1
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
    mesh: Any = None

    def __post_init__(self) -> None:
        self.schedule = CollectiveSchedule.parse(self.schedule)
        if self.mesh is not None:
            self.num_shards = self.mesh.num_partitions
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")

    @classmethod
    def for_table(cls, table: Any,
                  schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
                  ) -> "DistributedRunner":
        """A runner matching a table's partition layout (and mesh)."""
        return cls(num_shards=table.num_shards, schedule=schedule,
                   mesh=getattr(table, "mesh", None))

    @property
    def local_shards(self) -> int:
        """Partitions this process holds: the mesh's ``L``, or all of them
        in emulated mode."""
        return self.mesh.local_partitions if self.mesh is not None else self.num_shards

    @property
    def num_hosts(self) -> int:
        return self.mesh.num_hosts if self.mesh is not None else 1

    def _combine(self, stacked: Any, combine: str) -> Any:
        """Combine this process's stacked partials over every partition:
        the collective under the schedule on a mesh, else the local form."""
        if self.mesh is None:
            return _emulated_combine(stacked, combine)
        if combine not in _MESH_COMBINERS:
            raise ValueError(f"unknown combine {combine!r}")
        return _MESH_COMBINERS[combine](stacked, self.mesh, self.schedule)

    def _round_fn(self, local_step: LocalStep, update: Optional[UpdateFn],
                  combine: str) -> RoundFn:
        """One round of the paper's loop: local step → combine → update."""
        def round_fn(blocks: torch.Tensor, state: Any, r: int) -> Any:
            combined = self._combine(local_step(blocks, state, r), combine)
            return combined if update is None else update(state, combined, r)

        return round_fn

    def partition_apply(self, data: torch.Tensor, fn: Callable,
                        broadcast: Sequence[Any] = (),
                        combine: Optional[str] = None) -> torch.Tensor:
        """Run ``fn(blocks, *broadcast)`` once over the ``(local_shards,
        rows, ...)`` view of ``data`` (this process's rows).
        ``combine=None`` returns the stacked per-partition results;
        ``"mean" | "sum" | "concat"`` combines them over every partition."""
        out = fn(pt.partition_rows(data, self.local_shards), *broadcast)
        if combine is None:
            return out
        return self._combine(out, combine)

    def run_once(self, table: Any, local_fn: Callable, *broadcast: Any,
                 combine: str = "sum") -> torch.Tensor:
        """One combined pass: ``local_fn(blocks, *broadcast)`` then one
        global combine (the closed-form algorithms' pattern)."""
        return self.partition_apply(table.data, local_fn, broadcast, combine)

    def run_rounds(self, table: Any, init_state: Any, local_step: LocalStep,
                   num_rounds: int, *, combine: str = "mean",
                   update: Optional[UpdateFn] = None,
                   start_round: int = 0) -> Any:
        """Run ``num_rounds`` of: ``local_step(blocks, state, r)`` → global
        combine → ``update(state, combined, r)`` (the combined value becomes
        the next state when ``update`` is None).

        The paper's main loop (Fig. A4: localSGD + avgWeights):
        parameter-averaging methods pass ``combine="mean"`` and no
        ``update``; sufficient-statistics methods (k-means, full-batch GD)
        pass ``combine="sum"`` and an ``update``.  ``start_round`` offsets
        the round indices ``local_step`` sees."""
        return self._rounds(table, init_state,
                            self._round_fn(local_step, update, combine),
                            num_rounds, start_round)

    def _rounds(self, table: Any, state: Any, round_fn: RoundFn,
                num_rounds: int, start_round: int) -> Any:
        blocks = pt.partition_rows(table.data, self.local_shards)
        for r in range(start_round, start_round + num_rounds):
            state = round_fn(blocks, state, r)
        return state

    # ------------------------------------------------------------------ #
    # streaming mode: epochs over minibatch windows (beyond the paper)
    # ------------------------------------------------------------------ #
    def _check_window(self, window: torch.Tensor, chunks_per_epoch: int) -> None:
        """``window`` is this process's rows of the epoch's window."""
        pt.check_rows_divisible(window.shape[0], self.local_shards,
                                what="stream partitions")
        per_shard = window.shape[0] // self.local_shards
        if per_shard % chunks_per_epoch != 0:
            raise ValueError(
                f"rows-per-shard {per_shard} must divide into "
                f"chunks_per_epoch={chunks_per_epoch}")

    def run_epochs(self, stream: Iterator, init_state: Any,
                   local_step: LocalStep, num_epochs: int, *,
                   combine: str = "mean", update: Optional[UpdateFn] = None,
                   chunks_per_epoch: int = 1,
                   checkpoint: Optional[CheckpointPolicy] = None,
                   rng: Optional[torch.Tensor] = None,
                   start_epoch: int = 0,
                   callbacks: Sequence[Callable] = (),
                   eval_fn: Optional[Callable] = None) -> Any:
        """Streaming variant of :meth:`run_rounds` for data larger than
        device memory: each epoch pulls ONE window of rows from ``stream``
        (a :class:`repro_torch.data.pipeline.BatchIterator` yielding
        ``{"data": (rows, cols)}`` batches already on the device) and runs
        ``chunks_per_epoch`` rounds of local step → combine → update over
        it.  Round ``r`` of epoch ``e`` sees the window's ``r %
        chunks_per_epoch``-th row chunk of every partition and the global
        round index ``e * chunks_per_epoch + r``.

        With a :class:`CheckpointPolicy`, every ``every_epochs`` epochs (and
        after the last) the ``(state, epoch, stream.step, rng)`` tuple is
        snapshotted atomically; :meth:`resume` restarts from the newest
        snapshot bit for bit.  ``rng`` is an optional integer tensor (a
        key for stochastic pipelines) that rides in the snapshot as a list
        of ints, as the reference carries its key.

        ``callbacks`` are host-side hooks fired between epochs (the
        :mod:`repro_torch.tune.callback` protocol): before-epoch callbacks
        may return a ``{"state": ...}`` swap the next epoch trains on,
        after-epoch callbacks see ``eval_fn(state, epoch) -> [EvalEntry,
        ...]`` and may raise
        :class:`repro_torch.tune.callback.EarlyStopException` to end the
        loop — the tail checkpoint is still written."""
        return self._epochs(stream, init_state,
                            self._round_fn(local_step, update, combine),
                            num_epochs, chunks_per_epoch=chunks_per_epoch,
                            checkpoint=checkpoint, rng=rng, start_epoch=start_epoch,
                            callbacks=callbacks, eval_fn=eval_fn)

    @staticmethod
    def _fire(hooks: Sequence[Callable], env: Any) -> tuple:
        """One hook point of :meth:`_epochs`: ``(swaps, stopped)``; only a
        ``state`` swap is accepted."""
        from repro_torch.tune.callback import EarlyStopException, fire_callbacks

        try:
            swaps = fire_callbacks(hooks, env)
        except EarlyStopException:
            return {}, True
        if set(swaps) - {"state"}:
            raise ValueError(
                f"run_epochs carries only 'state' — a callback "
                f"returned {sorted(set(swaps) - {'state'})} (hyper/"
                f"active swaps need the stacked loop)")
        return swaps, False

    def _epochs(self, stream: Iterator, state: Any, round_fn: RoundFn,
                num_epochs: int, *, chunks_per_epoch: int,
                checkpoint: Optional[CheckpointPolicy], rng: Optional[torch.Tensor],
                start_epoch: int, callbacks: Sequence[Callable],
                eval_fn: Optional[Callable]) -> Any:
        """The epoch loop of :meth:`run_epochs` over any ``round_fn``."""
        if num_epochs < start_epoch:
            raise ValueError(f"num_epochs {num_epochs} < start_epoch {start_epoch}")
        chunks = int(chunks_per_epoch)
        if chunks < 1:
            raise ValueError(f"chunks_per_epoch must be >= 1, got {chunks}")
        before = after = ()
        if callbacks:
            from repro_torch.tune.callback import CallbackEnv, split_callbacks
            before, after = split_callbacks(callbacks)
        last_saved = None
        rows = None
        done = num_epochs
        for e in range(start_epoch, num_epochs):
            if before:
                swaps, stopped = self._fire(before, CallbackEnv(
                    epoch=e, begin_epoch=start_epoch, end_epoch=num_epochs,
                    round=e * chunks, state=state))
                if stopped:
                    done = e
                    break
                state = swaps.get("state", state)
            state, rows = self._window_rounds(stream, state, round_fn, e, chunks)
            done = e + 1
            stopped = False
            if after:
                evals = tuple(eval_fn(state, done)) if eval_fn else ()
                swaps, stopped = self._fire(after, CallbackEnv(
                    epoch=done, begin_epoch=start_epoch, end_epoch=num_epochs,
                    round=done * chunks, state=state, evals=evals))
                state = swaps.get("state", state)
            if checkpoint is not None and done % checkpoint.every_epochs == 0:
                self._save_snapshot(checkpoint, stream, state, done, chunks,
                                    rng, rows=rows)
                last_saved = done
            if stopped:
                break
        if checkpoint is not None and last_saved != done:
            self._save_snapshot(checkpoint, stream, state, done, chunks, rng,
                                rows=rows)
        return state

    def _window_rounds(self, stream: Iterator, state: Any, round_fn: RoundFn,
                       epoch: int, chunks: int) -> tuple:
        """Epoch ``epoch`` over the stream's next window: ``chunks`` rounds,
        round ``r`` on chunk ``r % chunks`` of every partition (a view).
        Returns ``(state, global rows of the window)``."""
        batch = next(stream)
        window = batch["data"] if isinstance(batch, dict) else batch
        self._check_window(window, chunks)
        blocks = pt.partition_rows(window, self.local_shards)
        cr = blocks.shape[1] // chunks
        for r in range(epoch * chunks, (epoch + 1) * chunks):
            c = r % chunks
            state = round_fn(blocks[:, c * cr:(c + 1) * cr], state, r)
        return state, int(window.shape[0]) * self.num_hosts

    def _save_snapshot(self, policy: CheckpointPolicy, stream: Any, state: Any,
                       epoch: int, chunks: int, rng: Optional[torch.Tensor], *,
                       rows: Optional[int] = None,
                       extra_meta: Optional[dict] = None) -> None:
        if self.mesh is not None:
            # one writer per global mesh: every host holds the same combined
            # state, host 0 persists it (a shared filesystem); every host
            # returns once it is published, so a resume that follows on any
            # host reads it
            if self.mesh.host_id == 0:
                self._write_snapshot(policy, stream, state, epoch, chunks, rng,
                                     rows, extra_meta)
            coll.barrier(self.mesh)
            return
        self._write_snapshot(policy, stream, state, epoch, chunks, rng, rows,
                             extra_meta)

    def _write_snapshot(self, policy: CheckpointPolicy, stream: Any, state: Any,
                        epoch: int, chunks: int, rng: Optional[torch.Tensor],
                        rows: Optional[int], extra_meta: Optional[dict]) -> None:
        from repro_torch.checkpoint.store import save_checkpoint

        stream_step = getattr(stream, "step", None)
        if stream_step is None:
            raise TypeError(
                "checkpointing requires a stream exposing its position as "
                ".step (a BatchIterator) — resume could not replay an "
                "unpositioned stream")
        meta = {
            "epoch": epoch,
            "stream_step": int(stream_step),
            "rng": None if rng is None else torch.as_tensor(rng).tolist(),
            "chunks_per_epoch": chunks,
            "schedule": self.schedule.value,
            "num_shards": self.num_shards,
            "num_hosts": self.num_hosts,
            "rows_per_epoch": rows,
            "every_epochs": policy.every_epochs,
            "keep": policy.keep,
            "wrapped": policy.extra_state is not None,
        }
        tree = state
        if policy.extra_state is not None:
            # one atomic unit: the training carry plus the caller's extra
            # state (e.g. a pipeline's fitted featurizer statistics)
            tree = {"state": state, "extra": policy.extra_state}
        if extra_meta:
            meta.update(extra_meta)
        if policy.extra_metadata is not None:
            meta["extra"] = policy.extra_metadata
        save_checkpoint(policy.ckpt_dir, epoch, tree, metadata=meta,
                        keep=policy.keep)

    def resume(self, ckpt_dir: str, stream: Any, init_state: Any,
               local_step: LocalStep, num_epochs: int, *,
               combine: str = "mean", update: Optional[UpdateFn] = None,
               chunks_per_epoch: Optional[int] = None,
               checkpoint: Optional[CheckpointPolicy] = None,
               step: Optional[int] = None,
               allow_resize: bool = False) -> Any:
        """Restart a killed :meth:`run_epochs` run from its newest (or
        ``step``-selected) checkpoint and continue to ``num_epochs``.

        ``init_state`` is only the structure template for the restore; the
        state comes back on the stream's device.  The stream is
        fast-forwarded with ``seek`` to the checkpointed position, the rng
        key restored, and the chunk layout, schedule and shard count
        cross-checked against the snapshot, so a mismatched relaunch fails
        loudly instead of silently diverging.  On the same device the
        resumed run repeats the same launches on the same values, so the
        final state equals an uninterrupted run's bit for bit.  A snapshot
        written by the reference's runner resumes here, and the other way
        round: the file format and the metadata are the reference's.

        ``allow_resize=True`` is the elastic path: the shard-count check is
        replaced by a :func:`repro_torch.core.partition.plan_resize`
        validation of the snapshot's rows over this runner's partitions, so
        a mesh of another world size (or emulated partitions) picks the run
        up from the same snapshot.  The state tree is layout-free (every
        combine leaves it whole), so only the windows' partitioning
        changes."""
        from repro_torch.checkpoint.store import load_metadata, \
            restore_with_metadata

        device = self._state_device(stream, init_state)
        peek = load_metadata(ckpt_dir, step) or {}
        wrapped = bool(peek.get("wrapped"))
        template = init_state
        if wrapped:
            if checkpoint is None or checkpoint.extra_state is None:
                raise ValueError(
                    f"checkpoint under {ckpt_dir} carries extra (pipeline) "
                    f"state — resume needs the CheckpointPolicy with an "
                    f"extra_state template to restore it atomically")
            template = {"state": init_state, "extra": checkpoint.extra_state}
        state, ck_step, meta = restore_with_metadata(ckpt_dir, template, step,
                                                     device=device)
        if wrapped:
            # hand the restored extra tree back through the policy (and keep
            # re-saving it with every later snapshot)
            checkpoint.extra_state = state["extra"]
            state = state["state"]
        if meta is None:
            raise ValueError(
                f"checkpoint step {ck_step} under {ckpt_dir} carries no "
                f"resume metadata — was it written by run_epochs?")
        for name, have in (("schedule", self.schedule.value),
                           ("num_shards", self.num_shards)):
            want = meta.get(name)
            if want is None or want == have:
                continue
            if name == "num_shards" and allow_resize:
                rows = meta.get("rows_per_epoch")
                if rows:
                    # raises before any state is used when the rows cannot
                    # split evenly over the surviving partitions
                    pt.plan_resize(int(rows), int(want), int(have))
                continue
            raise ValueError(
                f"cannot resume: checkpoint was written with "
                f"{name}={want!r} but this runner has {name}={have!r}"
                + ("" if name != "num_shards" else
                   " (pass allow_resize=True to repartition onto the "
                   "surviving mesh)"))
        chunks = int(meta.get("chunks_per_epoch", 1))
        if chunks_per_epoch is not None and chunks_per_epoch != chunks:
            raise ValueError(
                f"cannot resume: checkpoint used chunks_per_epoch={chunks}, "
                f"got {chunks_per_epoch}")
        if not hasattr(stream, "seek"):
            raise TypeError("resume requires a seekable stream "
                            "(BatchIterator or anything with .seek(step))")
        stream.seek(meta["stream_step"])
        rng = (torch.tensor(meta["rng"], dtype=torch.int64)
               if meta.get("rng") is not None else None)
        epoch = int(meta["epoch"])
        if checkpoint is None and meta.get("every_epochs"):
            checkpoint = CheckpointPolicy(ckpt_dir, meta["every_epochs"],
                                          meta.get("keep"))
        if epoch >= num_epochs:
            return state
        return self.run_epochs(stream, state, local_step, num_epochs,
                               combine=combine, update=update,
                               chunks_per_epoch=chunks, checkpoint=checkpoint,
                               rng=rng, start_epoch=epoch)

    def _state_device(self, stream: Any, tree: Any) -> Optional[torch.device]:
        """Where a restored state goes: the stream's device, the mesh's, or
        the template's."""
        device = getattr(stream, "device", None)
        if device is None and self.mesh is not None:
            device = self.mesh.device
        return device or _first_device(tree)

    # ------------------------------------------------------------------ #
    # stale-synchronous parallel lane: independent hosts, bounded clocks
    # ------------------------------------------------------------------ #
    def _ssp_merge(self, entries: Sequence[tuple], combine: str) -> Any:
        """Combine ``[(host_id, tree), ...]`` across hosts in host-id order:
        the trees stacked on a new leading axis and reduced on the device,
        the same arithmetic on every host and in a sequential replay."""
        trees = [t for _, t in sorted(entries, key=lambda kv: kv[0])]
        if combine == "mean":
            return _tree_map(lambda *xs: torch.stack(xs).mean(dim=0), *trees)
        if combine == "sum":
            return _tree_map(lambda *xs: torch.stack(xs).sum(dim=0), *trees)
        raise ValueError(f"SSP lane supports combine='mean'|'sum', "
                         f"got {combine!r}")

    def run_epochs_ssp(self, stream: Iterator, init_state: Any,
                       local_step: LocalStep, num_epochs: int, *,
                       store: Any, staleness: int = 0,
                       combine: str = "mean",
                       update: Optional[UpdateFn] = None,
                       chunks_per_epoch: int = 1,
                       checkpoint: Optional[CheckpointPolicy] = None,
                       rng: Optional[torch.Tensor] = None,
                       start_epoch: int = 0,
                       trace: Optional[list] = None) -> Any:
        """Streaming epochs with **stale-synchronous** cross-host exchange.

        Hosts are independent programs (each with this runner over its own
        partitions) that exchange through a shared
        :class:`repro_torch.core.exchange.ParamStore`.  Each exchange round
        (one epoch) host ``h``:

          1. computes its contribution for round ``e`` and **publishes** it
             (atomic, the checkpoint store's machinery);
          2. **waits** until every live peer has published round ``>= e -
             staleness``;
          3. **reads** each peer's freshest publication capped at its own
             round (:func:`repro_torch.core.collectives.ssp_read_round`) and
             merges in host-id order (:meth:`_ssp_merge`).

        ``staleness=0`` is lock-step BSP: every host merges the same entries
        in the same order, bitwise a sequential replay of the hosts.

        ``"mean"``: the contribution is the host's post-epoch state (its
        ``chunks_per_epoch`` rounds, combined over its own partitions); the
        merge averages states.  ``"sum"`` + ``update``: the contribution is
        the host's statistics for the round (combined over its partitions);
        the merge sums them and ``update`` rebuilds the state; this needs
        ``chunks_per_epoch == 1``.

        Departed peers (``store.mark_left()``) are dropped once their last
        in-bound contribution ages out.  ``trace`` receives one ``{"epoch",
        "reads", "wait_seconds"}`` record per round.  Checkpoints are per
        host (its own directory; ``staleness`` and the store's world in the
        metadata); :meth:`resume_ssp` restarts a killed host against the
        same store."""
        import time

        if num_epochs < start_epoch:
            raise ValueError(f"num_epochs {num_epochs} < start_epoch {start_epoch}")
        staleness = int(staleness)
        if staleness < 0:
            raise ValueError(f"staleness must be >= 0, got {staleness}")
        chunks = int(chunks_per_epoch)
        if chunks < 1:
            raise ValueError(f"chunks_per_epoch must be >= 1, got {chunks}")
        stats_lane = combine == "sum"
        if stats_lane:
            if update is None:
                raise ValueError(
                    "SSP combine='sum' is the sufficient-statistics lane — "
                    "it needs an update(state, merged_stats, r) to rebuild "
                    "the state from the cross-host sum")
            if chunks != 1:
                raise ValueError(
                    "SSP combine='sum' requires chunks_per_epoch=1 so "
                    "exchange rounds and algorithm rounds coincide")
            round_fn = lambda blocks, state, r: self._combine(  # noqa: E731
                local_step(blocks, state, r), "sum")
        elif combine == "mean":
            round_fn = self._round_fn(local_step, update, combine)
        else:
            raise ValueError(f"SSP lane supports combine='mean'|'sum', "
                             f"got {combine!r}")
        ssp_meta = {"staleness": staleness, "ssp_hosts": store.num_hosts,
                    "ssp_host_id": store.host_id}
        state = init_state
        rows = None
        last_saved = None
        for e in range(start_epoch, num_epochs):
            mine, rows = self._window_rounds(stream, state, round_fn, e, chunks)
            store.publish(e, mine)
            entries = [(store.host_id, mine)]
            reads = {}
            waited = 0.0
            # every other host, departed ones too: a departed peer's
            # publishes within the bound are read whenever this host gets
            # here, so what it reads does not race the peer's departure
            for p in (h for h in range(store.num_hosts) if h != store.host_id):
                t0 = time.monotonic()
                clock = store.wait_clock(p, e - staleness + 1)
                waited += time.monotonic() - t0
                if clock <= e - staleness:
                    # a departed peer whose last word is out of bound: it
                    # has aged out of the cohort (in-place shrink)
                    continue
                got = store.read_at_most(p, ssp_read_round(e, clock, staleness), mine)
                if got is None:
                    continue
                entries.append((p, got[0]))
                reads[p] = got[1]
            merged = self._ssp_merge(entries, combine)
            state = update(state, merged, e) if stats_lane else merged
            if trace is not None:
                trace.append({"epoch": e, "reads": reads, "wait_seconds": waited})
            if checkpoint is not None and (e + 1) % checkpoint.every_epochs == 0:
                self._save_snapshot(checkpoint, stream, state, e + 1, chunks, rng,
                                    rows=rows, extra_meta=ssp_meta)
                last_saved = e + 1
        if checkpoint is not None and last_saved != num_epochs:
            self._save_snapshot(checkpoint, stream, state, num_epochs, chunks,
                                rng, rows=rows, extra_meta=ssp_meta)
        return state

    def resume_ssp(self, ckpt_dir: str, stream: Any, init_state: Any,
                   local_step: LocalStep, num_epochs: int, *,
                   store: Any, staleness: Optional[int] = None,
                   combine: str = "mean", update: Optional[UpdateFn] = None,
                   checkpoint: Optional[CheckpointPolicy] = None,
                   step: Optional[int] = None,
                   trace: Optional[list] = None) -> Any:
        """Restart one killed SSP host from its own checkpoint and rejoin
        the cohort on the same store.  Peers' publications survive on disk,
        so the host replays from its snapshot (the same launches on the same
        values) and re-publishes the rounds it had shared, byte for byte.
        ``staleness`` defaults to the checkpointed value."""
        from repro_torch.checkpoint.store import restore_with_metadata

        state, ck_step, meta = restore_with_metadata(
            ckpt_dir, init_state, step,
            device=self._state_device(stream, init_state))
        if meta is None:
            raise ValueError(
                f"checkpoint step {ck_step} under {ckpt_dir} carries no "
                f"resume metadata — was it written by run_epochs_ssp?")
        if staleness is None:
            staleness = int(meta.get("staleness", 0))
        chunks = int(meta.get("chunks_per_epoch", 1))
        if not hasattr(stream, "seek"):
            raise TypeError("resume requires a seekable stream "
                            "(BatchIterator or anything with .seek(step))")
        stream.seek(meta["stream_step"])
        rng = (torch.tensor(meta["rng"], dtype=torch.int64)
               if meta.get("rng") is not None else None)
        epoch = int(meta["epoch"])
        if checkpoint is None and meta.get("every_epochs"):
            checkpoint = CheckpointPolicy(ckpt_dir, meta["every_epochs"],
                                          meta.get("keep"))
        if epoch >= num_epochs:
            return state
        return self.run_epochs_ssp(
            stream, state, local_step, num_epochs, store=store,
            staleness=staleness, combine=combine, update=update,
            chunks_per_epoch=chunks, checkpoint=checkpoint, rng=rng,
            start_epoch=epoch, trace=trace)

    # ------------------------------------------------------------------ #
    # stacked trials: K models a round (model search; repro_torch.tune)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _stacked_carry(trial_states: Any, trial_hyper: Any,
                       active: Any = None, offsets: Any = None) -> dict:
        """The carry of a stacked run: ``trial`` (a private copy; every leaf
        has a leading (K, …) axis), ``hyper`` (per-trial hyperparameters,
        leading (K,)), ``active`` (the (K,) bool mask early stopping freezes
        lanes with) and ``offset`` (lane j sees trial-local round ``r -
        offset[j]``, so a trial admitted into a freed slot mid-search trains
        on the round indices of a solo run from round 0).  ``active`` and
        ``offset`` are CPU tensors, the reference's carry keys."""
        leaves = _tree_leaves(trial_states)
        if not leaves:
            raise ValueError("trial_states must have at least one array leaf")
        k = leaves[0].shape[0]
        for leaf in leaves + _tree_leaves(trial_hyper):
            if tuple(leaf.shape[:1]) != (k,):
                raise ValueError(
                    f"every stacked leaf needs leading trial axis {k}, got "
                    f"shape {tuple(leaf.shape)}")
        act = (torch.ones((k,), dtype=torch.bool) if active is None
               else _host(active, torch.bool))
        offs = (torch.zeros((k,), dtype=torch.int32) if offsets is None
                else _host(offsets, torch.int32))
        if tuple(offs.shape) != (k,):
            raise ValueError(
                f"round offsets must be shape ({k},), got {tuple(offs.shape)}")
        return {"trial": _own(trial_states), "hyper": trial_hyper,
                "active": act, "offset": offs}

    def _stacked_fns(self, trial_step: TrialStep,
                     trial_update: Optional[TrialUpdateFn],
                     combine: str) -> RoundFn:
        """The round of a stacked carry, lane by lane: each active lane j
        runs ``trial_step`` on its own state and hyperparameters at round
        ``r - offset[j]``, its combine (across the hosts, on a mesh) and its
        update — the launches of the trial run alone — and
        :func:`_mask_tree` writes the lanes back."""
        def round_fn(blocks: torch.Tensor, carry: dict, r: int) -> dict:
            trial, hyper = carry["trial"], carry["hyper"]
            active, offs = carry["active"].tolist(), carry["offset"].tolist()
            new = {}
            for j, on in enumerate(active):
                if not on:
                    continue
                s = _tree_map(lambda x: x[j], trial)
                h = _tree_map(lambda x: x[j], hyper)
                rj = r - offs[j]
                combined = self._combine(trial_step(blocks, s, rj, h), combine)
                new[j] = (combined if trial_update is None
                          else trial_update(s, combined, rj, h))
            _mask_tree(active, new, trial)
            return carry

        return round_fn

    def run_stacked_rounds(self, table: Any, trial_states: Any,
                           trial_hyper: Any, trial_step: TrialStep,
                           num_rounds: int, *, combine: str = "mean",
                           update: Optional[TrialUpdateFn] = None,
                           active: Any = None, start_round: int = 0) -> Any:
        """Advance K stacked trials together over a resident table.

        ``trial_states`` is a tree whose every leaf carries a leading (K, …)
        trial axis (:func:`repro_torch.tune.trials.tree_stack`);
        ``trial_hyper`` holds the per-trial hyperparameters as (K,) leaves.
        ``trial_step(blocks, state, r, hyper)`` and ``update(state,
        combined, r, hyper)`` describe ONE trial.  ``active`` freezes the
        lanes it marks False.  Returns the final stacked states (new
        tensors; the inputs are not changed)."""
        carry = self._stacked_carry(trial_states, trial_hyper, active)
        out = self._rounds(table, carry, self._stacked_fns(trial_step, update, combine),
                           num_rounds, start_round)
        return out["trial"]

    def run_stacked_epochs(self, stream: Iterator, trial_states: Any,
                           trial_hyper: Any, trial_step: TrialStep,
                           num_epochs: int, *, combine: str = "mean",
                           update: Optional[TrialUpdateFn] = None,
                           active: Any = None,
                           chunks_per_epoch: int = 1,
                           checkpoint: Optional[CheckpointPolicy] = None,
                           rng: Optional[torch.Tensor] = None,
                           start_epoch: int = 0,
                           round_offsets: Any = None,
                           callbacks: Sequence[Callable] = (),
                           eval_fn: Optional[Callable] = None) -> Any:
        """Streaming twin of :meth:`run_stacked_rounds`: every epoch pulls
        ONE window from ``stream``, shared by all K lanes (one copy to the
        card and one chunk view a round for the whole stack), through the
        epoch loop of :meth:`run_epochs` — so a stacked run checkpoints the
        reference's carry (``trial``, ``hyper``, ``active``, ``offset``).

        ``round_offsets`` (K,) gives each lane a private round origin; they
        must be multiples of ``chunks_per_epoch`` so the chunk phase ``r %
        chunks`` is a solo run's.  ``callbacks`` / ``eval_fn`` are
        :meth:`run_epochs`' hooks at the trial level: an env's ``state`` is
        the stacked (K, …) tree, with ``hyper`` and a host copy of
        ``active``; a ``{"state"|"hyper"|"active": ...}`` return swaps that
        component.  ``eval_fn(trial_states, epoch)`` returns the boundary's
        ``EvalEntry`` list.  Returns the final stacked states."""
        carry = self._stacked_carry(trial_states, trial_hyper, active,
                                    round_offsets)
        run_eval = None
        if eval_fn is not None:
            run_eval = lambda carry, epoch: eval_fn(carry["trial"], epoch)  # noqa: E731
        out = self._epochs(stream, carry, self._stacked_fns(trial_step, update, combine),
                           num_epochs, chunks_per_epoch=chunks_per_epoch,
                           checkpoint=checkpoint, rng=rng, start_epoch=start_epoch,
                           callbacks=[_stacked_callback_shim(cb) for cb in callbacks],
                           eval_fn=run_eval)
        return out["trial"]
