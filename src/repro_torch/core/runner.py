"""DistributedRunner — the shared execution layer, emulated mode.

Counterpart: ``src/repro/core/runner.py`` (``partition_apply``,
``run_once``, ``run_rounds``, ``_emulated_combine``, and the streaming
mode: ``CheckpointPolicy``, ``run_epochs``, ``_save_snapshot``, ``resume``
and ``_check_window``).

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
Python loop.  Partitions are emulated on the table's device, so the combine
is the local reduction of each collective and the schedule does not change
the arithmetic.

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

Not ported yet: mesh mode, the epochs' ``callbacks`` and ``eval_fn``
(with ``tune/callback.py``), ``allow_resize`` and the stale-synchronous
lane (``run_epochs_ssp``, ``resume_ssp``), and stacked trials; the
signatures leave those arguments out.  ``epoch_fn`` has no twin: there is
no compiled epoch to cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional, Sequence, Union

import torch

from repro_torch.core import partition as pt
from repro_torch.core.collectives import CollectiveSchedule

__all__ = ["CheckpointPolicy", "DistributedRunner"]

# local_step(blocks (P, rows, cols), state, round_index) -> (P, ...) partials
LocalStep = Callable[[torch.Tensor, Any, int], torch.Tensor]
# update(state, combined, round_index) -> next state (defaults to `combined`)
UpdateFn = Callable[[Any, torch.Tensor, int], Any]


def _emulated_combine(stacked: torch.Tensor, combine: str) -> torch.Tensor:
    """Combine a (shards, ...) stack without a mesh — the local form of
    each collective."""
    if combine == "mean":
        return stacked.mean(dim=0)
    if combine == "sum":
        return stacked.sum(dim=0)
    if combine == "concat":
        return pt.unpartition_rows(stacked)
    raise ValueError(f"unknown combine {combine!r}")


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

    ``num_shards`` is the emulated partition count; ``schedule`` the
    :class:`CollectiveSchedule` of every global combine.
    """

    num_shards: int = 1
    schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE

    def __post_init__(self) -> None:
        self.schedule = CollectiveSchedule.parse(self.schedule)
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")

    @classmethod
    def for_table(cls, table: Any,
                  schedule: Union[str, CollectiveSchedule] = CollectiveSchedule.ALLREDUCE
                  ) -> "DistributedRunner":
        """A runner matching a table's partition layout."""
        return cls(num_shards=table.num_shards, schedule=schedule)

    def partition_apply(self, data: torch.Tensor, fn: Callable,
                        broadcast: Sequence[Any] = (),
                        combine: Optional[str] = None) -> torch.Tensor:
        """Run ``fn(blocks, *broadcast)`` once over the ``(num_shards,
        rows, ...)`` view of ``data``.  ``combine=None`` returns the stacked
        per-partition results; ``"mean" | "sum" | "concat"`` combines them."""
        out = fn(pt.partition_rows(data, self.num_shards), *broadcast)
        if combine is None:
            return out
        return _emulated_combine(out, combine)

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
        blocks = pt.partition_rows(table.data, self.num_shards)
        state = init_state
        for r in range(start_round, start_round + num_rounds):
            combined = _emulated_combine(local_step(blocks, state, r), combine)
            state = combined if update is None else update(state, combined, r)
        return state

    # ------------------------------------------------------------------ #
    # streaming mode: epochs over minibatch windows (beyond the paper)
    # ------------------------------------------------------------------ #
    def _check_window(self, window: torch.Tensor, chunks_per_epoch: int) -> None:
        pt.check_rows_divisible(window.shape[0], self.num_shards,
                                what="stream partitions")
        per_shard = window.shape[0] // self.num_shards
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
                   start_epoch: int = 0) -> Any:
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
        of ints, as the reference carries its key."""
        if num_epochs < start_epoch:
            raise ValueError(f"num_epochs {num_epochs} < start_epoch {start_epoch}")
        chunks = int(chunks_per_epoch)
        if chunks < 1:
            raise ValueError(f"chunks_per_epoch must be >= 1, got {chunks}")
        state = init_state
        last_saved = None
        rows = None
        done = num_epochs
        for e in range(start_epoch, num_epochs):
            batch = next(stream)
            window = batch["data"] if isinstance(batch, dict) else batch
            self._check_window(window, chunks)
            rows = int(window.shape[0])
            blocks = pt.partition_rows(window, self.num_shards)
            cr = blocks.shape[1] // chunks
            for r in range(e * chunks, (e + 1) * chunks):
                c = r % chunks
                chunk = blocks[:, c * cr:(c + 1) * cr]
                combined = _emulated_combine(local_step(chunk, state, r), combine)
                state = combined if update is None else update(state, combined, r)
            done = e + 1
            if checkpoint is not None and done % checkpoint.every_epochs == 0:
                self._save_snapshot(checkpoint, stream, state, done, chunks,
                                    rng, rows=rows)
                last_saved = done
        if checkpoint is not None and last_saved != done:
            self._save_snapshot(checkpoint, stream, state, done, chunks, rng,
                                rows=rows)
        return state

    def _save_snapshot(self, policy: CheckpointPolicy, stream: Any, state: Any,
                       epoch: int, chunks: int, rng: Optional[torch.Tensor], *,
                       rows: Optional[int] = None) -> None:
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
            "num_hosts": 1,
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
        if policy.extra_metadata is not None:
            meta["extra"] = policy.extra_metadata
        save_checkpoint(policy.ckpt_dir, epoch, tree, metadata=meta,
                        keep=policy.keep)

    def resume(self, ckpt_dir: str, stream: Any, init_state: Any,
               local_step: LocalStep, num_epochs: int, *,
               combine: str = "mean", update: Optional[UpdateFn] = None,
               chunks_per_epoch: Optional[int] = None,
               checkpoint: Optional[CheckpointPolicy] = None,
               step: Optional[int] = None) -> Any:
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
        round: the file format and the metadata are the reference's."""
        from repro_torch.checkpoint.store import load_metadata, \
            restore_with_metadata

        device = getattr(stream, "device", None) or _first_device(init_state)
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
            if want is not None and want != have:
                raise ValueError(
                    f"cannot resume: checkpoint was written with "
                    f"{name}={want!r} but this runner has {name}={have!r}")
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
