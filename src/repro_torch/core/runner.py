"""DistributedRunner — the shared execution layer, emulated mode.

Counterpart: ``src/repro/core/runner.py`` (``partition_apply``,
``run_once``, ``run_rounds`` and ``_emulated_combine``).

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
the arithmetic.  Mesh mode, streaming, checkpoints, SSP and stacked trials
wait for later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Union

import torch

from repro_torch.core import partition as pt
from repro_torch.core.collectives import CollectiveSchedule

__all__ = ["DistributedRunner"]

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
