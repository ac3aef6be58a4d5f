"""Collective schedules for the per-round global combine (paper §IV-A).

Counterpart: ``src/repro/core/collectives.py`` (``CollectiveSchedule``).

The schedule is the wire pattern of the combine: Spark's gather+broadcast,
Vowpal Wabbit's allreduce tree, or the two-phase reduce-scatter.  The port
runs emulated partitions on one device only (mesh mode over
``torch.distributed`` is a later slice), and there every schedule is the
same local reduction — exactly as the reference's ``_emulated_combine``
(``src/repro/core/runner.py``) ignores it.  The knob and its validation are
kept so that hyperparameters, CLI flags and JSON payloads carry over.
"""
from __future__ import annotations

import enum
from typing import Union

__all__ = ["CollectiveSchedule"]


class CollectiveSchedule(enum.Enum):
    """Wire schedule for the per-round global combine (paper §IV-A).

    Members:
      * ``ALLREDUCE`` — VW's reduction tree; O(d) bytes per device.
      * ``GATHER_BROADCAST`` — MLI/Spark's gather-to-master + broadcast;
        O(N·d) bytes per device.
      * ``REDUCE_SCATTER`` — beyond-paper two-phase reduce-scatter +
        all-gather.

    All members produce the same result; in emulated mode they run the
    same arithmetic.
    """

    ALLREDUCE = "allreduce"
    GATHER_BROADCAST = "gather_broadcast"
    REDUCE_SCATTER = "reduce_scatter"

    @classmethod
    def parse(cls, v: Union[str, "CollectiveSchedule"]) -> "CollectiveSchedule":
        """Accept either a member or its lowercase string value; anything
        else raises ``ValueError: '<v>' is not a valid CollectiveSchedule``."""
        return v if isinstance(v, cls) else cls(str(v).lower())
