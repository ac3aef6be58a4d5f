"""Queue-depth-driven replica autoscaling (counterpart:
``src/repro/serve/autoscaler.py``, copied: the module is plain Python).

The policy half of fleet elasticity (the mechanism — activating and
draining lane groups on the shared cache — lives in
:class:`repro_torch.serve.router.ReplicaRouter`).  The shape of the policy
follows ``tune.AshaScheduler``'s slot backfilling: capacity chases demand
*eagerly upward* (a queue that outruns the active slots gets every replica
it needs in one tick, exactly like ASHA backfilling freed trial slots
from the promotion queue), but *reluctantly downward* — scale-down
requires ``hysteresis`` consecutive low-demand ticks, because dropping a
replica costs a drain and a likely re-spin when the next burst lands.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

__all__ = ["QueueAutoscaler"]


@dataclasses.dataclass
class QueueAutoscaler:
    """Maps observed demand to a target replica count.

    ``tick(queued, busy, active, now)`` returns the new target in
    ``[min_replicas, max_replicas]``:

      * **up** (immediate): while ``queued`` exceeds ``up_threshold`` ×
        the free slot capacity of the target fleet, add replicas — a
        single deep-queue tick can spin the whole fleet.
      * **down** (hysteresis): when total demand (busy + queued) fits in
        ``down_threshold`` × the capacity of one-fewer replicas for
        ``hysteresis`` consecutive ticks, drop one replica and restart
        the count.  Any non-low tick resets the streak.
    """

    slots_per_replica: int
    min_replicas: int = 1
    max_replicas: int = 4
    up_threshold: float = 1.0      # queued > thr × free capacity → grow
    down_threshold: float = 0.5    # demand ≤ thr × shrunk capacity → streak
    hysteresis: int = 3            # consecutive low ticks before shrinking
    events: List[Tuple[float, str, int]] = dataclasses.field(
        default_factory=list)      # (now, "up"|"down", new_target)
    _low_streak: int = 0

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"need 1 <= min {self.min_replicas} <= max {self.max_replicas}")
        if self.slots_per_replica < 1:
            raise ValueError("slots_per_replica must be >= 1")
        if self.hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")

    def tick(self, queued: int, busy: int, active: int, now: float = 0.0) -> int:
        target = max(self.min_replicas, min(active, self.max_replicas))
        spr = self.slots_per_replica

        grew = False
        while (target < self.max_replicas
               and queued > self.up_threshold * max(target * spr - busy, 0)):
            target += 1
            grew = True
        if grew:
            self._low_streak = 0
            self.events.append((now, "up", target))
            return target

        demand = busy + queued
        if (target > self.min_replicas
                and demand <= self.down_threshold * (target - 1) * spr):
            self._low_streak += 1
            if self._low_streak >= self.hysteresis:
                target -= 1
                self._low_streak = 0
                self.events.append((now, "down", target))
        else:
            self._low_streak = 0
        return target
