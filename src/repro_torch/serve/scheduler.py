"""Continuous-batching admission scheduler (counterpart:
``src/repro/serve/scheduler.py``, copied: the module is numpy-only).

The host-side half of the serving stack (the device half is
``serve/engine.py``): a request queue plus a fixed table of decode
*slots*.  The engine asks the scheduler, between decode steps, which
requests to admit into free slots (**backfill** — a retirement mid-decode
frees a slot and the next queued request takes it without draining the
batch) and tells it when a slot retires.  The scheduler never touches
device state; it owns arrival release, admission order, and the
queue-depth / latency accounting the launcher reports.

Admission order is a :class:`FairQueue`: *priority classes* (lower number
= more urgent, strict between classes) and, within a class, weighted
fair queuing across *tenants* via stride scheduling — each tenant pays
``1/weight`` virtual time per admission, and the tenant with the least
virtual time goes next, so a tenant flooding the queue cannot starve the
others beyond its weight share.  With a single tenant and a single class
this degenerates *exactly* to a plain ``(arrival, seq)`` FIFO (the
burst-release regression tests pin this).

Petuum (Xing et al., 2013) is the precedent this layer follows: a real
scheduler between the request stream and the device work is what turns a
fixed-batch decoder into a serving system.  See ``docs/architecture.md``
(serving section).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Request", "FairQueue", "SlotScheduler", "tenant_report"]


@dataclasses.dataclass
class Request:
    """One generation request: a prompt plus decode limits.

    The streaming unit of the paper's Model contract (§III-C): where the
    paper's ``Model.predict`` maps one feature vector to one prediction,
    serving maps one ``Request`` to a token stream.  ``out_tokens`` is
    filled in place by the engine; ``done`` flips when the request retires
    (EOS or ``max_new_tokens``).  ``arrival`` is the request's release time
    on the launcher's clock (0 = available immediately); the ``*_at``
    fields are stamped by the scheduler for the latency report.
    """

    prompt: np.ndarray                 # (S,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    arrival: float = 0.0
    # multi-tenant serving: who sent it, how urgent, and the
    # end-to-end deadline the router's admission control enforces
    tenant: str = "default"
    priority: int = 1                  # class; lower = more urgent (strict)
    slo_ms: Optional[float] = None     # arrival→finish deadline, milliseconds
    # router-stamped admission outcome
    rejected: bool = False             # refused at admission (SLO hopeless)
    degraded: bool = False             # admitted with max_new_tokens halved
    # scheduler-stamped accounting
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None
    # engine-stamped at admission: prompt tokens whose KV entries came out
    # of the radix prefix cache instead of prefill (serve/prefix_cache.py)
    cached_prefill: int = 0
    # monotone submission sequence stamped by SlotScheduler.submit — the
    # FIFO tiebreak for equal arrival times
    seq: int = -1


class FairQueue:
    """Priority classes over weighted per-tenant FIFOs (stride scheduling).

    ``push`` appends to the ``(priority, tenant)`` FIFO; ``pop`` serves the
    most urgent non-empty class and, within it, the tenant with the least
    *virtual time*, charging the winner ``1/weight``.  A tenant whose lane
    went idle re-enters at the class's minimum active virtual time (the
    standard stride re-entry rule), so idling never banks credit for a
    later burst.  Ties — including the everyone-at-zero start — break on
    the head request's ``(arrival, seq)``, which makes the single-tenant
    single-class case *identical* to a plain arrival-FIFO deque.
    """

    def __init__(self, weights: Optional[Dict[str, float]] = None):
        self._weights = dict(weights or {})
        # priority → tenant → FIFO of released requests
        self._classes: Dict[int, Dict[str, Deque[Request]]] = {}
        self._vt: Dict[Tuple[int, str], float] = {}
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        """Queued requests in an unspecified order (accounting only)."""
        for tenants in self._classes.values():
            for q in tenants.values():
                yield from q

    def push(self, req: Request) -> None:
        tenants = self._classes.setdefault(req.priority, {})
        q = tenants.setdefault(req.tenant, deque())
        if not q:  # lane was idle: re-enter at the class's active minimum
            active = [self._vt.get((req.priority, t), 0.0)
                      for t, d in tenants.items() if d]
            floor = min(active) if active else 0.0
            key = (req.priority, req.tenant)
            self._vt[key] = max(self._vt.get(key, 0.0), floor)
        q.append(req)
        self._len += 1

    def pop(self) -> Request:
        if not self._len:
            raise IndexError("pop from empty FairQueue")
        prio = min(p for p, ts in self._classes.items()
                   if any(ts.values()))
        tenants = self._classes[prio]
        best = min(
            (t for t, d in tenants.items() if d),
            key=lambda t: (self._vt.get((prio, t), 0.0),
                           tenants[t][0].arrival, tenants[t][0].seq))
        req = tenants[best].popleft()
        self._vt[(prio, best)] = (self._vt.get((prio, best), 0.0)
                                  + 1.0 / self._weights.get(best, 1.0))
        self._len -= 1
        return req


class SlotScheduler:
    """Fair queue + slot table with mid-decode backfill.

    Protocol (driven by the engine loop):

        sched.submit(req)                  # any time; respects req.arrival
        while sched.has_work():
            for slot, req in sched.admit(now):   # fills every free slot
                ... prefill req into slot ...
            ... one fused decode step ...
            sched.retire(slot, now)        # when a request finishes

    ``admit`` releases arrivals whose ``arrival <= now``, then fills free
    slots in fair-queue order (plain arrival-FIFO when every request shares
    one tenant and one priority class).  Admissions that land while other
    slots are mid-decode are counted as ``backfills`` — the statistic that
    distinguishes continuous batching from static batching (a static
    engine's count is always 0).  ``tenant_weights`` sets the per-tenant
    fair-queue weights (absent tenants weigh 1.0).
    """

    def __init__(self, num_slots: int,
                 tenant_weights: Optional[Dict[str, float]] = None):
        if num_slots < 1:
            raise ValueError("need at least one slot")
        self.num_slots = int(num_slots)
        self.slots: List[Optional[Request]] = [None] * self.num_slots
        self._pending: Deque[Request] = deque()   # not yet arrived
        self._queue = FairQueue(tenant_weights)   # arrived, awaiting a slot
        # accounting
        self.submitted = 0
        self.admitted = 0
        self.retired = 0
        self.backfills = 0
        # queue-depth running aggregates (one sample per admit call — i.e.
        # per decode step; a raw sample list would grow one entry per
        # generated token for the scheduler's lifetime)
        self._depth_max = 0
        self._depth_sum = 0
        self._depth_samples = 0
        self._finished: List[Request] = []

    # ------------------------------------------------------------------ #
    # queue side
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        """Add one request; it becomes admissible once ``now >= arrival``.
        Admission is in arrival order; submission order breaks ties within
        equal arrival times."""
        req.seq = self.submitted
        self.submitted += 1
        self._pending.append(req)

    def release(self, now: float) -> None:
        """Move arrived requests from pending into the admission queue, in
        ``(arrival, seq)`` order.  Iterating pending in submission order
        would let a later-arriving request jump an earlier-arriving one
        released in the same call (burst traces submit out of arrival
        order); sorting restores arrival-FIFO, with the submit sequence as
        a stable tiebreak for equal arrivals."""
        still = deque()
        ready = []
        for r in self._pending:
            (ready if r.arrival <= now else still).append(r)
        ready.sort(key=lambda r: (r.arrival, r.seq))
        for r in ready:
            self._queue.push(r)
        self._pending = still

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival time still pending (None when all released)."""
        return min((r.arrival for r in self._pending), default=None)

    # ------------------------------------------------------------------ #
    # slot side
    # ------------------------------------------------------------------ #
    @property
    def busy(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def queued(self) -> int:
        return len(self._queue) + len(self._pending)

    def queued_tokens(self) -> int:
        """Generation tokens still owed by queued + pending requests — the
        work-ahead measure the router's SLO admission predictor scales by
        (a queue of 1-token requests is not a queue of 512-token ones)."""
        return (sum(r.max_new_tokens for r in self._queue)
                + sum(r.max_new_tokens for r in self._pending))

    def has_work(self) -> bool:
        return bool(self._queue or self._pending or self.busy)

    def admit(self, now: float = 0.0) -> List[Tuple[int, Request]]:
        """Fill every free slot from the queue (fair-queue order); returns
        the (slot, request) pairs admitted this call and stamps their wait."""
        self.release(now)
        mid_decode = self.busy > 0
        admits: List[Tuple[int, Request]] = []
        for slot in range(self.num_slots):
            if self.slots[slot] is not None or not self._queue:
                continue
            req = self._queue.pop()
            req.admitted_at = now
            self.slots[slot] = req
            admits.append((slot, req))
            self.admitted += 1
            if mid_decode:
                self.backfills += 1
        depth = len(self._queue)
        self._depth_max = max(self._depth_max, depth)
        self._depth_sum += depth
        self._depth_samples += 1
        return admits

    def retire(self, slot: int, now: float = 0.0) -> Request:
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is already free")
        req.done = True
        req.finished_at = now
        self.slots[slot] = None
        self.retired += 1
        self._finished.append(req)
        return req

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def report(self) -> dict:
        """Queue/latency summary for the launcher (all times on the clock
        the engine passed to ``admit``/``retire``).  ``finished`` is the
        sample count behind the percentiles — ``_pct`` maps an empty list
        to 0.0, so any latency bar MUST also require ``finished > 0`` (the
        nightly ``--check`` does) or an engine that served nothing passes
        with vacuously perfect latency."""
        waits = [r.admitted_at - r.arrival
                 for r in self._finished if r.admitted_at is not None]
        totals = [r.finished_at - r.arrival
                  for r in self._finished if r.finished_at is not None]
        return {
            "submitted": self.submitted,
            "admitted": self.admitted,
            "retired": self.retired,
            "finished": len(self._finished),
            "backfills": self.backfills,
            "queue_depth_max": self._depth_max,
            "queue_depth_mean": (self._depth_sum / self._depth_samples
                                 if self._depth_samples else 0.0),
            "wait_p50": _pct(waits, 50),
            "wait_p95": _pct(waits, 95),
            "wait_p99": _pct(waits, 99),
            "latency_p50": _pct(totals, 50),
            "latency_p95": _pct(totals, 95),
            "latency_p99": _pct(totals, 99),
            "tenants": tenant_report(self._finished),
        }


def tenant_report(requests: List[Request]) -> Dict[str, dict]:
    """Per-tenant outcome rollup over any request population (a scheduler's
    finished list, or the router's full stream including rejections).

    SLO attainment counts every request that *carries* an SLO — rejected
    ones count as misses, so shedding load can't inflate the metric.
    Requests without an SLO are excluded (attainment is 1.0 when no SLO
    was ever set)."""
    out: Dict[str, dict] = {}
    for r in requests:
        t = out.setdefault(r.tenant, {
            "finished": 0, "rejected": 0, "degraded": 0,
            "prefill_tokens": 0, "cached_prefill_tokens": 0,
            "slo_total": 0, "slo_attained": 0, "_lat": []})
        if r.rejected:
            t["rejected"] += 1
        elif r.done:
            t["finished"] += 1
            if r.degraded:
                t["degraded"] += 1
            # per-tenant prefix-cache accounting (0/0 → hit rate 0.0 when
            # no prefix cache is configured)
            t["prefill_tokens"] += len(r.prompt)
            t["cached_prefill_tokens"] += r.cached_prefill
            if r.finished_at is not None:
                t["_lat"].append(r.finished_at - r.arrival)
        if r.slo_ms is not None:
            t["slo_total"] += 1
            if (not r.rejected and r.done and r.finished_at is not None
                    and (r.finished_at - r.arrival) * 1e3 <= r.slo_ms):
                t["slo_attained"] += 1
    for t in out.values():
        lat = t.pop("_lat")
        t["latency_p50"] = _pct(lat, 50)
        t["latency_p99"] = _pct(lat, 99)
        t["slo_attainment"] = (t["slo_attained"] / t["slo_total"]
                               if t["slo_total"] else 1.0)
        t["prefix_hit_rate"] = (t["cached_prefill_tokens"]
                                / t["prefill_tokens"]
                                if t["prefill_tokens"] else 0.0)
    return out


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(xs, q)) if xs else 0.0
