"""Replica router: a serving fleet on one shared cache (counterpart:
``src/repro/serve/router.py``).

``ReplicaRouter`` turns the single continuous-batching ``ServeEngine``
into N *replicas* with SLO-aware admission and queue-driven autoscale.
A replica is a **contiguous lane group** of ``slots_per_replica`` decode
slots on ONE fleet-sized KV cache (batch = ``max_replicas × slots_per_
replica``), the same stacking trick ``tune.AshaScheduler`` uses for trial
slots: the fleet advances with ONE fused decode step over the active lane
span, so per-step fixed costs (dispatch, host sync, kernel launch) are
paid once for the whole fleet instead of once per replica — that
amortization is the fleet's throughput win and it holds on any backend.
On a mesh the slot axis of the shared cache is exactly the axis
``serve/step.py`` shards, so lane groups map onto devices unchanged.

Per replica there is a full :class:`SlotScheduler` (fair queue + slot
table); the router in front owns three decisions:

  * **dispatch** — each arrival goes to the active replica with the least
    load (busy + queued), after admission control;
  * **admission** — when the request carries a deadline (``slo_ms`` or a
    per-priority-class default), predicted completion = per-generated-token
    EMA service time × (queued-ahead tokens / slots + the request's own
    ``max_new_tokens`` + a weighted tail-prefill length, shortened by the
    prefix cache's matched prefix when one is configured); a hopeless
    request is *rejected* (or *degraded*: ``max_new_tokens`` halved, then
    re-tested) rather than queued to miss.  Normalizing per token is what
    makes a 512-token request predict 256× longer than a 2-token one —
    the raw per-request EMA gave both the same prediction (regression:
    ``tests/test_serve_router.py``).  Until the EMA has warmed
    (3 completions) everything is admitted — the router never sheds load
    it knows nothing about;
  * **elasticity** — a :class:`QueueAutoscaler` maps demand to a target
    replica count each tick.  Scale-up activates the next lane group
    (graph-warm if ``warmup`` ran).  Scale-down *drains*: the highest
    active replica stops receiving dispatches and its lane group
    deactivates once its last slot retires, so the active span stays a
    contiguous prefix of the cache.

Decode on the active span only: the fused step is a decode step over
views of the first ``active × slots_per_replica`` lanes of the shared cache
(batch is axis 1 of every cache leaf — axis 0 is the stacked-periods axis),
written in place (``ServeEngine.decode_span``): no slice copy and no
writeback, where the reference slices, decodes and writes the span back.
On the card each span visited is one CUDA graph, captured at its first
step (``warmup`` visits every span it is given), as the engine's step is.
The greedy argmax runs on the host over the span's logits.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.models.config import ArchConfig
from repro_torch.serve.autoscaler import QueueAutoscaler
from repro_torch.serve.engine import ServeEngine, _argmax, next_pow2
from repro_torch.serve.scheduler import Request, SlotScheduler, _pct, tenant_report

__all__ = ["ReplicaRouter", "PredictorFleet"]


def _now_zero() -> float:
    return 0.0


class ReplicaRouter:
    """N lane-group replicas behind admission control and autoscale."""

    def __init__(self, cfg: ArchConfig, params, *, slots_per_replica: int,
                 max_replicas: int, min_replicas: int = 1,
                 max_seq: int = 2048,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 admission: str = "none",          # "none"|"reject"|"degrade"
                 class_slo_ms: Optional[Dict[int, float]] = None,
                 autoscaler: Optional[QueueAutoscaler] = None,
                 ema_beta: float = 0.8,
                 prefix_cache=None,
                 prefill_weight: float = 0.1,
                 device: DeviceLike = None):
        if admission not in ("none", "reject", "degrade"):
            raise ValueError(f"admission={admission!r}")
        if slots_per_replica < 1 or max_replicas < 1:
            raise ValueError("need >=1 slot per replica and >=1 replica")
        self.spr = int(slots_per_replica)
        self.max_replicas = int(max_replicas)
        self.min_replicas = max(1, min(int(min_replicas), self.max_replicas))
        # one engine ⇒ one cache ⇒ the prefix trie is shared fleet-wide
        # for free: a prefix any replica prefilled is a hit for all lanes
        self.engine = ServeEngine(cfg, params,
                                  batch_size=self.spr * self.max_replicas,
                                  max_seq=max_seq,
                                  prefix_cache=prefix_cache, device=device)
        self.scheds = [SlotScheduler(self.spr, tenant_weights)
                       for _ in range(self.max_replicas)]
        self.admission = admission
        self.class_slo_ms = dict(class_slo_ms or {})
        self.autoscaler = autoscaler
        # no autoscaler → fixed fleet at max
        self.active = self.max_replicas if autoscaler is None else self.min_replicas
        self.rejected: List[Request] = []
        # EMA of service seconds PER GENERATED TOKEN (a per-request EMA
        # made a 1-token and a 512-token request predict identically)
        self._ema_tok: Optional[float] = None
        self._ema_beta = float(ema_beta)
        self._completions = 0
        self._prefill_weight = float(prefill_weight)

    # ------------------------------------------------------------------ #
    # admission control
    # ------------------------------------------------------------------ #
    def _deadline_s(self, req: Request) -> Optional[float]:
        ms = req.slo_ms if req.slo_ms is not None else \
            self.class_slo_ms.get(req.priority)
        return None if ms is None else ms / 1e3

    def _request_tokens(self, req: Request,
                        max_new: Optional[int] = None) -> float:
        """Token-equivalents of serving ``req``: its generated tokens plus
        its tail-prefill length weighted down by ``prefill_weight``
        (prefill tokens are batched, decode tokens are steps).  With a
        prefix cache the tail shrinks by the currently matched prefix —
        saved prefill feeds straight into the admission prediction."""
        gen = req.max_new_tokens if max_new is None else max_new
        tail = len(req.prompt)
        pc = self.engine.prefix_cache
        if pc is not None:
            tail -= pc.peek(req.prompt)
        return gen + self._prefill_weight * tail

    def _predicted_completion(self, replica: int, req: Request,
                              max_new: Optional[int] = None
                              ) -> Optional[float]:
        """Seconds until ``req`` dispatched to ``replica`` now would
        finish: per-token EMA × (queued-ahead tokens / slots + the
        request's own token-equivalents).  None until the EMA has
        warmed."""
        if self._ema_tok is None or self._completions < 3:
            return None
        queued_tok = self.scheds[replica].queued_tokens()
        return self._ema_tok * (queued_tok / self.spr
                                + self._request_tokens(req, max_new))

    def _admit_or_shed(self, req: Request, replica: int, now: float) -> bool:
        """Returns True to dispatch ``req`` (possibly degraded)."""
        deadline = self._deadline_s(req)
        if self.admission == "none" or deadline is None:
            return True
        predicted = self._predicted_completion(replica, req)
        if predicted is None or predicted <= deadline:
            return True
        if self.admission == "degrade" and req.max_new_tokens > 1:
            # a shorter answer is a shorter service: retest at half length
            half = max(1, req.max_new_tokens // 2)
            scaled = self._predicted_completion(replica, req, max_new=half)
            if scaled is not None and scaled <= deadline:
                req.max_new_tokens = half
                req.degraded = True
                return True
        req.rejected = True
        req.finished_at = now
        self.rejected.append(req)
        return False

    def _dispatch(self, req: Request, now: float) -> None:
        replica = min(range(self.active),
                      key=lambda r: self.scheds[r].busy + self.scheds[r].queued())
        if self._admit_or_shed(req, replica, now):
            self.scheds[replica].submit(req)

    # ------------------------------------------------------------------ #
    # elasticity
    # ------------------------------------------------------------------ #
    def _autoscale(self, now: float) -> None:
        if self.autoscaler is None:
            return
        queued = sum(s.queued() for s in self.scheds[: self.active])
        busy = sum(s.busy for s in self.scheds[: self.active])
        target = self.autoscaler.tick(queued, busy, self.active, now)
        if target > self.active:
            self.active = target       # fresh lane groups join instantly
        elif target < self.active:
            # drain from the top: deactivate the highest lane group only
            # once it is idle, so the active span stays a contiguous prefix
            while (self.active > target
                   and not self.scheds[self.active - 1].has_work()):
                self.active -= 1

    def _wave_bucket(self, n: int) -> int:
        """Batch pad target for an n-request prefill wave: the next power
        of two, capped at the fleet width — a ladder small enough for
        ``warmup`` to run every shape the serving loop will ever
        request, tight enough that a 3-request backfill on a 256-lane
        fleet pays a 4-row prefill, not a 256-row one."""
        return min(next_pow2(max(n, 1)), next_pow2(self.engine.batch))

    # ------------------------------------------------------------------ #
    # fused span decode
    # ------------------------------------------------------------------ #
    def _decode_span(self, span: int, toks: np.ndarray, pos: np.ndarray,
                     cache) -> np.ndarray:
        """ONE decode step of the first ``span`` lanes, in place; the greedy
        token of each lane (host int32)."""
        eng = self.engine
        logits = eng.decode_span(span, eng._tensor(toks[:span, None]),
                                 eng._tensor(pos[:span]), cache)
        return _argmax(logits)

    # ------------------------------------------------------------------ #
    # serving loop
    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request], now_fn=None) -> List[Request]:
        """Serve ``requests`` across the fleet.  Same contract as
        ``ServeEngine.run``: greedy decode, tokens appended in place,
        ``now_fn`` drives arrival release and latency stamps (default
        frozen 0 clock for deterministic tests)."""
        now = now_fn or _now_zero
        if now is _now_zero and any(r.arrival > 0 for r in requests):
            raise ValueError("requests with a future arrival need an "
                             "advancing clock: pass now_fn="
                             "time.perf_counter (or rebase arrivals to 0)")
        pending = sorted(requests, key=lambda r: (r.arrival, id(r)))
        pending.reverse()              # pop() from the arrival-ordered tail

        eng, spr = self.engine, self.spr
        B = eng.batch
        cache = eng.init_shared_cache()
        toks = np.zeros(B, np.int32)
        pos = np.zeros(B, np.int32)

        def has_work():
            return bool(pending) or any(s.has_work() for s in self.scheds)

        while has_work():
            t = now()
            # 1. release arrivals → admission → dispatch
            while pending and pending[-1].arrival <= t:
                self._dispatch(pending.pop(), t)
            # 2. autoscale on observed demand
            self._autoscale(t)
            # 3. per-replica slot admission, one fleet-wide prefill wave
            admits = []
            for r in range(self.active):
                for slot, req in self.scheds[r].admit(t):
                    admits.append((r * spr + slot, req))
            if admits:
                cache, first = eng._prefill_into(
                    cache, admits, wave_pad=self._wave_bucket(len(admits)))
                for (lane, req), tok in zip(admits, first):
                    toks[lane] = tok
                    pos[lane] = len(req.prompt)
            if not any(s.busy for s in self.scheds[: self.active]):
                if pending:
                    nxt = pending[-1].arrival
                    time.sleep(min(max(nxt - now(), 0.0), 0.001))
                continue
            # 4. emit pending tokens, retire finished slots
            t = now()
            for r in range(self.active):
                sched = self.scheds[r]
                for slot in range(spr):
                    req = sched.slots[slot]
                    if req is None:
                        continue
                    lane = r * spr + slot
                    if req.max_new_tokens == 0:
                        self._retire(sched, slot, t)
                        continue
                    req.out_tokens.append(int(toks[lane]))
                    if len(req.out_tokens) >= req.max_new_tokens or (
                            req.eos_id is not None
                            and toks[lane] == req.eos_id):
                        self._retire(sched, slot, t)
            busy = sum(s.busy for s in self.scheds[: self.active])
            if busy == 0:
                continue
            # 5. ONE fused decode step over the active lane span
            span = self.active * spr
            step_toks = self._decode_span(span, toks, pos, cache)
            for r in range(self.active):
                sched = self.scheds[r]
                for slot in range(spr):
                    if sched.slots[slot] is not None:
                        lane = r * spr + slot
                        toks[lane] = step_toks[lane]
                        pos[lane] += 1
        return requests

    def _retire(self, sched: SlotScheduler, slot: int, t: float) -> None:
        req = sched.retire(slot, t)
        if req.admitted_at is not None and req.finished_at is not None:
            s = (req.finished_at - req.admitted_at) / max(
                1, len(req.out_tokens))
            self._ema_tok = s if self._ema_tok is None else (
                self._ema_beta * self._ema_tok + (1 - self._ema_beta) * s)
            self._completions += 1

    # ------------------------------------------------------------------ #
    # warmup & reporting
    # ------------------------------------------------------------------ #
    def warmup(self, prompt_lens: Sequence[int] = (), pad_to: int = 8,
               spans: Optional[Sequence[int]] = None) -> None:
        """Run the prefill wave buckets and the span decode steps once, so a
        fixed fleet pays no first-call cost mid-stream (on the card each
        span's graph is captured here).  ``spans`` defaults to the
        fixed-fleet span only; pass explicit replica counts (e.g.
        ``range(1, max_replicas + 1)``) when autoscaling."""
        self.engine.warmup(prompt_lens, pad_to=pad_to)
        lens = sorted(set(int(n) for n in prompt_lens))
        cache = self.engine.init_shared_cache()
        if lens and self.engine.ragged_ok:
            buckets = sorted(set(
                min(-(-n // pad_to) * pad_to, self.engine.max_seq)
                for n in lens))
            top = next_pow2(self.engine.batch)
            waves = [w for w in
                     (1 << i for i in range(top.bit_length()))
                     if w <= top]
            for b in buckets:
                for w in waves:
                    admits = [(s, Request(
                        prompt=np.zeros(min(b, self.engine.max_seq - 1),
                                        np.int32), max_new_tokens=1))
                        for s in range(min(w, self.engine.batch))]
                    cache, _ = self.engine._prefill_into(
                        cache, admits, pad_to=pad_to, wave_pad=w)
        zeros = np.zeros(self.engine.batch, np.int32)
        for n_active in (spans if spans is not None else [self.active]):
            # the span's first step: on the card its graph's capture
            self._decode_span(int(n_active) * self.spr, zeros, zeros, cache)
        if self.engine.prefix_cache is not None:
            # drop the warm-probe blocks the wave loop above inserted
            self.engine.prefix_cache.reset()

    def report(self) -> dict:
        """Fleet rollup: per-replica scheduler reports, fleet-wide latency
        percentiles, per-tenant outcomes over the FULL stream (finished +
        rejected — rejections count against SLO attainment), and the
        autoscaler's event log."""
        finished = [r for s in self.scheds for r in s._finished]
        totals = [r.finished_at - r.arrival for r in finished
                  if r.finished_at is not None]
        return {
            "replicas": self.max_replicas,
            "active": self.active,
            "slots_per_replica": self.spr,
            "finished": len(finished),
            "rejected": len(self.rejected),
            "degraded": sum(1 for r in finished if r.degraded),
            "latency_p50": _pct(totals, 50),
            "latency_p95": _pct(totals, 95),
            "latency_p99": _pct(totals, 99),
            "backfills": sum(s.backfills for s in self.scheds),
            "ema_tok_s": self._ema_tok,
            "prefix_cache": (self.engine.prefix_cache.stats()
                             if self.engine.prefix_cache is not None
                             else None),
            "tenants": tenant_report(finished + self.rejected),
            "autoscaler_events": (list(self.autoscaler.events)
                                  if self.autoscaler else []),
            "per_replica": [s.report() for s in self.scheds],
        }


class PredictorFleet:
    """The classical-model twin: N ``ModelPredictor`` replicas (the port's,
    ``serve/predictor.py``) behind least-loaded dispatch.  Each replica keeps its own microbatch queue;
    ``flush_all`` drains every replica and merges the stats."""

    def __init__(self, predictors: Sequence):
        if not predictors:
            raise ValueError("need at least one predictor")
        self.replicas = list(predictors)

    def submit(self, request) -> int:
        """Enqueue on the least-loaded replica; returns the replica index."""
        idx = min(range(len(self.replicas)),
                  key=lambda i: self.replicas[i].queued)
        self.replicas[idx].submit(request)
        return idx

    def flush_all(self, now: float = 0.0) -> list:
        done = []
        for p in self.replicas:
            done.extend(p.flush(now))
        return done

    @property
    def queued(self) -> int:
        return sum(p.queued for p in self.replicas)

    def report(self) -> dict:
        per = [p.report() for p in self.replicas]
        return {
            "replicas": len(per),
            "rows_served": sum(s.get("rows_served", 0) for s in per),
            "batches": sum(s.get("batches", 0) for s in per),
            "per_replica": per,
        }
