"""Continuous-batching decode engine: one shared KV cache, per-slot
positions, mid-decode backfill (counterpart: ``src/repro/serve/engine.py``).

Device work is four functions (the reference jits them):

  * **ragged prefill** — newly admitted prompts of *mixed* lengths are
    right-padded and prefilled together (``TransformerLM.prefill_ragged``);
    pad columns never enter the cache, so each slot's cache is exactly what
    a lone batch-1 prefill would have written.  Attention-only dense stacks
    only (``ragged_ok``).
  * **per-request prefill** — every other stack (here: Mamba-2's SSD
    blocks, whose recurrent state would absorb a pad tail) prefills each
    admitted prompt alone into a batch-1 cache (``TransformerLM.prefill``).
  * **fused decode** — ONE masked decode step advances every busy slot,
    each at its own position (``pos`` is a (B,) vector).  On the card it
    runs as a CUDA graph, the counterpart of the reference's
    ``jax.jit(self._decode)`` (below); the other three run eagerly.
  * **cache scatter** — drops a prefilled wave into its slots of the shared
    cache.

Every RMSNorm goes through the ``rmsnorm`` kernel, and a Mamba-2 prefill
runs the ``ssd_chunk_scan`` kernel once a layer.  With
``cfg.quantize="int8"`` every attention and MLP projection is a
``QTensor`` and goes through ``ops.quant_linear``: a decode step launches
``qmm_group`` 4 times a layer (q/k/v, o, gate/up, down), a prefill wave
``quantize_rows`` 4 times and ``qmm_wgmma`` 7 times a layer.

Slot admission, retirement and backfill are host-side and owned by
:class:`repro_torch.serve.scheduler.SlotScheduler`.  ``run_static`` keeps
the reference's static baseline and ``_run_one`` its slot-at-a-time
oracle: greedy token streams from every path are identical per request.

**Decode caches and the CUDA graph.**  The engine owns one decode cache
for each batch size it decodes at (``self.batch`` for ``run``, 1 for
``_run_one``, the group's size for ``_run_group``) and reuses it from
request to request; prefill writes into it in place.  No state of an
earlier request leaks into a later one:

  * an attention cache slot s of a ring of ``slots`` holds position
    ``pos − ((pos − s) mod slots)`` for a query at ``pos``, and the decode
    kernel reads a slot as empty where that is negative.  A request's
    prefill writes positions 0..S−1 (the last ``slots`` of them on a ring),
    each decode step the position it decodes, so every slot that reads as
    non-empty was written by this request; slots above the position read
    as empty, whatever an earlier request left there.  ``run`` goes
    further: it prefills into a fresh cache and scatters whole slot rows;
  * the SSD layer's prefill reads its cache's ``h`` and ``conv`` as the
    initial state and the left context of the convolution, and overwrites
    both with its final ones.  So ``_run_one`` and ``_run_group``, which
    prefill into the engine's cache, zero those two first
    (``_fresh_recurrent``); ``run`` scatters them from its fresh cache.

On the card the first decode on an engine cache runs eagerly (a warm-up,
on a side stream), and is then captured, ``TransformerLM.decode_step``
over the cache and static token (B, 1) and position (B,) buffers, into a
``torch.cuda.CUDAGraph``; a scalar position (``_run_group``) is broadcast
to (B,) first.  Later steps copy their inputs in and replay the graph; the
caches update in place inside it.  The logits a replay returns are the
graph's own output tensor, valid until the next decode at that batch size.
A decode on any other cache, or with other params, runs eagerly.  A
capture that fails raises: there is no eager fallback on the card.  On the
CPU the engine stays eager.  ``calls`` counts both kinds of step
(``decode_graph_replays``, ``decode_eager``).  A replay does not pass
through the kernels' Python wrappers, so the capture records each
wrapper's ``.launches`` and ``.shapes`` deltas, takes them back (capture
runs nothing) and adds them again at every replay: launch counts stay
exact.

Not ported yet (ROADMAP.md, Queue 1): ``mesh=`` (slot sharding over
``serve/step.py``) and ``prefix_cache=`` (``serve/prefix_cache.py``) raise
``NotImplementedError``.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import KERNELS
from repro_torch.models.config import ATTENTION_KINDS, ArchConfig
from repro_torch.models.layers.quant import quantize_model_params
from repro_torch.models.transformer import TransformerLM
from repro_torch.serve.scheduler import Request, SlotScheduler

__all__ = ["Request", "ServeEngine"]


def _now_zero() -> float:
    return 0.0


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class _GraphStep:
    """One captured decode step over one engine cache: static (B, 1)
    token and (B,) position buffers, the CUDA graph, its output logits, and
    each kernel wrapper's launches and launch shapes per replay."""

    def __init__(self, model: TransformerLM, params, cache, tokens: torch.Tensor,
                 pos: torch.Tensor, B: int):
        dev = tokens.device
        self.tokens = torch.zeros((B, 1), dtype=tokens.dtype, device=dev)
        self.pos = torch.zeros((B,), dtype=pos.dtype, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        # the wrappers a decode step can reach all count launches by shape
        wrappers = {n: fn for n, fn in KERNELS.items() if hasattr(fn, "shapes")}
        before = {name: (fn.launches, collections.Counter(fn.shapes))
                  for name, fn in wrappers.items()}
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        allocated = torch.cuda.memory_allocated(dev)
        with torch.cuda.graph(self.graph, stream=stream):
            self.logits, _ = model.decode_step(params, self.tokens, self.pos, cache)
        torch.cuda.current_stream(dev).wait_stream(stream)
        #: device memory the graph's pool took at capture
        self.pool_bytes = torch.cuda.memory_allocated(dev) - allocated
        # capture ran nothing: take the wrappers' counts back, keep the deltas
        self.wrappers = wrappers
        self.launches, self.shapes = {}, {}
        for name, fn in wrappers.items():
            n0, sh0 = before[name]
            self.launches[name] = fn.launches - n0
            self.shapes[name] = collections.Counter(fn.shapes) - sh0
            fn.launches = n0
            fn.shapes.clear()
            fn.shapes.update(sh0)

    def replay(self, tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        self.tokens.copy_(tokens)
        self.pos.copy_(pos)            # a scalar broadcasts to (B,)
        self.graph.replay()
        for name, fn in self.wrappers.items():
            fn.launches += self.launches[name]
            fn.shapes.update(self.shapes[name])
        return self.logits


def _argmax(logits: torch.Tensor) -> np.ndarray:
    """Greedy tokens of (B, 1, V) logits as host int32 (first index on ties,
    as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32).cpu().numpy()


class ServeEngine:
    """Fixed-slot continuous-batching engine over a request stream.

    ``batch_size`` decode slots share one KV cache with a real batch
    dimension; requests are admitted into free slots (backfilled
    mid-decode as others retire) and every busy slot advances through one
    fused per-slot-position decode step per token.  Decoding is greedy
    (the reference's ``greedy=`` flag is never read there, and the port
    drops it).  The engine runs on ``device`` (the CUDA card unless
    ``device="cpu"``) and moves ``params`` there.
    """

    def __init__(self, cfg: ArchConfig, params, batch_size: int, max_seq: int,
                 mesh=None, prefix_cache=None, device: DeviceLike = None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= serving (slot sharding, serve/step.py) is not ported "
                "yet (ROADMAP.md, Queue 1)")
        if prefix_cache is not None:
            raise NotImplementedError(
                "prefix_cache= (serve/prefix_cache.py) is not ported yet "
                "(ROADMAP.md, Queue 1)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = TransformerLM(cfg, self.device)
        self.batch = int(batch_size)
        self.max_seq = int(max_seq)
        params = _to_device(params, self.device)
        if cfg.quantize != "none":
            params = quantize_model_params(params, cfg.quantize)
        self.params = params
        # ragged (batched mixed-length) prefill is exact only when no
        # cross-slot or sequential state exists; everything else prefills
        # per request and scatters into its slot
        self.ragged_ok = (
            all(k in ATTENTION_KINDS for k in cfg.pattern)
            and not cfg.num_experts and not cfg.cross_attention
            and not cfg.vision_tokens)
        #: device work counted by kind, for the launch bookkeeping:
        #: ragged prefill waves, whole-batch prefills (per-request admission
        #: and the reference paths), decode steps
        #: and, of the decode steps, graph replays and eager steps
        self.calls = {"prefill_waves": 0, "prefills": 0, "decode_steps": 0,
                      "decode_graph_replays": 0, "decode_eager": 0}
        # the engine's decode caches and their captured steps, by batch size
        self._caches: Dict[int, Any] = {}
        self._graphs: Dict[int, _GraphStep] = {}
        self._graphed = self.device.type == "cuda"

    # ------------------------------------------------------------------ #
    # device functions (the reference's jitted ones)
    # ------------------------------------------------------------------ #
    def _prefill(self, params, tokens, cache):
        self.calls["prefills"] += 1
        return self.model.prefill(params, tokens, cache)

    def _prefill_ragged(self, params, tokens, lengths, cache):
        self.calls["prefill_waves"] += 1
        return self.model.prefill_ragged(params, tokens, lengths, cache)

    def _decode(self, params, tokens, pos, cache):
        """One decode step: on the card and on an engine cache a graph
        replay, after a first step there that runs eagerly and captures the
        graph; eager everywhere else (module docstring)."""
        self.calls["decode_steps"] += 1
        B = int(tokens.shape[0])
        if not (self._graphed and params is self.params
                and self._caches.get(B) is cache):
            self.calls["decode_eager"] += 1
            return self.model.decode_step(params, tokens, pos, cache)
        if B not in self._graphs:
            # the warm-up, eager on a side stream (a capture wants its
            # handles and workspaces made outside it), then the capture
            self.calls["decode_eager"] += 1
            dev = self.device
            stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                logits, cache = self.model.decode_step(params, tokens, pos, cache)
            torch.cuda.current_stream(dev).wait_stream(stream)
            self._graphs[B] = _GraphStep(self.model, params, cache, tokens,
                                         torch.as_tensor(pos, device=dev), B)
            return logits, cache
        self.calls["decode_graph_replays"] += 1
        return self._graphs[B].replay(tokens, pos), cache

    def decode_cache(self, batch: int):
        """The engine's decode cache at ``batch`` slots, made on first use
        and kept (module docstring)."""
        if batch not in self._caches:
            self._caches[batch] = self.model.init_cache(batch, self.max_seq)
        return self._caches[batch]

    @property
    def graph_pool_bytes(self) -> int:
        """Device memory the captured decode steps' graph pools took."""
        return sum(g.pool_bytes for g in self._graphs.values())

    @staticmethod
    def _fresh_recurrent(cache):
        """Zero the SSD ``h`` and ``conv`` states of a reused cache before a
        prefill into it, which reads them as its initial state."""
        for block in cache.values():
            for t in block.get("ssd", {}).values():
                t.zero_()
        return cache

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ------------------------------------------------------------------ #
    # shared-cache plumbing
    # ------------------------------------------------------------------ #
    def init_shared_cache(self):
        """The engine's one KV cache: batch dim = decode slots (kept from
        call to call)."""
        return self.decode_cache(self.batch)

    def _scatter(self, cache, sub_cache, slots: np.ndarray):
        """Drop ``sub_cache`` (batch = len(slots)) into ``cache`` at slot
        indices ``slots`` along the batch axis (axis 1 — axis 0 is the
        stacked-periods axis), in place.  Out-of-range slot indices are
        dropped: the ragged prefill pads its admission wave with dummy rows
        routed to slot ``num_slots``."""
        slots = np.asarray(slots)
        # torch's index assignment has no mode="drop": keep the in-range rows
        keep = np.nonzero(slots < self.batch)[0]
        dst = self._tensor(slots[keep]).long()
        src = self._tensor(keep).long()

        def put(full, sub):
            if isinstance(full, dict):
                for k in full:
                    put(full[k], sub[k])
            else:
                full[:, dst] = sub[:, src]

        put(cache, sub_cache)
        return cache

    # ------------------------------------------------------------------ #
    # admission → prefill
    # ------------------------------------------------------------------ #
    def _prefill_into(self, cache, admits: List[Tuple[int, Request]],
                      pad_to: int = 8) -> Tuple[Any, np.ndarray]:
        """Prefill the admitted requests and scatter them into their slots.
        Returns (cache, first greedy token per admit).

        Stacks with ``ragged_ok`` take ONE ragged right-padded prefill for
        the whole wave; the others prefill each request alone into a
        batch-1 cache and scatter it into its slot.  The wave
        is padded along both axes so that shapes repeat from wave to wave:
        sequence to a ``pad_to`` bucket, batch to a wave bucket — 1 for a
        single-request backfill, the slot count otherwise, with dummy
        length-1 rows whose scatter destination is out of range (dropped).
        On the card that keeps the ``quant_linear`` shapes, M = wave bucket
        × sequence bucket, to a few per sequence bucket."""
        slots = np.asarray([s for s, _ in admits], np.int32)
        reqs = [r for _, r in admits]
        lens = np.asarray([len(r.prompt) for r in reqs], np.int32)
        if np.any(lens + np.asarray([r.max_new_tokens for r in reqs]) >
                  self.max_seq):
            raise ValueError("prompt + max_new_tokens exceeds max_seq")
        n, B = len(reqs), self.batch
        if not self.ragged_ok:
            first = np.zeros(n, np.int32)
            for i, r in enumerate(reqs):
                sub = self.model.init_cache(1, self.max_seq)
                logits, sub = self._prefill(
                    self.params,
                    self._tensor(np.asarray(r.prompt, np.int32)[None, :]), sub)
                cache = self._scatter(cache, sub, slots[i:i + 1])
                first[i] = _argmax(logits)[0]
            return cache, first
        wb = 1 if n == 1 else B                   # wave bucket (batch pad)
        S = min(int(-(-int(lens.max()) // pad_to) * pad_to), self.max_seq)
        padded = np.zeros((wb, S), np.int32)
        full_lens = np.ones(wb, np.int32)         # dummy rows: 1 real token
        full_slots = np.full(wb, B, np.int32)     # dummy rows: out of range
        for i, r in enumerate(reqs):
            padded[i, : lens[i]] = r.prompt
            full_lens[i] = lens[i]
            full_slots[i] = slots[i]
        sub = self.model.init_cache(wb, self.max_seq)
        logits, sub = self._prefill_ragged(
            self.params, self._tensor(padded), self._tensor(full_lens), sub)
        cache = self._scatter(cache, sub, full_slots)
        return cache, _argmax(logits)[:n]

    # ------------------------------------------------------------------ #
    # continuous-batching loop
    # ------------------------------------------------------------------ #
    def run(self, requests: List[Request],
            scheduler: Optional[SlotScheduler] = None,
            now_fn=None) -> List[Request]:
        """Serve ``requests`` with continuous batching: admit into free
        slots, advance all busy slots through one fused decode step per
        token, retire on EOS/``max_new_tokens``, and backfill freed slots
        from the queue mid-decode.  ``now_fn`` supplies the clock for the
        scheduler's latency accounting (default: a frozen 0 clock);
        requests whose ``arrival`` lies in the future are held back until
        the clock reaches them."""
        sched = scheduler or SlotScheduler(self.batch)
        now = now_fn or _now_zero
        if now is _now_zero and any(r.arrival > 0 for r in requests):
            raise ValueError("requests with a future arrival need an "
                             "advancing clock: pass now_fn="
                             "time.perf_counter (or rebase arrivals to 0)")
        for r in requests:
            sched.submit(r)

        B = self.batch
        cache = self.init_shared_cache()
        toks = np.zeros(B, np.int32)     # pending (unemitted) token per slot
        pos = np.zeros(B, np.int32)      # decode position per slot
        while sched.has_work():
            t = now()
            admits = sched.admit(t)
            if not admits and sched.busy == 0:
                # nothing running and nothing admissible yet: the next
                # arrival is in the future — let the clock catch up
                nxt = sched.next_arrival()
                if nxt is None:
                    break
                time.sleep(min(max(nxt - now(), 0.0), 0.001))
                continue
            if admits:
                cache, first = self._prefill_into(cache, admits)
                for (slot, req), tok in zip(admits, first):
                    toks[slot] = tok
                    pos[slot] = len(req.prompt)
            # emit one token per busy slot; retire EOS / exhausted slots
            t = now()
            for slot in range(B):
                req = sched.slots[slot]
                if req is None:
                    continue
                if req.max_new_tokens == 0:
                    sched.retire(slot, t)
                    continue
                req.out_tokens.append(int(toks[slot]))
                if len(req.out_tokens) >= req.max_new_tokens or (
                        req.eos_id is not None and toks[slot] == req.eos_id):
                    sched.retire(slot, t)
            if sched.busy == 0:
                continue  # all retired; backfill (or finish) next iteration
            # ONE fused masked step advances every slot, each at its own pos
            logits, cache = self._decode(self.params, self._tensor(toks[:, None]),
                                         self._tensor(pos), cache)
            step_toks = _argmax(logits)
            for slot in range(B):
                if sched.slots[slot] is not None:
                    toks[slot] = step_toks[slot]
                    pos[slot] += 1
        return requests

    # ------------------------------------------------------------------ #
    # reference paths (parity + benchmark baseline)
    # ------------------------------------------------------------------ #
    def _run_one(self, req: Request) -> Request:
        """Slot-at-a-time reference: prefill one request, then greedy-decode
        token by token with a batch-1 cache.  The parity oracle for the
        continuous path."""
        S = len(req.prompt)
        cache = self._fresh_recurrent(self.decode_cache(1))
        logits, cache = self._prefill(
            self.params, self._tensor(np.asarray(req.prompt, np.int32)[None, :]), cache)
        pos = S
        tok = int(_argmax(logits)[0])
        for _ in range(req.max_new_tokens):
            req.out_tokens.append(tok)
            if req.eos_id is not None and tok == req.eos_id:
                break
            logits, cache = self._decode(self.params, self._tensor([[tok]]),
                                         self._tensor(np.int32(pos)), cache)
            tok = int(_argmax(logits)[0])
            pos += 1
        req.done = True
        return req

    def run_static(self, requests: List[Request]) -> List[Request]:
        """The static engine, kept as the baseline: requests with equal
        prompt length group into one shared-position batch; every other
        request decodes slot-at-a-time.  No admission queue, no backfill."""
        groups: Dict[int, List[int]] = {}
        for i, r in enumerate(requests):
            groups.setdefault(len(r.prompt), []).append(i)
        for plen, idxs in groups.items():
            if len(idxs) == 1:
                self._run_one(requests[idxs[0]])
            else:
                self._run_group([requests[i] for i in idxs], plen)
        return requests

    def _run_group(self, reqs: List[Request], plen: int) -> None:
        """Batched decode for equal-length prompts: shared positions, one
        cache with a true batch dimension, per-slot retirement masks."""
        B = len(reqs)
        prompts = self._tensor(np.stack([r.prompt for r in reqs]).astype(np.int32))
        cache = self._fresh_recurrent(self.decode_cache(B))
        logits, cache = self._prefill(self.params, prompts, cache)
        toks = _argmax(logits)
        pos = plen
        max_new = max(r.max_new_tokens for r in reqs)
        active = np.ones(B, bool)
        for step in range(max_new):
            for b, r in enumerate(reqs):
                if not active[b]:
                    continue
                r.out_tokens.append(int(toks[b]))
                if len(r.out_tokens) >= r.max_new_tokens or (
                        r.eos_id is not None and toks[b] == r.eos_id):
                    active[b] = False
                    r.done = True
            if not active.any() or step == max_new - 1:
                break
            logits, cache = self._decode(self.params, self._tensor(toks[:, None]),
                                         self._tensor(np.int32(pos)), cache)
            toks = _argmax(logits)
            pos += 1
        for r in reqs:
            r.done = True

    # ------------------------------------------------------------------ #
    # warmup
    # ------------------------------------------------------------------ #
    def warmup(self, prompt_lens: Sequence[int] = (), pad_to: int = 8) -> None:
        """Run the decode step and every prefill shape the given prompt
        lengths will hit, once, before serving.  Eager PyTorch compiles
        nothing, but the first call of each shape still pays one-time costs
        (the kernels' build and load, cuBLAS handles, the caching
        allocator's first blocks), which the launcher keeps out of its
        report.  The shapes are those of the reference: two prefills per
        sequence bucket (a solo backfill and a full wave)."""
        lens = sorted(set(int(n) for n in prompt_lens))
        cache = self.init_shared_cache()
        buckets = sorted(set(min(-(-n // pad_to) * pad_to, self.max_seq) for n in lens))
        for b in buckets:
            req = Request(prompt=np.zeros(min(b, self.max_seq - 1), np.int32),
                          max_new_tokens=1)
            cache, _ = self._prefill_into(cache, [(0, req)], pad_to=pad_to)
            if self.batch > 1:
                wave = [(s, Request(prompt=np.zeros(min(b, self.max_seq - 1), np.int32),
                                    max_new_tokens=1))
                        for s in range(min(2, self.batch))]
                cache, _ = self._prefill_into(cache, wave, pad_to=pad_to)
        logits, _ = self._decode(self.params,
                                 self._tensor(np.zeros((self.batch, 1), np.int32)),
                                 self._tensor(np.zeros(self.batch, np.int32)), cache)
        _argmax(logits)

