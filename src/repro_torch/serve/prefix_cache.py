"""Fleet-wide radix prefix KV cache: reuse repeated prompt prefixes
(counterpart: ``src/repro/serve/prefix_cache.py``).

The host half — the token-block trie, refcounted pins, LRU eviction of
unreferenced leaves, ring-validity truncation (``valid_end``) and the
hit/miss statistics — is plain Python and numpy, copied from the reference
(the port keeps its own copies).  The device half is the port's:

  * the pool is a tree shaped like the model's cache with ``(periods,
    capacity, block_size, …)`` tensors on the model's device (``bind``);
  * ``restore_into`` copies any number of (lane, block) pairs into a wave's
    sub-cache with one indexed copy a cache leaf, and ``extract_from``
    copies freshly prefilled blocks back into the pool the same way.  The
    index tensors are made on the host from the entries, so neither syncs
    with the device.  Nothing is compiled, so the reference's padding of
    the block lists to a power-of-two bucket is not kept.

What a ring restores follows the reference: the positions a match needs,
the last ``ring`` before the match's end, where ``ring`` is the layer's
ring in the full cache (``min(window, max_seq)``; the bound template's).
A wave's sub-cache in the port may hold fewer slots than ``max_seq``
(``serve/engine.py``): a position p goes to its slot ``p mod`` the
sub-cache's own ring, which is p itself where that ring holds every
position of the wave.  Extracting a block twice in one call (a wave whose
shorter prompt shrinks a block another row just wrote) keeps the last
entry's rows, whose ``valid_end`` is the one the trie records.

Exactness: restored blocks are the bits a full prefill wrote, and the tail
prefill (``TransformerLM.prefill_ragged(start_pos=)``, kernel 6's tail
form) sums each row as that prefill does, so greedy streams are
bit-identical cache-on vs cache-off.  ``cache_dtype="int8"`` is refused by
``ServeEngine``, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["RadixPrefixCache", "PrefixMatch"]


class _Node:
    """One cached block: a trie edge labelled by ``block_size`` tokens."""

    __slots__ = ("key", "parent", "children", "block_id", "start",
                 "valid_end", "refs", "last_used")

    def __init__(self, key: bytes, parent: Optional["_Node"], block_id: int,
                 start: int, valid_end: int):
        self.key = key
        self.parent = parent
        self.children: Dict[bytes, "_Node"] = {}
        self.block_id = block_id
        self.start = start              # absolute token offset of the block
        self.valid_end = valid_end      # prompt length at pool-write time
        self.refs = 0
        self.last_used = 0


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """A pinned match: ``length`` tokens over ``nodes`` (one per block).
    Hold it across the restore, then :meth:`RadixPrefixCache.release` it."""

    length: int
    nodes: Tuple[_Node, ...]

    @property
    def block_ids(self) -> Tuple[int, ...]:
        return tuple(n.block_id for n in self.nodes)


class RadixPrefixCache:
    """Token-block trie + device KV block pool (see module docstring).

    The host trie works standalone (``match``/``plan_insert``/``release``
    need no device state); :meth:`bind` attaches the pool for a concrete
    model.  One instance is shared by a whole
    :class:`~repro_torch.serve.router.ReplicaRouter` fleet — its replicas
    are lane groups on one engine, so sharing is free.
    """

    def __init__(self, block_size: int = 16, capacity_blocks: int = 256,
                 ring_sizes: Sequence[int] = ()):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        if capacity_blocks < 1:
            raise ValueError("capacity_blocks must be >= 1")
        self.block_size = int(block_size)
        self.capacity = int(capacity_blocks)
        # ring_sizes is normally set by bind(); the ctor knob exists so the
        # host-only property tests can exercise ring-validity truncation
        self._ring_sizes: Tuple[int, ...] = tuple(sorted(set(ring_sizes)))
        self._root = _Node(b"", None, -1, -self.block_size, 0)
        self._registry: set = set()     # all live nodes (eviction scan)
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._clock = 0
        # device half (None until bind)
        self._pool = None
        self._max_seq: Optional[int] = None
        self._rings: List[int] = []
        self._reset_stats()

    def _reset_stats(self) -> None:
        self.requests = 0
        self.hits = 0
        self.misses = 0
        self.cached_tokens = 0          # prefill tokens served from the pool
        self.prompt_tokens = 0          # total prefill tokens requested
        self.evictions = 0
        self.inserted_blocks = 0

    # ------------------------------------------------------------------ #
    # host trie
    # ------------------------------------------------------------------ #
    @property
    def blocks(self) -> int:
        """Live blocks in the trie (≤ capacity — property-tested)."""
        return len(self._registry)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _keys(self, tokens: np.ndarray, nblocks: int) -> List[bytes]:
        bs = self.block_size
        return [tokens[d * bs:(d + 1) * bs].tobytes() for d in range(nblocks)]

    def _walk(self, tokens: np.ndarray, max_blocks: int) -> List[_Node]:
        chain: List[_Node] = []
        node = self._root
        for key in self._keys(tokens, max_blocks):
            child = node.children.get(key)
            if child is None:
                break
            chain.append(child)
            node = child
        return chain

    def _usable_blocks(self, chain: List[_Node], cap: int) -> int:
        """Longest usable prefix (in blocks): every ring size must find its
        needed positions — the last ``ring`` before the match end — outside
        each block's garbage region (positions < valid_end - ring)."""
        bs = self.block_size
        m = min(len(chain), cap)
        while m > 0:
            L = m * bs
            ok = True
            for ring in self._ring_sizes:
                lo = max(0, L - ring)           # needed: positions [lo, L)
                for d in range(lo // bs, m):
                    garbage_end = chain[d].valid_end - ring
                    if max(lo, chain[d].start) < min(L, garbage_end):
                        ok = False
                        break
                if not ok:
                    break
            if ok:
                return m
            m -= 1
        return 0

    def match(self, tokens: np.ndarray) -> PrefixMatch:
        """Longest usable cached block-aligned prefix of ``tokens``,
        **pinned** (refcounts incremented) until :meth:`release`.  Always
        leaves ≥ 1 uncached tail token so the tail prefill can produce the
        first greedy logits.  Updates hit/miss stats and LRU clocks."""
        toks = np.ascontiguousarray(tokens, np.int32)
        cap = max(0, (len(toks) - 1) // self.block_size)
        chain = self._walk(toks, cap)
        m = self._usable_blocks(chain, cap)
        chain = chain[:m]
        t = self._tick()
        for node in chain:
            node.refs += 1
            node.last_used = t
        length = m * self.block_size
        self.requests += 1
        if length > 0:
            self.hits += 1
        else:
            self.misses += 1
        self.cached_tokens += length
        self.prompt_tokens += len(toks)
        return PrefixMatch(length=length, nodes=tuple(chain))

    def release(self, match: PrefixMatch) -> None:
        """Unpin a match's chain (refcounts back down, never below 0)."""
        for node in match.nodes:
            if node.refs <= 0:
                raise RuntimeError("release without matching pin")
            node.refs -= 1

    def peek(self, tokens: np.ndarray) -> int:
        """Match length (tokens) WITHOUT pinning, stats, or LRU touches —
        the router's SLO predictor uses this to estimate tail-prefill
        length before dispatch."""
        toks = np.ascontiguousarray(tokens, np.int32)
        cap = max(0, (len(toks) - 1) // self.block_size)
        chain = self._walk(toks, cap)
        return self._usable_blocks(chain, cap) * self.block_size

    def plan_insert(self, tokens: np.ndarray) -> List[Tuple[int, int]]:
        """Record every full block of ``tokens`` in the trie; returns the
        ``(block_id, start)`` writes whose pool data the caller must fill
        (via :meth:`extract_from`) **before the next match** — new blocks,
        plus existing blocks whose ``valid_end`` shrinks (a shorter prompt
        strictly improves ring validity; content is equal where both are
        valid by the prefix property).  Allocation evicts LRU unreferenced
        leaves when full and stops planning when nothing is evictable."""
        toks = np.ascontiguousarray(tokens, np.int32)
        end = len(toks)
        bs = self.block_size
        writes: List[Tuple[int, int]] = []
        pinned: List[_Node] = []
        node = self._root
        t = self._tick()
        try:
            for d, key in enumerate(self._keys(toks, end // bs)):
                child = node.children.get(key)
                if child is None:
                    bid = self._alloc()
                    if bid is None:
                        break           # full of pinned/interior blocks
                    child = _Node(key, node, bid, d * bs, end)
                    node.children[key] = child
                    self._registry.add(child)
                    self.inserted_blocks += 1
                    writes.append((bid, d * bs))
                elif end < child.valid_end:
                    child.valid_end = end
                    writes.append((child.block_id, d * bs))
                child.last_used = t
                # pin the path so allocating block d+1 can never evict the
                # freshly inserted (still-leaf) block d
                child.refs += 1
                pinned.append(child)
                node = child
        finally:
            for n in pinned:
                n.refs -= 1
        return writes

    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victims = [n for n in self._registry
                   if not n.children and n.refs == 0]
        if not victims:
            return None
        victim = min(victims, key=lambda n: n.last_used)
        del victim.parent.children[victim.key]
        self._registry.discard(victim)
        self.evictions += 1
        return victim.block_id

    def reset(self) -> None:
        """Drop every cached block and zero the stats; the device pool
        survives (warmup calls this so its probe prompts never pollute the
        live trie)."""
        self._root = _Node(b"", None, -1, -self.block_size, 0)
        self._registry.clear()
        self._free = list(range(self.capacity - 1, -1, -1))
        self._clock = 0
        self._reset_stats()

    def stats(self) -> dict:
        return {
            "requests": self.requests,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.cached_tokens / self.prompt_tokens
                         if self.prompt_tokens else 0.0),
            "cached_tokens": self.cached_tokens,
            "prompt_tokens": self.prompt_tokens,
            "evictions": self.evictions,
            "inserted_blocks": self.inserted_blocks,
            "blocks": self.blocks,
            "capacity_blocks": self.capacity,
            "block_size": self.block_size,
        }

    # ------------------------------------------------------------------ #
    # device pool
    # ------------------------------------------------------------------ #
    def bind(self, model, max_seq: int) -> None:
        """Attach the block pool for ``model``'s cache layout, on the
        model's device.  Idempotent for a matching layout; a second engine
        with a different cache shape (other arch / max_seq) is refused —
        one pool, one layout."""
        template = model.init_cache(1, max_seq)
        leaves = _leaves(template)
        shapes = tuple((leaf.shape[0], leaf.shape[2]) + tuple(leaf.shape[3:])
                       for leaf in leaves)
        if self._pool is not None:
            if shapes != self._bound_shapes or int(max_seq) != self._max_seq:
                raise ValueError(
                    "prefix cache already bound to a different cache layout "
                    "— one RadixPrefixCache serves one model/max_seq")
            return
        self._bound_shapes = shapes
        self._max_seq = int(max_seq)
        self._ring_sizes = tuple(sorted({int(leaf.shape[2]) for leaf in leaves}))
        #: each leaf's ring in the full cache, in ``_leaves`` order
        self._rings = [int(leaf.shape[2]) for leaf in leaves]
        cap, bs = self.capacity, self.block_size
        self._pool = _tree_map(
            lambda leaf: torch.zeros((leaf.shape[0], cap, bs) + tuple(leaf.shape[3:]),
                                     dtype=leaf.dtype, device=leaf.device),
            template)
        del template

    @property
    def bound(self) -> bool:
        return self._pool is not None

    def restore_into(self, cache, entries: List[Tuple[int, int, int, int]]):
        """Copy cached blocks into a wave sub-cache, in place, one indexed
        copy a leaf.  ``entries``: (lane, block_id, start, match_len) per
        block — the match_len of the owning request bounds each ring's keep
        window.  Returns the cache."""
        if not entries:
            return cache
        if self._pool is None:
            raise RuntimeError("restore_into before bind()")
        e = np.asarray(entries, np.int64).reshape(-1, 4)
        lanes, ids, starts, lens = e.T
        j = np.arange(self.block_size)[None, :]
        pos = starts[:, None] + j                                  # (n, bs)
        plans: Dict[Tuple[int, int], tuple] = {}
        for c, p, ring in zip(_leaves(cache), _leaves(self._pool), self._rings):
            sub_ring = int(c.shape[2])
            key = (ring, sub_ring)
            if key not in plans:
                keep = (pos < lens[:, None]) & (pos >= lens[:, None] - ring)
                r, jj = np.nonzero(keep)
                dev = c.device
                plans[key] = tuple(torch.as_tensor(a, device=dev) for a in
                                   (lanes[r], pos[r, jj] % sub_ring, ids[r], jj))
            lane_t, dest_t, id_t, j_t = plans[key]
            c[:, lane_t, dest_t] = p[:, id_t, j_t]
        return cache

    def extract_from(self, cache, entries: List[Tuple[int, int, int]]) -> None:
        """Copy freshly prefilled blocks out of a wave sub-cache into the
        pool, one indexed copy a leaf.  ``entries``: (lane, block_id,
        start); a block named twice keeps the last entry's rows."""
        if not entries:
            return
        if self._pool is None:
            raise RuntimeError("extract_from before bind()")
        last = {bid: (lane, bid, st) for lane, bid, st in entries}
        e = np.asarray(list(last.values()), np.int64).reshape(-1, 3)
        lanes, ids, starts = e.T
        pos = starts[:, None] + np.arange(self.block_size)[None, :]    # (n, bs)
        plans: Dict[int, tuple] = {}
        for c, p in zip(_leaves(cache), _leaves(self._pool)):
            sub_ring = int(c.shape[2])
            if sub_ring not in plans:
                dev = c.device
                plans[sub_ring] = tuple(torch.as_tensor(a, device=dev) for a in
                                        (lanes[:, None], pos % sub_ring, ids))
            lane_t, src_t, id_t = plans[sub_ring]
            p[:, id_t] = c[:, lane_t, src_t]


def _leaves(tree) -> List[torch.Tensor]:
    """A cache tree's tensors in sorted-key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)
