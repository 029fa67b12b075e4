"""Paged KV substrate, host side: block pool, paged radix prefix cache, and
the runtime that holds the device pool tensors.

A copy of ``tpustack/serving/kv_pool.py`` (``KVBlockPool``,
``PagedPrefixCache`` with its host-tier hooks, ``PagedKVRuntime``,
``OutOfBlocks``, ``eta_until_blocks``) without the working-set profiler
hooks, the warm/cold eviction split and the sanitizer guards.  Pure Python
and numpy; the host tier (``serving.kv_host_tier``) copies blocks.

Every layer's K/V lives in pool tensors ``[n_blocks, block, Hkv, D]``
(``models.llama.init_kv_pool``); a sequence's cache line is a block table.
Admission reserves ``ceil((prompt + max_new) / block)`` blocks; a finished
prefill's full blocks enter a radix trie keyed by token ids, and a later
request sharing the prefix points its table at the same physical blocks (a
refcount increment, no copy).  Blocks free only at refcount 0.  Block 0 is
reserved: idle table entries point at it and nothing writes it.

With a host tier attached (``PagedPrefixCache.host_tier``), an evicted
block's bytes spill to host RAM instead of dying: the node stays in the trie
tagged ``tier="host"``, a later match claims the payloads of the contiguous
host chunks past the device frontier (``PagedMatch.host_payloads``), and the
restoring request's insert re-promotes the stubs onto fresh blocks.

Thread-safe: the server's handler threads admit and read stats while the
engine thread allocates and frees at wave boundaries.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tpustack_torch.utils import get_logger

log = get_logger("serving.kv_pool")


class OutOfBlocks(RuntimeError):
    """Allocation failed: the pool has fewer free blocks than requested."""


def eta_until_blocks(releases, need_blocks: int) -> float:
    """Seconds until ``need_blocks`` blocks are projected to free: walk
    ``releases`` (``(eta_seconds, blocks_held)`` per in-flight request) in
    finish order until the cumulative release covers the need; 1.0 when
    nothing is in flight."""
    rel = sorted(releases)
    freed = 0
    for eta, n in rel:
        freed += n
        if freed >= need_blocks:
            return eta
    return rel[-1][0] if rel else 1.0


class KVBlockPool:
    """Fixed-size block allocator with per-block refcounts.

    ``n_blocks`` includes the reserved block 0 (``capacity_blocks`` is
    ``n_blocks - 1``).  ``alloc_tokens`` returns blocks at refcount 1;
    sharing increfs; ``decref`` frees a block only at 0."""

    def __init__(self, n_blocks: int, block_tokens: int):
        if n_blocks < 2:
            raise ValueError(f"need >= 2 blocks (0 is reserved), got {n_blocks}")
        if block_tokens <= 0:
            raise ValueError(f"block_tokens must be positive, got {block_tokens}")
        self.n_blocks = n_blocks
        self.block = block_tokens
        self._lock = threading.RLock()
        self._free: deque = deque(range(1, n_blocks))
        self._ref = np.zeros(n_blocks, np.int64)
        self._filled = np.zeros(n_blocks, np.int64)
        self._alloc_t = np.zeros(n_blocks, np.float64)
        self.allocated_blocks_total = 0
        self.freed_blocks_total = 0
        self.block_seconds_total = 0.0

    @property
    def capacity_blocks(self) -> int:
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.capacity_blocks - len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks a sequence of ``n_tokens`` occupies (ceil)."""
        return max(0, (n_tokens + self.block - 1) // self.block)

    def alloc_tokens(self, n_tokens: int) -> List[int]:
        """Blocks covering ``n_tokens`` at refcount 1; raises
        :class:`OutOfBlocks` without side effects when the pool is short."""
        need = self.blocks_for(n_tokens)
        now = time.time()
        with self._lock:
            if need > len(self._free):
                raise OutOfBlocks(f"need {need} blocks for {n_tokens} tokens, "
                                  f"{len(self._free)} free of {self.capacity_blocks}")
            ids = [self._free.popleft() for _ in range(need)]
            remaining = n_tokens
            for bid in ids:
                self._ref[bid] = 1
                self._filled[bid] = min(self.block, remaining)
                self._alloc_t[bid] = now
                remaining -= min(self.block, remaining)
            self.allocated_blocks_total += need
        return ids

    def incref(self, ids: Sequence[int]) -> None:
        with self._lock:
            for bid in ids:
                if self._ref[bid] <= 0:
                    raise ValueError(f"incref on free block {bid}")
                self._ref[bid] += 1

    def decref(self, ids: Sequence[int]) -> int:
        """Drop one reference per id; returns how many blocks freed."""
        freed = 0
        now = time.time()
        with self._lock:
            for bid in ids:
                if self._ref[bid] <= 0:
                    raise ValueError(f"decref on free block {bid}")
                self._ref[bid] -= 1
                if self._ref[bid] == 0:
                    self._filled[bid] = 0
                    if self._alloc_t[bid]:
                        self.block_seconds_total += max(0.0, now - self._alloc_t[bid])
                        self._alloc_t[bid] = 0.0
                    self._free.append(bid)
                    freed += 1
            self.freed_blocks_total += freed
        return freed

    def refcount(self, bid: int) -> int:
        return int(self._ref[bid])

    def fragmentation(self) -> float:
        """Fraction of reserved token slots in used blocks that no token can
        fill (block-rounding slack); 0.0 when idle."""
        with self._lock:
            used = self.n_used
            if used == 0:
                return 0.0
            return max(0.0, 1.0 - int(self._filled.sum()) / (used * self.block))

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "block_tokens": self.block,
                "pool_blocks": self.capacity_blocks,
                "free_blocks": self.n_free,
                "used_blocks": self.n_used,
                "utilization": (self.n_used / self.capacity_blocks
                                if self.capacity_blocks else 0.0),
                "fragmentation": round(self.fragmentation(), 4),
                "allocated_blocks_total": self.allocated_blocks_total,
                "freed_blocks_total": self.freed_blocks_total,
                "block_seconds_total": round(self.block_seconds_total, 3),
            }


class PagedMatch:
    """A paged lookup: ``length`` cached tokens (whole blocks, 0 on a miss)
    and the matched ``block_ids``, one reference each owned by the caller.
    ``host_payloads`` (host-tier caches only): claimed host payloads of the
    blocks right after the device match, in prefix order, owned outright by
    the caller, which restores them into fresh pool blocks or hands them
    back with ``HostKVTier.abandon``."""

    __slots__ = ("length", "block_ids", "host_payloads")

    def __init__(self, length: int, block_ids: List[int],
                 host_payloads: Optional[list] = None):
        self.length = length
        self.block_ids = block_ids
        self.host_payloads = host_payloads or []


_NODE_UIDS = itertools.count(1)


class _Node:
    """One block of a cached prefix: edge label = its token ids, payload =
    the physical block id (the cache holds one pool reference on it)."""

    __slots__ = ("key", "parent", "children", "block_id", "last_used", "uid", "tier")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"], block_id: int):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.block_id = block_id
        self.last_used = 0
        self.uid = next(_NODE_UIDS)
        # "hbm": block_id is a live pool block the cache holds a reference
        # on; "host": block_id is -1 and the bytes live in the host tier
        # (or nowhere: a claimed or expired stub a later insert re-promotes)
        self.tier = "hbm"


class PagedPrefixCache:
    """Radix trie of cached prefixes keyed on token ids, valued in block ids.

    Only complete blocks are cached (a partial tail block keeps receiving
    its slot's decode writes).  Matches are capped at ``len(ids) - 1``
    tokens: at least one token must be prefilled for next-token logits.
    Eviction drops least-recently-used leaves whose block only the cache
    references; a block a live slot shares is never reclaimed.

    ``on_evict(n)``: called after an eviction pass freed ``n`` blocks (the
    server's counter).  ``host_tier``: an optional
    ``serving.kv_host_tier.HostKVTier``; None keeps every path tier-free."""

    def __init__(self, pool: KVBlockPool, on_evict=None):
        self.pool = pool
        self.block = pool.block
        self.on_evict = on_evict
        self.host_tier = None
        self._root = _Node((), None, -1)
        self._lock = threading.Lock()
        self._tick = 0
        self.entries = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.hit_tokens = 0
        self.inserted_tokens = 0
        self.host_hits = 0
        self.host_hit_tokens = 0

    def match(self, ids: List[int]) -> PagedMatch:
        """Longest cached prefix of ``ids`` (whole blocks, at most
        ``len(ids) - 1`` tokens); increfs every matched block.

        With a host tier, the walk goes on past the device frontier through
        contiguous ``tier="host"`` chunks and, when the tier's crossover
        says a copy beats a recompute, claims their payloads (the nodes stay
        as stubs; the restoring request's insert re-promotes them)."""
        max_blocks = max(0, (len(ids) - 1) // self.block)
        host_payloads: list = []
        with self._lock:
            self._tick += 1
            node, depth, blocks = self._root, 0, []
            while depth < max_blocks:
                child = node.children.get(tuple(ids[depth * self.block:(depth + 1) * self.block]))
                if child is None or child.tier != "hbm":
                    break
                child.last_used = self._tick
                blocks.append(child.block_id)
                node, depth = child, depth + 1
            tier = self.host_tier
            if tier is not None and depth < max_blocks:
                hnode, hdepth, chain = node, depth, []
                while hdepth < max_blocks:
                    c = hnode.children.get(tuple(ids[hdepth * self.block:
                                                     (hdepth + 1) * self.block]))
                    if c is None or c.tier != "host":
                        break
                    chain.append(c)
                    hnode, hdepth = c, hdepth + 1
                if chain and tier.should_restore(len(chain)):
                    for c in chain:
                        payload = tier.claim(c)
                        if payload is None:
                            break  # a stub: the chunk's bytes are gone
                        host_payloads.append(payload)
                        c.last_used = self._tick
            if not blocks and not host_payloads:
                self.misses += 1
                return PagedMatch(0, [])
            if blocks:
                self.pool.incref(blocks)
            self.hits += 1
            self.hit_tokens += depth * self.block
            if host_payloads:
                self.host_hits += 1
                self.host_hit_tokens += len(host_payloads) * self.block
            return PagedMatch(depth * self.block, blocks, host_payloads)

    def insert(self, ids: List[int], block_ids: Sequence[int]) -> int:
        """Record ``block_ids`` for the first ``len(block_ids)`` whole blocks
        of ``ids``; newly recorded blocks gain the cache's reference, and a
        spilled or stub chunk is re-promoted onto the caller's block (its
        stale host copy dropped).  Returns the newly cached tokens."""
        if len(block_ids) * self.block > len(ids):
            raise ValueError(f"{len(block_ids)} blocks cover {len(block_ids) * self.block} "
                             f"tokens > prompt {len(ids)}")
        new_tokens = 0
        with self._lock:
            self._tick += 1
            node = self._root
            for d, bid in enumerate(block_ids):
                key = tuple(ids[d * self.block:(d + 1) * self.block])
                child = node.children.get(key)
                if child is None:
                    self.pool.incref([bid])
                    child = _Node(key, node, bid)
                    node.children[key] = child
                    self.entries += 1
                    new_tokens += self.block
                elif child.tier != "hbm":
                    self.pool.incref([bid])
                    child.block_id = bid
                    child.tier = "hbm"
                    if self.host_tier is not None:
                        self.host_tier.drop(child)
                    self.entries += 1
                    new_tokens += self.block
                child.last_used = self._tick
                node = child
            self.inserted_tokens += new_tokens
        return new_tokens

    @staticmethod
    def _hbm_children(node: _Node) -> bool:
        """Any direct child still holding a pool block: host stubs do not
        keep a node from being evicted."""
        return any(c.tier == "hbm" for c in node.children.values())

    def evictable_blocks(self) -> int:
        """Blocks the cache could release now: device nodes whose block only
        the cache references."""
        with self._lock:
            return sum(1 for n in self._walk()
                       if n.tier == "hbm" and self.pool.refcount(n.block_id) == 1)

    def evict(self, need_blocks: int) -> int:
        """Release up to ``need_blocks`` blocks, LRU leaves first (a parent
        becomes a candidate once it has no device children); returns blocks
        freed.  With a host tier, each victim's bytes are offered to host
        RAM first: kept, the node turns ``tier="host"``; declined, it leaves
        the trie with its spilled descendants."""
        freed = spilled = 0
        tier = self.host_tier
        with self._lock:
            heap = [(n.last_used, n.uid, n) for n in self._walk()
                    if n.tier == "hbm" and not self._hbm_children(n)
                    and self.pool.refcount(n.block_id) == 1]
            heapq.heapify(heap)
            while heap and freed < need_blocks:
                _, _, leaf = heapq.heappop(heap)
                if (leaf.tier != "hbm" or self._hbm_children(leaf)
                        or leaf.parent.children.get(leaf.key) is not leaf
                        or self.pool.refcount(leaf.block_id) != 1):
                    continue
                bid = leaf.block_id
                kept = False
                if tier is not None:
                    payload = tier.snapshot_block(bid)
                    if payload is None:
                        tier.decline()
                    else:
                        kept = tier.offer(leaf, payload)
                if kept:
                    spilled += 1
                    leaf.block_id = -1
                    leaf.tier = "host"
                else:
                    leaf.parent.children.pop(leaf.key)
                    self._drop_host_subtree(leaf)
                self.entries -= 1
                self.evictions += 1
                freed += self.pool.decref([bid])
                parent = leaf.parent
                if (parent is not self._root and parent.tier == "hbm"
                        and not self._hbm_children(parent)
                        and self.pool.refcount(parent.block_id) == 1):
                    heapq.heappush(heap, (parent.last_used, parent.uid, parent))
        if freed:
            log.info("paged prefix cache evicted %d block(s) (%d tokens, %d spilled to host)",
                     freed, freed * self.block, spilled)
            if self.on_evict is not None:
                self.on_evict(freed)
        return freed

    def _drop_host_subtree(self, node: _Node) -> None:
        """Retire the tier entries of every host node under ``node``
        (inclusive), which left the trie; caller holds ``_lock``."""
        if self.host_tier is None:
            return
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n.tier == "host":
                self.host_tier.drop(n)

    def _walk(self):
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def clear(self) -> int:
        """Drop every node (decref the device ones, expire the host ones);
        returns blocks freed."""
        with self._lock:
            ids = [n.block_id for n in self._walk() if n.tier == "hbm"]
            self._root = _Node((), None, -1)
            self.entries = 0
            if self.host_tier is not None:
                self.host_tier.clear()
            return self.pool.decref(ids) if ids else 0

    def stats(self) -> Dict[str, object]:
        with self._lock:
            lookups = self.hits + self.misses
            out = {
                "enabled": True,
                "paged": True,
                "block_tokens": self.block,
                "entries": self.entries,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "evictions": self.evictions,
                "cached_tokens_served": self.hit_tokens,
                "inserted_tokens": self.inserted_tokens,
            }
        tier = self.host_tier
        if tier is not None:
            out["host_hits"] = self.host_hits
            out["host_hit_tokens"] = self.host_hit_tokens
            out["host_tier"] = tier.stats()
        return out


class PagedKVRuntime:
    """What the serving stack shares about one paged pool: the host
    allocator, the device pool tensors (one list of per-layer dicts, written
    in place by every engine run and kept across runs, so cached blocks
    survive busy periods) and the optional prefix cache."""

    def __init__(self, arrays, pool: KVBlockPool, max_seq: int,
                 cache: Optional[PagedPrefixCache] = None):
        if max_seq % pool.block:
            raise ValueError(f"max_seq {max_seq} not a multiple of block {pool.block}")
        self.arrays = arrays
        self.pool = pool
        self.cache = cache
        self.max_seq = max_seq
        self.block = pool.block
        self.blocks_per_seq = max_seq // pool.block
        self.pool_bytes = sum(t.numel() * t.element_size() for layer in arrays
                              for t in layer.values())

    def need_tokens(self, n_prompt: int, max_new: int) -> int:
        """Tokens a request reserves: prompt + its budget clamped to the
        context (the engine's own budget formula)."""
        return n_prompt + max(0, min(max_new, self.max_seq - n_prompt))

    def ensure_free(self, n_blocks: int) -> bool:
        """True when ``n_blocks`` are free, evicting unreferenced cached
        blocks (LRU) to get there if needed."""
        short = n_blocks - self.pool.n_free
        if short > 0 and self.cache is not None:
            self.cache.evict(short)
        return self.pool.n_free >= n_blocks

    def stats(self) -> Dict[str, object]:
        out = dict(self.pool.stats())
        out["blocks_per_seq"] = self.blocks_per_seq
        out["pool_bytes"] = self.pool_bytes
        out["prefix_cache"] = (self.cache.stats() if self.cache is not None
                               else {"enabled": False})
        return out
