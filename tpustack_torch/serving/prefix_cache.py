"""Cross-request prefix KV cache, dense form: the host radix store the dense
engines (``LLM_MAX_BATCH=1``, ``TPUSTACK_PAGED_KV=0``) reuse prompt KV
through.

The port's copy of ``tpustack/serving/prefix_cache.py`` (``PrefixCache``,
``PrefixMatch``): the same trie, snap, insert, LRU byte cap and stats, over
CPU tensors in the engine's cache dtype (bf16, or int8 with float32 scales
under ``kv_quant``) where the JAX store holds numpy arrays.  The device side
(extract, restore, suffix-only prefill) is ``Generator._extract_kv`` /
``_restore_kv_rows`` / ``_prefill_from``.

- A chunked radix trie on token ids: prefixes snap to ``chunk_tokens``
  boundaries, every edge is one chunk of ids and a node holds that chunk's
  K/V slice for every layer.
- Host-resident: the capacity is host RAM, and a hit costs one host->device
  copy of the reused prefix (``Generator._prefix_to_device`` keeps the
  hottest few on the device).
- Bounded: ``capacity_bytes`` caps resident bytes; eviction removes least
  recently used leaves, so every stored prefix stays contiguous from the
  root.
- ``match`` never returns the whole prompt: the engine must prefill at least
  one token for its logits.

Thread-safe: the server's handler threads look up and read stats while the
engine thread inserts.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tpustack_torch.utils import get_logger

log = get_logger("serving.prefix_cache")

#: per-layer K/V segment: {"k": [n, kv_heads, head_dim], "v": ..., and
#: "k_scale"/"v_scale" [n, kv_heads] when the engine cache is int8}
KVSegment = List[Dict[str, torch.Tensor]]

_NODE_UIDS = itertools.count(1)


class _Node:
    """One chunk of a cached prefix; ``uid`` is process-unique and never
    reused, so a path's uid tuple is a stable identity for memoisation."""

    __slots__ = ("key", "parent", "children", "kv", "nbytes", "last_used", "uid")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"],
                 kv: Optional[KVSegment], nbytes: int):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.kv = kv
        self.nbytes = nbytes
        self.last_used = 0
        self.uid = next(_NODE_UIDS)


class PrefixMatch:
    """A lookup: ``length`` cached tokens (chunk-snapped, 0 on a miss), their
    assembled per-layer K/V (None on a miss) and ``key``, the matched path's
    identity (two matches with one key carry the same kv object)."""

    __slots__ = ("length", "kv", "key")

    def __init__(self, length: int, kv: Optional[KVSegment], key=None):
        self.length = length
        self.kv = kv
        self.key = key


def _segment_bytes(kv: KVSegment) -> int:
    return sum(int(a.nbytes) for layer in kv for a in layer.values())


class PrefixCache:
    """Radix (chunked-trie) store of finished prefill KV segments.

    ``chunk_tokens``: the snap granularity.  ``capacity_bytes``: the
    resident-byte cap (LRU leaf eviction).  ``on_evict(n_nodes)``: called
    under the lock whenever eviction removes nodes (the server's counter)."""

    def __init__(self, chunk_tokens: int = 256, capacity_bytes: int = 512 * 1024 * 1024,
                 on_evict: Optional[Callable[[int], None]] = None):
        if chunk_tokens <= 0:
            raise ValueError(f"chunk_tokens must be positive, got {chunk_tokens}")
        if capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be positive, got {capacity_bytes}")
        self.chunk = chunk_tokens
        self.capacity_bytes = capacity_bytes
        self._on_evict = on_evict
        self._root = _Node((), None, None, 0)
        self._lock = threading.Lock()
        self._tick = 0
        # assembled-prefix memo (path uid tuple -> concatenated KV, LRU):
        # copies on top of the node segments, capped at a quarter of the
        # main capacity and cleared on eviction
        self._assembled: "OrderedDict[Tuple[int, ...], KVSegment]" = OrderedDict()
        self._assembled_bytes = 0
        self._assembled_cap_bytes = max(1, capacity_bytes // 4)
        self.bytes = 0
        self.entries = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.lookups = 0
        self.inserted_tokens = 0
        self.hit_tokens = 0

    def match(self, ids: List[int]) -> PrefixMatch:
        """Longest cached prefix of ``ids``, capped at ``len(ids) - 1`` tokens
        and snapped down to a chunk boundary; touches the path's LRU clocks.
        Returns the assembled host K/V."""
        max_chunks = max(0, (len(ids) - 1) // self.chunk)
        with self._lock:
            self._tick += 1
            self.lookups += 1
            node, depth, path = self._root, 0, []
            while depth < max_chunks:
                child = node.children.get(tuple(ids[depth * self.chunk:(depth + 1) * self.chunk]))
                if child is None:
                    break
                child.last_used = self._tick
                path.append(child)
                node, depth = child, depth + 1
            if not path:
                self.misses += 1
                return PrefixMatch(0, None)
            self.hits += 1
            n = depth * self.chunk
            self.hit_tokens += n
            key = tuple(p.uid for p in path)
            kv = self._assembled.get(key)
            if kv is not None:
                self._assembled.move_to_end(key)
                return PrefixMatch(n, kv, key)
            segs = [p.kv for p in path]  # node segments are immutable
        # assembled outside the lock: a long prefix's concatenation must not
        # stall the engine thread's insert
        kv = [{k: torch.cat([seg[li][k] for seg in segs], dim=0) for k in segs[0][li]}
              for li in range(len(segs[0]))]
        nbytes = _segment_bytes(kv)
        with self._lock:
            if key not in self._assembled:
                self._assembled[key] = kv
                self._assembled_bytes += nbytes
                while (self._assembled_bytes > self._assembled_cap_bytes
                       and len(self._assembled) > 1):
                    _, old = self._assembled.popitem(last=False)
                    self._assembled_bytes -= _segment_bytes(old)
        return PrefixMatch(n, kv, key)

    def snap(self, n_tokens: int) -> int:
        """Largest cacheable boundary <= ``n_tokens`` (a chunk multiple)."""
        return (n_tokens // self.chunk) * self.chunk

    def insert(self, ids: List[int], start: int, kv: KVSegment) -> int:
        """Store the KV segment covering positions ``[start, start + len)``
        of ``ids``; both chunk multiples, and ``[0, start)`` already cached.
        Chunks already present are skipped (their clocks touched).  Returns
        the newly cached tokens."""
        if not kv:
            return 0
        seg_len = kv[0][next(iter(kv[0]))].shape[0]
        if start % self.chunk or seg_len % self.chunk:
            raise ValueError(f"insert not chunk-aligned: start={start} len={seg_len} "
                             f"chunk={self.chunk}")
        if start + seg_len > len(ids):
            raise ValueError(f"segment [{start}, {start + seg_len}) exceeds prompt length "
                             f"{len(ids)}")
        with self._lock:
            self._tick += 1
            node = self._walk_locked(ids, start)
            if node is None:
                # [0, start) was evicted between match and insert: nothing
                # to attach to, and a prefix unreachable from the root is
                # never cached
                return 0
            new_tokens = 0
            for d in range(start // self.chunk, (start + seg_len) // self.chunk):
                key = tuple(ids[d * self.chunk:(d + 1) * self.chunk])
                child = node.children.get(key)
                if child is None:
                    lo = d * self.chunk - start
                    seg = [{k: a[lo:lo + self.chunk].clone() for k, a in layer.items()}
                           for layer in kv]
                    child = _Node(key, node, seg, _segment_bytes(seg))
                    node.children[key] = child
                    self.bytes += child.nbytes
                    self.entries += 1
                    new_tokens += self.chunk
                child.last_used = self._tick
                node = child
            if new_tokens:
                self.inserted_tokens += new_tokens
                self._evict_locked()
            return new_tokens

    def _walk_locked(self, ids: List[int], upto: int) -> Optional[_Node]:
        node = self._root
        for d in range(upto // self.chunk):
            node = node.children.get(tuple(ids[d * self.chunk:(d + 1) * self.chunk]))
            if node is None:
                return None
            node.last_used = self._tick
        return node

    def _evict_locked(self) -> None:
        """Drop least recently used leaves until under capacity; interior
        nodes become leaves (and candidates) as their subtrees drain."""
        n_evicted = 0
        while self.bytes > self.capacity_bytes:
            leaf = None
            stack = [self._root]
            while stack:
                n = stack.pop()
                if n.children:
                    stack.extend(n.children.values())
                elif n is not self._root and (leaf is None or n.last_used < leaf.last_used):
                    leaf = n
            if leaf is None:
                break  # a single over-cap chunk: keep it, nothing smaller
            leaf.parent.children.pop(leaf.key)
            self.bytes -= leaf.nbytes
            self.entries -= 1
            self.evictions += 1
            n_evicted += 1
        if n_evicted:
            self._assembled.clear()
            self._assembled_bytes = 0
            log.info("prefix cache evicted %d chunk(s) (%d tokens), %.1f MB resident",
                     n_evicted, n_evicted * self.chunk, self.bytes / 1e6)
            if self._on_evict is not None:
                self._on_evict(n_evicted)

    def clear(self) -> None:
        with self._lock:
            self._root = _Node((), None, None, 0)
            self._assembled.clear()
            self._assembled_bytes = 0
            self.bytes = 0
            self.entries = 0

    def stats(self) -> Dict[str, object]:
        """Config and live counters, for ``/props``."""
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "enabled": True,
                "chunk_tokens": self.chunk,
                "capacity_mb": round(self.capacity_bytes / (1024 * 1024), 3),
                "resident_bytes": self.bytes,
                "assembled_bytes": self._assembled_bytes,
                "entries": self.entries,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
                "evictions": self.evictions,
                "cached_tokens_served": self.hit_tokens,
                "inserted_tokens": self.inserted_tokens,
            }
