"""Host-RAM second tier for the paged KV block pool.

The port's copy of ``tpustack/serving/kv_host_tier.py`` (``HostKVTier``,
``block_nbytes``): an LRU arena of spilled prefix-cache blocks in host RAM,
sized by ``TPUSTACK_KV_HOST_TIER_MB`` (0 = off: nothing constructs, and the
trie and pool paths are the tier-free ones).

``PagedPrefixCache`` drives every step (the tier never walks the trie):

- **Spill**: ``evict()`` offers each refcount-0 victim to the tier before
  the block dies.  ``snapshot_block`` gathers the block's rows of every
  pool tensor (per layer ``k``/``v`` and, under int8 KV, ``k_scale``/
  ``v_scale``) into one byte buffer on the device and copies it to the host
  once, into pinned memory (:func:`pack_block`), where the JAX tier makes
  one synchronous copy per layer and tensor.  The copy is issued on the
  current stream, behind every write already queued there, and waited for
  before the victim's block is released, so a reallocation cannot race it;
  the copy-cost average times the completed copy.  A tier at capacity
  expires its LRU entries to make room; a copy that fails declines, and
  the victim dies through the normal eviction path.
- **Restore**: a ``match`` that walks past the device frontier into
  host-tier nodes ``claim``s their payloads (the nodes stay in the trie as
  payload-less stubs).  The server allocates fresh pool blocks for them and
  the engine writes the payloads back (``Generator._restore_blocks_paged``)
  on its stream immediately before the warm start that reads them, keeping
  the payloads alive until that wave resolves.  The request's insert then
  re-records the chunks as ordinary device nodes.
- **Crossover guard**: restoring only wins while the per-block copy cost is
  below the per-block prefill cost.  The tier averages both (spill copies
  timed at spill; the engine reports prefill wall per block at resolve) and
  ``should_restore`` answers the match walk; unmeasured means restore.

Accounting: ``spilled_total == restored_total + expired_total +
resident_blocks`` at any quiesce point, and ``resident_bytes <=
capacity_bytes`` always.

Thread-safe: the tier's lock nests inside the trie lock (the cache
initiates every mutation with its own lock held); stats take only the
tier's lock.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional

import torch

from tpustack_torch.utils import get_logger, knobs

log = get_logger("serving.kv_host_tier")

__all__ = ["BlockPayload", "HostKVTier", "block_nbytes", "pack_block"]


def block_nbytes(arrays) -> int:
    """Host bytes one spilled block occupies: every layer's per-block slice
    of every pool tensor (k/v and the int8 scales when present)."""
    total = 0
    for layer in arrays:
        for v in layer.values():
            total += int(torch.Size(v.shape[1:]).numel()) * v.element_size()
    return total


class BlockPayload(list):
    """One spilled block: a list (per layer) of ``{key: host tensor}`` like
    the JAX tier's payload, whose tensors are views into ``flat``, one
    (pinned, on a CUDA pool) byte buffer.  ``layout`` lists ``(layer, key,
    byte offset, nbytes, dtype, per-block shape)`` for the restore."""

    def __init__(self, layers, flat: torch.Tensor, layout):
        super().__init__(layers)
        self.flat = flat
        self.layout = layout


def pack_block(arrays, block_id: int) -> BlockPayload:
    """Copy block ``block_id`` of every pool tensor to the host in one copy.

    The rows are gathered into one byte buffer on the pool's device (wider
    dtypes first, so every slice stays aligned to its element size), then
    copied into pinned host memory on the current stream; the call returns
    once that copy has completed."""
    items = [(li, k, t) for li, layer in enumerate(arrays) for k, t in layer.items()]
    items.sort(key=lambda it: -it[2].element_size())
    layout, parts, off = [], [], 0
    for li, k, t in items:
        row = t[block_id]
        nbytes = row.numel() * row.element_size()
        layout.append((li, k, off, nbytes, t.dtype, tuple(row.shape)))
        parts.append(row.reshape(-1).view(torch.uint8))
        off += nbytes
    dev = torch.cat(parts)
    if dev.device.type == "cuda":
        flat = torch.empty(off, dtype=torch.uint8, pin_memory=True)
        flat.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()  # never hand out bytes before the copy landed
    else:
        flat = dev.clone()
    layers: List[Dict[str, torch.Tensor]] = [{} for _ in arrays]
    for li, k, o, n, dtype, shape in layout:
        layers[li][k] = flat[o:o + n].view(dtype).view(shape)
    return BlockPayload(layers, flat, layout)


class _Entry:
    __slots__ = ("node", "payload", "nbytes")

    def __init__(self, node, payload, nbytes: int):
        self.node = node
        self.payload = payload
        self.nbytes = nbytes


class HostKVTier:
    """LRU host-RAM arena for spilled prefix-cache blocks (one pool).

    ``arrays_fn`` returns the device pool tensors (the runtime's
    ``arrays``); ``snapshot_block`` reads a block's rows through it.
    ``metrics`` is the server's catalog dict (optional): the spill, restore
    and expiry counters move at event time."""

    def __init__(self, capacity_bytes: int, pool, arrays_fn: Optional[Callable[[], list]] = None,
                 metrics=None, crossover: Optional[bool] = None):
        self.pool = pool
        self.capacity_bytes = max(0, int(capacity_bytes))
        self.arrays_fn = arrays_fn
        self.metrics = metrics
        self._lock = threading.Lock()
        # spilled entries, coldest first (keyed by trie-node uid)
        self._entries: "OrderedDict[int, _Entry]" = OrderedDict()
        self._bytes = 0
        self._block_nbytes = 0  # measured at the first spill
        self.spilled_total = 0
        self.restored_total = 0
        self.expired_total = 0
        self.spill_declined_total = 0
        # the crossover's averages: per-block copy seconds (at spill) and
        # per-block recompute seconds (prefill wall reported at resolve)
        self._copy_s_ema: Optional[float] = None
        self._prefill_s_ema: Optional[float] = None
        # resolved at construction (a typo fails at boot); ``crossover``
        # overrides the knob for in-process constructions
        self._crossover = (knobs.get_bool("TPUSTACK_KV_HOST_TIER_CROSSOVER")
                           if crossover is None else bool(crossover))

    @property
    def resident_blocks(self) -> int:
        return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    @property
    def capacity_blocks(self) -> int:
        """Blocks the byte cap holds: measured at the first spill, estimated
        from the pool tensors (:func:`block_nbytes`) before it."""
        bn = self._block_nbytes
        if not bn and self.arrays_fn is not None:
            try:
                bn = block_nbytes(self.arrays_fn())
            except Exception:
                log.debug("host-tier capacity estimate unavailable", exc_info=True)
                return 0
        return (self.capacity_bytes // bn) if bn else 0

    # -------------------------------------------------------------- spill
    def snapshot_block(self, block_id: int) -> Optional[BlockPayload]:
        """Copy block ``block_id``'s KV device -> host (:func:`pack_block`);
        None when it cannot be made (no arrays provider, a failed copy)."""
        if self.arrays_fn is None:
            return None
        t0 = time.time()
        try:
            payload = pack_block(self.arrays_fn(), block_id)
        except Exception:
            log.debug("host-tier spill copy declined", exc_info=True)
            return None
        dt = time.time() - t0
        with self._lock:
            self._copy_s_ema = dt if self._copy_s_ema is None else 0.8 * self._copy_s_ema + 0.2 * dt
        return payload

    def offer(self, node, payload) -> bool:
        """Record ``payload`` against trie ``node``, expiring LRU entries to
        make room (their nodes become stubs).  A payload larger than the
        whole cap is declined: False, and the victim dies as before."""
        nbytes = sum(int(a.nbytes) for layer in payload for a in layer.values())
        n_expired = 0
        with self._lock:
            if not self._block_nbytes:
                self._block_nbytes = nbytes
            if nbytes > self.capacity_bytes:
                self.spill_declined_total += 1
                return False
            while self._bytes + nbytes > self.capacity_bytes and self._entries:
                _, old = self._entries.popitem(last=False)
                self._bytes -= old.nbytes
                self.expired_total += 1
                n_expired += 1
            self._entries[node.uid] = _Entry(node, payload, nbytes)
            self._bytes += nbytes
            self.spilled_total += 1
            resident = self._bytes
        m = self.metrics
        if m is not None:
            m["tpustack_llm_kv_host_spilled_blocks_total"].inc()
            if n_expired:
                m["tpustack_llm_kv_host_expired_blocks_total"].inc(n_expired)
            m["tpustack_llm_kv_host_resident_bytes"].set(resident)
        return True

    def decline(self) -> None:
        """A spill was not attempted (failed copy, no provider)."""
        with self._lock:
            self.spill_declined_total += 1

    # ------------------------------------------------------------ restore
    def claim(self, node) -> Optional[BlockPayload]:
        """Pop ``node``'s payload for a pool-side restore; None when the
        entry already expired."""
        with self._lock:
            e = self._entries.pop(node.uid, None)
            if e is None:
                return None
            self._bytes -= e.nbytes
            self.restored_total += 1
            resident = self._bytes
        m = self.metrics
        if m is not None:
            m["tpustack_llm_kv_host_restored_blocks_total"].inc()
            m["tpustack_llm_kv_host_resident_bytes"].set(resident)
        return e.payload

    def drop(self, node, expired: bool = True) -> None:
        """Discard ``node``'s entry without restoring (its subtree left the
        trie, or its chunk was re-inserted as a device node): counted
        expired."""
        with self._lock:
            e = self._entries.pop(node.uid, None)
            if e is None:
                return
            self._bytes -= e.nbytes
            if expired:
                self.expired_total += 1
            resident = self._bytes
        m = self.metrics
        if m is not None:
            if expired:
                m["tpustack_llm_kv_host_expired_blocks_total"].inc()
            m["tpustack_llm_kv_host_resident_bytes"].set(resident)

    def abandon(self, n: int) -> None:
        """``n`` claimed payloads never reached the pool (the restore's
        allocation failed): restored -> expired, so the ledger stays exact."""
        with self._lock:
            self.restored_total -= n
            self.expired_total += n
        m = self.metrics
        if m is not None:
            m["tpustack_llm_kv_host_expired_blocks_total"].inc(n)

    # ---------------------------------------------------------- crossover
    def note_prefill(self, n_blocks: int, wall_s: float) -> None:
        """A prefill covering ``n_blocks`` fresh blocks took ``wall_s``: the
        recompute-cost average the crossover compares the copy cost with."""
        if n_blocks <= 0 or wall_s <= 0:
            return
        per = wall_s / n_blocks
        with self._lock:
            self._prefill_s_ema = (per if self._prefill_s_ema is None
                                   else 0.8 * self._prefill_s_ema + 0.2 * per)

    def should_restore(self, n_blocks: int) -> bool:
        """Copy unless the per-block copy cost exceeds the per-block prefill
        cost; unmeasured either way (or the guard off) -> restore."""
        del n_blocks  # both costs scale linearly in blocks
        if not self._crossover:
            return True
        with self._lock:
            copy_s, prefill_s = self._copy_s_ema, self._prefill_s_ema
        if copy_s is None or prefill_s is None:
            return True
        return copy_s <= prefill_s

    # -------------------------------------------------------------- admin
    def clear(self) -> int:
        """Drop every resident entry (counted expired); returns how many."""
        with self._lock:
            n = len(self._entries)
            self.expired_total += n
            self._entries.clear()
            self._bytes = 0
        m = self.metrics
        if m is not None:
            if n:
                m["tpustack_llm_kv_host_expired_blocks_total"].inc(n)
            m["tpustack_llm_kv_host_resident_bytes"].set(0)
        return n

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {
                "capacity_bytes": self.capacity_bytes,
                "capacity_blocks": ((self.capacity_bytes // self._block_nbytes)
                                    if self._block_nbytes else 0),
                "resident_blocks": len(self._entries),
                "resident_bytes": self._bytes,
                "block_bytes": self._block_nbytes,
                "spilled_total": self.spilled_total,
                "restored_total": self.restored_total,
                "expired_total": self.expired_total,
                "spill_declined_total": self.spill_declined_total,
                "copy_s_per_block": self._copy_s_ema,
                "prefill_s_per_block": self._prefill_s_ema,
            }
