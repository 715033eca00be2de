"""Tiered, governor-integrated caching for the serving layer.

"Overview of Caching Mechanisms to Improve Hadoop Performance" makes the
case that INTER-JOB block caching is the dominant lever once the same data
is read by many jobs — exactly the HailServer's regime, where concurrent
tenants hammer the same hot replicas.  Two tiers live here:

**Tier 1 — ``BlockCache``** holds the decoded per-split device input the
record readers otherwise rebuild on every call: for one (replica,
block-subset, filter column, projection) group, the gathered key column,
the stacked projection columns, the bad-row mask and the root directories
(``query._gather_replica_inputs``).  That is the analogue of a
datanode's hot-block page cache: the gather + stack + checksum
verification is the per-read cost the cache removes, while the fused
reader's launch count stays one per (split, batch).

The policy is SCAN-RESISTANT, not pure LRU (under pure LRU, sequential
split access at a half-working-set budget evicts every block before it is
reused): SLRU segmentation plus TinyLFU-style admission:

* entries land in a PROBATION segment; a hit promotes them to a PROTECTED
  segment (bounded at ``protected_frac`` of capacity, its LRU overflow
  demoted back to probation) — one-touch entries can never displace
  entries that have proven reuse;
* when admitting a new entry would force evictions, the candidate must
  have a strictly HIGHER score than every would-be victim, else it is
  REJECTED (``stats.admission_rejects``) and the residents stay.  The
  score is (ghost frequency, governor column heat): a decayed per-key
  touch count that survives eviction, tie-broken by the store's
  ``AccessLog`` per-(replica, column) read totals — the same frequency
  data the IndexGovernor's eviction policy uses, so a one-touch
  sequential scan (frequency 1, cold column) can no longer flush blocks
  with demonstrated reuse.

**Tier 2 — ``ResultCache``** caches MATERIALIZED query answers keyed
``(filter col, lo, hi, projection, store version)``: a repeated range — or
one subsumed by a cached superset range, when the filter column is in the
projection — skips the fused scan entirely (zero reader launches).  Entries
carry an attribution recipe (per-replica index/full-scan block counts from
the fill-time read) that the server replays through
``governor.attribute_read`` on every hit, so a hot-but-result-cached index
never looks LRU-cold to the governor.

Coherence (both tiers): the store's DESTRUCTIVE transitions —
``commit_block_indexes``, ``demote_replica``, ``quarantine_block``,
``repair_blocks`` — invalidate them.  The BlockCache drops the touched
replica's entries (block-granular for quarantine/repair, with the
SURVIVING blocks of a partially hit entry re-keyed and re-accounted at
their true residual byte size); the ResultCache is dropped wholesale and
additionally keyed by ``BlockStore.version``, which those transitions
bump — a stale result is unreachable even if an invalidation hook is
bypassed.

Cache-owned buffers must not change after the fill.  PyTorch has no
read-only tensor, so tier 1 relies on ownership instead: its values are
tensors the gather made fresh (advanced indexing and ``torch.stack``
copy), which the store never hands to anyone else, and nothing on the read
path writes a reader input in place — the store's own transitions copy on
write (``core/store.py``).  Tier 2 holds host numpy answers and freezes
them at fill (``writeable=False``), so a caller scribbling on a served
answer raises instead of corrupting every future hit for that key.

Byte accounting counts ``numel() * element_size()`` for tensors and
``size * itemsize`` for numpy arrays, so admission and eviction decide as
in the JAX package.  Cache traffic is still GOVERNED traffic: hits and
misses land
in ``kernels.ops`` ``reader_stats`` (``cache_hits`` / ``cache_misses`` /
``result_cache_hits`` / ``result_cache_misses``), always attributed to the
innermost ``stats_scope``.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Hashable, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0          # entries dropped for capacity
    admission_rejects: int = 0  # candidates refused by the scan filter
    invalidations: int = 0      # entries dropped by store transitions
    partial_invalidations: int = 0  # entries re-keyed to their residual
    promotions: int = 0         # probation -> protected (proven reuse)
    bytes_cached: int = 0       # current resident bytes
    peak_bytes: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


def _nbytes(value: Any) -> int:
    """Total bytes of a tuple/dict of tensors and numpy arrays."""
    if isinstance(value, dict):
        return sum(_nbytes(v) for v in value.values())
    if isinstance(value, (tuple, list)):
        return sum(_nbytes(v) for v in value)
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    if isinstance(value, np.ndarray):
        return int(value.size * value.itemsize)
    return 0


def _slice_blocks(value: Any, keep: np.ndarray):
    """Take the ``keep`` positions along every array's leading (block)
    axis — used to shrink a cached gather to its surviving blocks after a
    block-granular invalidation (a tensor takes an index tensor on its own
    device)."""
    if isinstance(value, dict):
        return {k: _slice_blocks(v, keep) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_slice_blocks(v, keep) for v in value)
    if isinstance(value, torch.Tensor):
        return value[torch.as_tensor(keep, device=value.device)]
    return value[keep]


class BlockCache:
    """Scan-resistant segmented cache over decoded per-split reader inputs.

    Keys are ``(replica_id, block_tuple, col, projection)`` tuples — the
    leading replica id is the invalidation handle for the store's
    destructive transitions, the block tuple the handle for block-granular
    ones.  ``capacity_bytes=None`` means unbounded (cache everything,
    admission never rejects).  ``scan_resistant=False`` degrades to the
    old pure-LRU policy (kept for A/B measurement)."""

    # ghost-frequency decay: after this many touches, halve every count —
    # TinyLFU's sliding window, so ancient popularity eventually expires
    FREQ_WINDOW = 4096

    def __init__(self, capacity_bytes: Optional[int] = None, *,
                 protected_frac: float = 0.8, scan_resistant: bool = True):
        self.capacity_bytes = capacity_bytes
        self.protected_frac = protected_frac
        self.scan_resistant = scan_resistant
        # key -> (value, nbytes); probation admits, protected holds reuse
        self._probation: "collections.OrderedDict[Hashable, tuple[Any, int]]" \
            = collections.OrderedDict()
        self._protected: "collections.OrderedDict[Hashable, tuple[Any, int]]" \
            = collections.OrderedDict()
        self._protected_bytes = 0
        self._freq: collections.Counter = collections.Counter()
        self._freq_touches = 0
        self.store: Any = None         # set by attach(); heat tie-break
        self.stats = CacheStats()

    def attach(self, store) -> "BlockCache":
        """Install on a ``BlockStore`` — the readers consult
        ``store.block_cache``, the store invalidates on its destructive
        transitions, and the admission filter reads the store's
        ``AccessLog`` for its column-heat signal."""
        store.block_cache = self
        self.store = store
        return self

    def __len__(self) -> int:
        return len(self._probation) + len(self._protected)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._probation or key in self._protected

    @property
    def protected_capacity(self) -> float:
        if self.capacity_bytes is None:
            return float("inf")
        return self.capacity_bytes * self.protected_frac

    # -- admission signal ---------------------------------------------------

    def _touch(self, key: Hashable):
        """Ghost frequency: counts every demand (hit or miss), survives
        eviction, decays by halving every ``FREQ_WINDOW`` touches."""
        self._freq[key] += 1
        self._freq_touches += 1
        if self._freq_touches >= self.FREQ_WINDOW:
            self._freq = collections.Counter(
                {k: c >> 1 for k, c in self._freq.items() if c > 1})
            self._freq_touches = 0

    def _score(self, key: Hashable) -> tuple[int, int]:
        """(ghost frequency, governor column heat) — the admission score.
        Heat is the store AccessLog's lifetime (hits + misses) for the
        key's (replica, filter column): reusing the governor's own
        frequency data, a key of a column with real query history outranks
        a one-touch scan over a cold column at equal key frequency."""
        heat = 0
        log = getattr(self.store, "access_log", None)
        if log is not None and isinstance(key, tuple) and len(key) >= 3:
            heat = log.heat(key[0], key[2])
        return (self._freq.get(key, 0), heat)

    # -- read/write ---------------------------------------------------------

    def get(self, key: Hashable):
        """-> cached value or None; counts the hit/miss and, on a
        probation hit, promotes the entry to the protected segment."""
        from repro_torch.kernels import ops
        self._touch(key)
        ent = self._protected.get(key)
        if ent is not None:
            self._protected.move_to_end(key)
        else:
            ent = self._probation.pop(key, None)
            if ent is not None:                 # proven reuse: promote
                self._protected[key] = ent
                self._protected_bytes += ent[1]
                self.stats.promotions += 1
                self._shrink_protected()
        if ent is None:
            self.stats.misses += 1
            ops.DISPATCH_COUNTS["cache_misses"] += 1
            return None
        self.stats.hits += 1
        ops.DISPATCH_COUNTS["cache_hits"] += 1
        return ent[0]

    def _shrink_protected(self):
        """SLRU overflow: protected LRU demotes back to probation MRU —
        it stays resident but becomes evictable again."""
        while self._protected_bytes > self.protected_capacity \
                and len(self._protected) > 1:
            k, ent = self._protected.popitem(last=False)
            self._protected_bytes -= ent[1]
            self._probation[k] = ent

    def _eviction_order(self):
        """(segment, key, nbytes) in eviction order: probation LRU first,
        then (only if probation runs dry) protected LRU."""
        for k, (_, nb) in self._probation.items():
            yield self._probation, k, nb
        for k, (_, nb) in self._protected.items():
            yield self._protected, k, nb

    def put(self, key: Hashable, value: Any):
        from repro_torch.kernels import ops
        nbytes = _nbytes(value)
        if self.capacity_bytes is not None and nbytes > self.capacity_bytes:
            return                       # larger than the whole budget
        for seg in (self._probation, self._protected):
            old = seg.pop(key, None)
            if old is not None:          # refresh in place (same segment)
                self.stats.bytes_cached -= old[1]
                if seg is self._protected:
                    self._protected_bytes += nbytes - old[1]
                seg[key] = (value, nbytes)
                self.stats.bytes_cached += nbytes
                # a refresh that GREW must still respect capacity — evict
                # around the refreshed entry (it's resident, not a
                # candidate, so the admission filter doesn't apply)
                self._evict_over_capacity(exclude=key)
                self._bump_peak()
                return
        if self.capacity_bytes is not None:
            need = self.stats.bytes_cached + nbytes - self.capacity_bytes
            if need > 0:
                victims, freed = [], 0
                for seg, k, nb in self._eviction_order():
                    if freed >= need:
                        break
                    victims.append((seg, k, nb))
                    freed += nb
                if self.scan_resistant:
                    cand = self._score(key)
                    if any(self._score(k) >= cand for _, k, _ in victims):
                        # a would-be victim is at least as valuable as the
                        # candidate: keep the residents (scan resistance)
                        self.stats.admission_rejects += 1
                        ops.DISPATCH_COUNTS["cache_admission_rejects"] += 1
                        return
                for seg, k, nb in victims:
                    del seg[k]
                    self.stats.bytes_cached -= nb
                    if seg is self._protected:
                        self._protected_bytes -= nb
                    self.stats.evictions += 1
        self._probation[key] = (value, nbytes)
        self.stats.bytes_cached += nbytes
        self._bump_peak()

    def _evict_over_capacity(self, exclude: Hashable = None):
        """Plain capacity eviction (no admission filter), optionally
        sparing one resident key."""
        if self.capacity_bytes is None:
            return
        while self.stats.bytes_cached > self.capacity_bytes:
            victim = next(((seg, k, nb) for seg, k, nb
                           in self._eviction_order() if k != exclude), None)
            if victim is None:
                return
            seg, k, nb = victim
            del seg[k]
            self.stats.bytes_cached -= nb
            if seg is self._protected:
                self._protected_bytes -= nb
            self.stats.evictions += 1

    def _bump_peak(self):
        self.stats.peak_bytes = max(self.stats.peak_bytes,
                                    self.stats.bytes_cached)

    # -- invalidation -------------------------------------------------------

    def invalidate_replica(self, replica_id: int):
        """Drop every entry of one replica — called by the store's
        destructive transitions (index commit / demotion)."""
        for seg in (self._probation, self._protected):
            for k in [k for k in seg if k[0] == replica_id]:
                _, nbytes = seg.pop(k)
                self.stats.bytes_cached -= nbytes
                if seg is self._protected:
                    self._protected_bytes -= nbytes
                self.stats.invalidations += 1

    def invalidate_blocks(self, replica_id: int, block_ids: Sequence[int]):
        """Drop the BAD blocks from every entry whose gathered block set
        intersects ``block_ids`` — quarantine/repair touch single blocks,
        so evicting the whole replica would throw away every hot split for
        one bad block.  An entry with surviving blocks is re-keyed to the
        surviving subset and re-accounted at its TRUE RESIDUAL byte size
        (sliced arrays, recounted) — capacity eviction must never charge
        the at-admission size for a partially invalidated entry."""
        bad = {int(b) for b in block_ids}
        for seg in (self._probation, self._protected):
            stale = [k for k in seg
                     if k[0] == replica_id and bad.intersection(k[1])]
            for k in stale:
                value, nbytes = seg.pop(k)
                self.stats.bytes_cached -= nbytes
                if seg is self._protected:
                    self._protected_bytes -= nbytes
                self.stats.invalidations += 1
                keep = np.asarray([i for i, b in enumerate(k[1])
                                   if int(b) not in bad], dtype=np.int64)
                if len(keep) == 0:
                    continue
                new_key = (k[0], tuple(k[1][i] for i in keep)) + k[2:]
                if new_key in seg or new_key in self._probation \
                        or new_key in self._protected:
                    continue             # residual already cached directly
                residual = _slice_blocks(value, keep)
                res_bytes = _nbytes(residual)    # true residual, recounted
                seg[new_key] = (residual, res_bytes)
                self.stats.bytes_cached += res_bytes
                if seg is self._protected:
                    self._protected_bytes += res_bytes
                self.stats.partial_invalidations += 1

    def clear(self):
        self.stats.invalidations += len(self)
        self._probation.clear()
        self._protected.clear()
        self._protected_bytes = 0
        self.stats.bytes_cached = 0

    # -- auditing -----------------------------------------------------------

    def recount(self) -> int:
        """Recompute resident bytes from the cached values themselves —
        the byte-accounting oracle ``stats.bytes_cached`` must equal (the
        regression tests assert it after every mutation kind)."""
        total = 0
        for seg in (self._probation, self._protected):
            for value, nbytes in seg.values():
                actual = _nbytes(value)
                assert nbytes == actual, \
                    f"accounting drift: stored {nbytes} != actual {actual}"
                total += actual
        return total


# ---------------------------------------------------------------------------
# Tier 2: the query-result cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResultEntry:
    """One materialized answer: the matching rows (projection + __rowid__,
    host arrays), plus the attribution recipe — per-replica (replica_id,
    index-scanned blocks, full-scanned blocks) totals of the read that
    produced it, replayed through ``governor.attribute_read`` on every hit
    so cached traffic keeps feeding the AccessLog."""
    rows: dict
    n_rows: int
    attribution: tuple            # ((replica_id, n_index, n_full), ...)
    nbytes: int = 0


@dataclasses.dataclass
class ResultCacheStats:
    hits: int = 0
    misses: int = 0
    subsumed_hits: int = 0        # served by narrowing a superset range
    evictions: int = 0
    invalidations: int = 0
    bytes_cached: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ResultCache:
    """LRU cache of materialized query answers, keyed
    ``(filter col, lo, hi, projection, store version)``.

    The store-version key component makes staleness STRUCTURAL: every
    destructive transition bumps ``BlockStore.version`` (and calls
    ``invalidate_store`` to reclaim the memory), so an entry filled
    against an older store state can never match a lookup.  A lookup
    first tries the exact range; failing that, if the filter column is in
    the projection, it narrows the most recently used SUBSUMING range
    (cached ``lo' <= lo <= hi <= hi'``) by re-filtering its materialized
    rows — repeated AND contained ranges both skip the scan."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        self.capacity_bytes = capacity_bytes
        self._entries: "collections.OrderedDict[tuple, ResultEntry]" \
            = collections.OrderedDict()
        self.stats = ResultCacheStats()

    def attach(self, store) -> "ResultCache":
        store.result_cache = self
        return self

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self):
        return list(self._entries)

    @staticmethod
    def make_key(col: str, lo: int, hi: int, projection, version: int):
        return (col, int(lo), int(hi), tuple(projection), int(version))

    def lookup(self, col: str, lo: int, hi: int, projection,
               version: int) -> Optional[ResultEntry]:
        from repro_torch.kernels import ops
        proj = tuple(projection)
        key = self.make_key(col, lo, hi, proj, version)
        ent = self._entries.get(key)
        if ent is not None:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            ops.DISPATCH_COUNTS["result_cache_hits"] += 1
            return ent
        if col in proj:
            # subsumption: a cached superset range answers a contained one
            # by re-filtering its rows — possible only when the filter
            # column was projected (the cached rows carry its values)
            for k in reversed(self._entries):          # MRU first
                if (k[0] == col and k[3] == proj and k[4] == version
                        and k[1] <= lo and hi <= k[2]):
                    donor = self._entries[k]
                    self._entries.move_to_end(k)
                    vals = donor.rows[col]
                    m = (vals >= lo) & (vals <= hi)
                    # fancy indexing copies, so there is no aliasing here;
                    # freeze anyway so exact and subsumed hits expose the
                    # same read-only contract
                    rows = {}
                    for c, v in donor.rows.items():
                        nv = v[m]
                        nv.setflags(write=False)
                        rows[c] = nv
                    self.stats.hits += 1
                    self.stats.subsumed_hits += 1
                    ops.DISPATCH_COUNTS["result_cache_hits"] += 1
                    return ResultEntry(rows=rows, n_rows=int(m.sum()),
                                       attribution=donor.attribution)
        self.stats.misses += 1
        ops.DISPATCH_COUNTS["result_cache_misses"] += 1
        return None

    def put(self, col: str, lo: int, hi: int, projection, version: int,
            rows: dict, attribution: tuple):
        nbytes = _nbytes(rows)
        if self.capacity_bytes is not None and nbytes > self.capacity_bytes:
            return
        # The entry OWNS these arrays from here on, and hits hand them back
        # without copying (a shallow dict copy shares the buffers).  Freeze
        # them so a caller mutating its answer raises instead of silently
        # corrupting every future hit for this key.  (Tier 1 holds tensors
        # the gather made fresh, which nothing writes — see the module
        # docstring.)
        for v in rows.values():
            if isinstance(v, np.ndarray):
                v.setflags(write=False)
        key = self.make_key(col, lo, hi, projection, version)
        old = self._entries.pop(key, None)
        if old is not None:
            self.stats.bytes_cached -= old.nbytes
        self._entries[key] = ResultEntry(rows=rows, n_rows=len(
            next(iter(rows.values()))) if rows else 0,
            attribution=tuple(attribution), nbytes=nbytes)
        self.stats.bytes_cached += nbytes
        while (self.capacity_bytes is not None
               and self.stats.bytes_cached > self.capacity_bytes):
            _, dropped = self._entries.popitem(last=False)       # LRU out
            self.stats.bytes_cached -= dropped.nbytes
            self.stats.evictions += 1

    def invalidate_store(self):
        """Destructive store transition: every cached answer (and its
        attribution recipe — the plan it replays just changed) is stale.
        The version key already makes them unreachable; this reclaims the
        memory and counts the event."""
        self.stats.invalidations += len(self._entries)
        self._entries.clear()
        self.stats.bytes_cached = 0
