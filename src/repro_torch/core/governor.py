"""Read attribution for the index governor: the per-store ``AccessLog``.

The record readers attribute every batch of block reads, per (replica,
filter column), through ``attribute_read``: the counts land in the kernel
layer's ``reader_stats`` (``index_scan_blocks[col]`` /
``full_scan_blocks[col]``) and in the store's ``AccessLog``, whose logical
clock makes recency workload-defined.  The governor that reads the log to
evict indexes under a storage budget (``IndexGovernor``) and the replication
controller are not ported yet: the port's ``BlockStore`` has no governor,
so commits are never trimmed and nothing is demoted.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # import cycle guard: store never imports governor
    from repro_torch.core.store import BlockStore


@dataclasses.dataclass
class AccessRecord:
    """Hit/miss counters for one (replica, filter-column) pair."""
    hits: int = 0        # blocks served by an index scan
    misses: int = 0      # blocks that had to full-scan
    last_used: int = 0   # AccessLog clock value of the most recent read


class AccessLog:
    """Per-store read-attribution log (persistent across jobs).

    ``record`` is called by the record readers once per (replica, column)
    batch; the logical ``clock`` advances per call so "recently used" means
    "recently queried", independent of wall time.  A coarser JOB clock
    (``begin_job``, bumped once per run_job) groups reads into jobs:
    ``miss_jobs`` remembers, per filter column, WHICH distinct jobs had to
    full-scan for it.
    """

    def __init__(self):
        self.clock = 0
        self.job_clock = 0
        self.counts: dict[tuple[int, str], AccessRecord] = {}
        self.miss_jobs: dict[str, set[int]] = {}

    def begin_job(self) -> int:
        """Advance the job clock (one executor job)."""
        self.job_clock += 1
        return self.job_clock

    def record(self, replica_id: int, col: str, n_index: int, n_full: int):
        self.clock += 1
        rec = self.counts.setdefault((replica_id, col), AccessRecord())
        rec.hits += int(n_index)
        rec.misses += int(n_full)
        rec.last_used = self.clock
        if n_full > 0:
            self.miss_jobs.setdefault(col, set()).add(self.job_clock)

    def distinct_miss_jobs(self, col: str,
                           exclude_current: bool = False) -> int:
        """How many distinct jobs have full-scanned for ``col`` so far."""
        jobs = self.miss_jobs.get(col, set())
        if exclude_current:
            return len(jobs - {self.job_clock})
        return len(jobs)

    def get(self, replica_id: int, col: str) -> Optional[AccessRecord]:
        return self.counts.get((replica_id, col))

    def heat(self, replica_id: int, col: str) -> int:
        """Lifetime read demand (hits + misses) for one (replica, column)."""
        rec = self.counts.get((replica_id, col))
        return (rec.hits + rec.misses) if rec is not None else 0

    def col_totals(self, col: str) -> AccessRecord:
        """Aggregate over replicas (convergence dashboards / tests)."""
        out = AccessRecord()
        for (rid, c), rec in self.counts.items():
            if c == col:
                out.hits += rec.hits
                out.misses += rec.misses
                out.last_used = max(out.last_used, rec.last_used)
        return out

    def forget_replica(self, replica_id: int):
        """Demotion rewinds a replica's history."""
        for key in [k for k in self.counts if k[0] == replica_id]:
            del self.counts[key]


def note_read(store: "BlockStore", replica_id: int, col: str,
              n_index: int, n_full: int):
    """Attribute one batch of block reads to the store's ``AccessLog``,
    creating the log lazily."""
    log = store.access_log
    if log is None:
        log = store.access_log = AccessLog()
    log.record(replica_id, col, n_index, n_full)


def attribute_read(store: "BlockStore", replica_id: int, col: str,
                   n_index: int, n_full: int):
    """Record-reader hook: ONE source of truth for per-column attribution —
    the ``reader_stats`` per-column counters and the ``AccessLog``."""
    from repro_torch.kernels import ops
    ops.DISPATCH_COUNTS[f"index_scan_blocks[{col}]"] += int(n_index)
    ops.DISPATCH_COUNTS[f"full_scan_blocks[{col}]"] += int(n_full)
    note_read(store, replica_id, col, n_index, n_full)


def note_job_start(store: "BlockStore") -> int:
    """Advance the store's job clock (creating the log lazily) — called at
    the top of every ``run_job``."""
    log = store.access_log
    if log is None:
        log = store.access_log = AccessLog()
    return log.begin_job()


def note_commit(store: "BlockStore", replica_id: int, col: str):
    """Commit-time recency stamp: a freshly built index counts as "just
    used" even before its first read."""
    note_read(store, replica_id, col, 0, 0)
