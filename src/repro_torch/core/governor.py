"""Storage-budget index governor and heat-driven dynamic replication.

* ``AccessLog`` — persistent per-(replica, filter-column) hit/miss counters
  on the ``BlockStore``, fed by the record readers through
  ``attribute_read`` (the same counts land in the kernel layer's
  ``reader_stats`` as ``index_scan_blocks[col]`` / ``full_scan_blocks[col]``).
  A logical clock stamps every read, so recency is workload-defined; a
  coarser JOB clock (one tick per ``run_job`` and per server flush) records
  which distinct jobs missed for each column.

* ``GovernorConfig`` / ``IndexGovernor`` — a storage budget on the total
  per-block indexes held across replicas, enforced proactively (``run_job``
  and the server trim build offers and demote LRU victims) and as a hard
  backstop in ``BlockStore.commit_block_indexes``.  Claim-time demotion
  (every replica keyed elsewhere, a shifted workload wants one) waits for
  ``claim_miss_jobs`` distinct jobs of misses — hysteresis, so a one-off
  query never destroys a warm index.  The victim is the replica whose
  (replica, sort_key) record is least recently used, then fewest hits, then
  lowest id; ``BlockStore.demote_replica`` does the destructive work.

* ``ReplicationConfig`` / ``ReplicationController`` — replica COUNT follows
  measured heat: a column that keeps missing with no claimable replica gets
  a fresh one (``BlockStore.add_replica``), and a replica cold for
  ``cold_ticks`` ticks is retired (``decommission_replica``).  Its inputs are
  the metrics registry's snapshot deltas of the per-store ``governor.heat``
  / ``governor.miss_heat`` gauges; ``run_job`` and ``HailServer.flush`` tick
  it at their boundaries.

The governor and the controller only decide; every store invariant
(checksums, bad-mask coherence, Dir_rep) is kept by the store's own
transitions.
"""
from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING, Any, Optional, Sequence

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


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """Storage budget for per-block clustered indexes (whole store).

    ``max_indexed_blocks``: cap on the total number of indexed blocks summed
    over ALL replicas.  ``max_indexed_bytes``: same cap expressed in bytes
    (converted via the per-block PAX footprint).  Both ``None`` = unlimited
    (the governor still tracks demotions but never evicts for space).

    ``claim_miss_jobs``: eviction hysteresis for the CLAIM-TIME demotion
    path (every replica keyed elsewhere, a shifted workload wants one).
    Demotion requires at least this many distinct jobs of misses on the
    requesting column — the requesting job itself counts as one, so the
    default of 2 means a column's FIRST-ever job never destroys a warm
    index; the second distinct job does.  Budget-pressure eviction (the
    offer doesn't fit) is not hysteresis-gated: there the alternative is
    violating the storage budget, not merely scanning.
    """
    max_indexed_blocks: Optional[int] = None
    max_indexed_bytes: Optional[int] = None
    claim_miss_jobs: int = 2


@dataclasses.dataclass(frozen=True)
class DemotionEvent:
    replica_id: int
    sort_key: str
    blocks_dropped: int


class IndexGovernor:
    """Budget enforcement + LRU victim policy.  Pure decision logic — the
    destructive transition is ``BlockStore.demote_replica``."""

    def __init__(self, config: GovernorConfig):
        self.config = config
        self.events: list[DemotionEvent] = []

    # -- budget accounting --------------------------------------------------

    def budget_blocks(self, store: "BlockStore") -> float:
        limits = []
        if self.config.max_indexed_blocks is not None:
            limits.append(float(self.config.max_indexed_blocks))
        if self.config.max_indexed_bytes is not None:
            per_block = max(
                store.template_replica().nbytes // store.n_blocks, 1)
            limits.append(float(self.config.max_indexed_bytes // per_block))
        return min(limits) if limits else float("inf")

    def room(self, store: "BlockStore") -> float:
        """Indexed blocks the budget still allows (may be negative if the
        store was over budget when the governor was installed)."""
        return self.budget_blocks(store) - store.total_indexed_blocks()

    def admit(self, store: "BlockStore", replica_id: int, n_blocks: int) -> int:
        """Hard backstop at commit time: how many of ``n_blocks`` new
        per-block indexes fit.  Never demotes — eviction is a scheduled
        (run_job) decision, admission is an invariant."""
        room = self.room(store)
        if room == float("inf"):
            return n_blocks
        return max(0, min(n_blocks, int(room)))

    # -- eviction policy ----------------------------------------------------

    def victim(self, store: "BlockStore",
               protect: Sequence[str] = ()) -> Optional[int]:
        """LRU victim replica, or None when nothing is evictable.

        Candidates: replicas holding at least one per-block index whose
        ``sort_key`` is not protected (the current workload's filter columns
        are protected so a job never evicts the index it is converging on).
        Ranked by the access log's (replica, sort_key) record: least
        recently used first, then fewest lifetime hits, then replica id —
        replicas never queried since the log began sort first.
        """
        log = store.access_log
        best, best_score = None, None
        for i, rep in enumerate(store.replicas):
            if rep.retired or rep.sort_key is None or rep.sort_key in protect:
                continue
            if rep.indexed is None or not rep.indexed.any():
                continue
            rec = log.get(i, rep.sort_key) if log is not None else None
            score = ((rec.last_used if rec is not None else 0),
                     (rec.hits if rec is not None else 0), i)
            if best_score is None or score < best_score:
                best, best_score = i, score
        return best

    def may_reclaim(self, store: "BlockStore", col: str) -> bool:
        """Hysteresis gate for claim-time demotion on behalf of ``col``.

        True once ``col`` has accumulated misses in at least
        ``claim_miss_jobs`` distinct jobs, counting the requesting job
        (which is about to full-scan) as one — so a workload that queries
        once never evicts anything, while a recurring one waits exactly one
        extra job before re-claiming.  PRIOR jobs are counted excluding the
        job clock's current value: a flush's later batches must not pass
        the gate on misses their own flush just recorded.
        """
        log = store.access_log
        prior = (log.distinct_miss_jobs(col, exclude_current=True)
                 if log is not None else 0)
        return prior + 1 >= self.config.claim_miss_jobs

    def note_demotion(self, replica_id: int, sort_key: str,
                      blocks_dropped: int):
        self.events.append(DemotionEvent(replica_id, sort_key,
                                         blocks_dropped))
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import trace as obs_trace
        obs_metrics.REGISTRY.inc("governor.demotion_events", 1,
                                 replica=replica_id, column=sort_key)
        obs_metrics.REGISTRY.inc("governor.demoted_blocks", blocks_dropped,
                                 replica=replica_id, column=sort_key)
        obs_trace.instant("demotion", track="governor",
                          args={"replica": replica_id, "column": sort_key,
                                "blocks": blocks_dropped})

    @property
    def blocks_demoted_total(self) -> int:
        return sum(e.blocks_dropped for e in self.events)


def govern(store: "BlockStore", *,
           max_indexed_blocks: Optional[int] = None,
           max_indexed_bytes: Optional[int] = None,
           claim_miss_jobs: int = 2) -> IndexGovernor:
    """Attach a budget governor to a store (the one-call entry point)."""
    gov = IndexGovernor(GovernorConfig(max_indexed_blocks=max_indexed_blocks,
                                       max_indexed_bytes=max_indexed_bytes,
                                       claim_miss_jobs=claim_miss_jobs))
    store.governor = gov
    return gov


# ---------------------------------------------------------------------------
# Dynamic replication: replica COUNT follows measured heat
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReplicationConfig:
    """Heat → replica-count policy (replaces the static factor-of-3).

    Scale UP: a filter column whose reads keep MISSING (full-scanning)
    while no replica is claimable for it (every live replica already keyed
    elsewhere) gets a fresh replica once its per-tick miss heat reaches
    ``hot_misses`` — the next adaptive job claims the new replica for that
    column (HAIL: one clustered index per replica, so a replica is an
    index *slot*).  Scale DOWN: a live replica whose own read heat across
    ALL columns stays at zero for ``cold_ticks`` consecutive ticks is
    decommissioned.  ``min_replication``/``max_replication`` bound the
    live replica count; the last-healthy-copy safety is the store's own
    invariant (``decommission_replica`` refuses).  ``n_nodes``: cluster
    size for placement (inferred from live replicas when None).
    """
    min_replication: int = 2
    max_replication: int = 5
    hot_misses: int = 1
    cold_ticks: int = 2
    n_nodes: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class ReplicationEvent:
    kind: str                      # 'add' | 'decommission'
    replica_id: int
    column: Optional[str]          # the hot column (adds only)
    tick: int


class ReplicationController:
    """Closes the replication loop from MEASURED heat.

    The controller owns no bespoke plumbing into the read path: its inputs
    are ``registry.snapshot()`` DELTAS of the per-store collector's
    ``governor.heat{column=..,replica=..}`` / ``governor.miss_heat{..}``
    gauges (the AccessLog mirrored into the flight recorder), so anything
    the registry can see — cached reads replayed into the AccessLog
    included — moves the same controller.  ``run_job`` and
    ``HailServer.flush`` tick it at job/flush boundaries, like the
    scrubber.  Decisions delegate to ``BlockStore.add_replica`` /
    ``decommission_replica``; this class only decides.
    """

    _HEAT = re.compile(r"^governor\.(?P<kind>heat|miss_heat)"
                       r"\{column=(?P<col>[^,}]+),replica=(?P<rid>\d+)\}$")

    def __init__(self, store: "BlockStore",
                 config: ReplicationConfig = ReplicationConfig(),
                 registry: Any = None):
        from repro_torch.obs import metrics as obs_metrics
        self.store = store
        self.config = config
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        self._collector = obs_metrics.register_store(store, self.registry)
        self.events: list[ReplicationEvent] = []
        self.ticks = 0
        self._cold_streak: dict[int, int] = {}
        self._prev = self.registry.snapshot()

    def detach(self):
        """Unregister the store collector (store is done)."""
        self.registry.unregister_collector(self._collector)
        if self.store.replicator is self:
            self.store.replicator = None

    @property
    def replicas_added(self) -> int:
        return sum(e.kind == "add" for e in self.events)

    @property
    def replicas_decommissioned(self) -> int:
        return sum(e.kind == "decommission" for e in self.events)

    def _interval_heat(self) -> tuple[dict, dict]:
        """(total heat, miss heat) per (replica, column) since last tick,
        parsed from the registry's snapshot delta."""
        snap = self.registry.snapshot()
        d = self.registry.delta(self._prev, after=snap)
        self._prev = snap
        heat: dict[tuple[int, str], float] = {}
        miss: dict[tuple[int, str], float] = {}
        for series, v in d.items():
            m = self._HEAT.match(series)
            if m is None:
                continue
            key = (int(m.group("rid")), m.group("col"))
            (heat if m.group("kind") == "heat" else miss)[key] = v
        return heat, miss

    def tick(self) -> list[ReplicationEvent]:
        """One control quantum at a job/flush boundary."""
        self.ticks += 1
        heat, miss = self._interval_heat()
        added = self._scale_up(miss)
        out = added + self._scale_down(
            heat, protect={e.replica_id for e in added})
        self.events.extend(out)
        return out

    def _scale_up(self, miss: dict) -> list[ReplicationEvent]:
        store, cfg = self.store, self.config
        col_miss: dict[str, float] = {}
        for (rid, col), v in miss.items():
            col_miss[col] = col_miss.get(col, 0.0) + v
        out = []
        for col, v in sorted(col_miss.items(), key=lambda kv: -kv[1]):
            if v < cfg.hot_misses:
                break
            if len(store.live_replica_ids()) >= cfg.max_replication:
                break
            if store.adaptive_replica_for(col) is not None:
                continue     # keyed or claimable replica already serves it
            try:
                rid = store.add_replica(n_nodes=cfg.n_nodes)
            except ValueError:
                break        # cluster/healthy-copy limits: nothing to do
            self._cold_streak[rid] = 0
            self.registry.inc("replication.replicas_added", 1, column=col)
            from repro_torch.obs import trace as obs_trace
            obs_trace.instant("replicate", track="governor",
                              args={"replica": rid, "column": col,
                                    "miss_heat": v})
            out.append(ReplicationEvent("add", rid, col, self.ticks))
        return out

    def _scale_down(self, heat: dict,
                    protect: set = frozenset()) -> list[ReplicationEvent]:
        store, cfg = self.store, self.config
        rid_heat: dict[int, float] = {}
        for (rid, col), v in heat.items():
            rid_heat[rid] = rid_heat.get(rid, 0.0) + v
        for rid in store.live_replica_ids():
            if rid_heat.get(rid, 0.0) > 0 or rid in protect:
                self._cold_streak[rid] = 0    # just-added replicas are warm
            else:
                self._cold_streak[rid] = self._cold_streak.get(rid, 0) + 1
        out = []
        # longest cold streak first; ties toward the youngest replica
        for rid in sorted(store.live_replica_ids(),
                          key=lambda i: (-self._cold_streak.get(i, 0), -i)):
            if len(store.live_replica_ids()) <= cfg.min_replication:
                break
            if self._cold_streak.get(rid, 0) < cfg.cold_ticks:
                continue
            try:
                dropped = store.decommission_replica(rid)
            except ValueError:
                continue     # would strand a block's last healthy copy
            self._cold_streak.pop(rid, None)
            self.registry.inc("replication.replicas_decommissioned", 1)
            from repro_torch.obs import trace as obs_trace
            obs_trace.instant("decommission", track="governor",
                              args={"replica": rid,
                                    "indexes_dropped": dropped})
            out.append(ReplicationEvent("decommission", rid, None,
                                        self.ticks))
        return out


def replicate(store: "BlockStore", *,
              min_replication: int = 2, max_replication: int = 5,
              hot_misses: int = 1, cold_ticks: int = 2,
              n_nodes: Optional[int] = None,
              registry: Any = None) -> ReplicationController:
    """Attach a heat-driven replication controller (one-call entry point).
    ``run_job``/``HailServer.flush`` tick ``store.replicator`` at their
    job/flush boundaries."""
    ctl = ReplicationController(
        store,
        ReplicationConfig(min_replication=min_replication,
                          max_replication=max_replication,
                          hot_misses=hot_misses, cold_ticks=cold_ticks,
                          n_nodes=n_nodes),
        registry=registry)
    store.replicator = ctl
    return ctl
