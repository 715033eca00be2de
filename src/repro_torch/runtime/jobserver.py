"""HailServer: concurrent multi-query serving over one HAIL block store.

``run_job`` executes exactly one query at a time; the north star is a
system serving heavy concurrent traffic, where that model re-reads the
same hot blocks for every caller and lets every tenant trigger its own
adaptive index builds.  The server closes the gap with three mechanisms:

* **Admission control** — ``submit`` enforces per-tenant and global queue
  quotas and REJECTS over-quota submissions (``AdmissionError``):
  back-pressure at the door instead of unbounded queue growth, so one hot
  tenant cannot starve the rest.

* **Shared-scan batching** — ``flush`` groups compatible pending queries
  (same filter column, same projection — hence the same replica plan) into
  batches of ``max_batch`` and reads each batch with ONE fused reader
  launch per split (``query.read_hail_batch``: the ``(Q, 2)`` lo/hi ranges
  are a runtime tensor, the kernel emits per-query match masks), so Q
  concurrent range queries over a split cost one launch and one pass over
  the data instead of Q.  Row-sets are identical to Q serial
  ``run_job`` calls — including under mid-batch demotion and node failure
  (the same re-plan/retry path ``run_job`` uses, exercised per batch).

* **A governor-integrated hot-block cache** — decoded per-split reader
  inputs live in a capacity-bounded, SCAN-RESISTANT segmented cache
  (``core/cache.BlockCache``) attached to the store; hits skip the gather
  and its checksum verification entirely, misses fill it, the store's destructive
  transitions (``commit_block_indexes``, ``demote_replica``,
  ``quarantine_block``, ``repair_blocks``) invalidate the touched
  replica's entries, and every read — cached or not — is still attributed
  per query into the ``AccessLog``, so the IndexGovernor's LRU signal
  sees cached traffic.

* **A query-result cache** — the second tier (``core/cache.ResultCache``):
  materialized answers keyed (filter col, lo, hi, projection, store
  version).  ``flush`` first tries to serve each pending query from it —
  a repeated (or subsumed, when the filter column is projected) range
  skips batching, planning and the fused scan entirely, with ZERO reader
  launches — and replays the entry's fill-time attribution recipe
  through ``governor.attribute_read``, so a hot-but-result-cached index
  never looks LRU-cold to the governor.  Every destructive store
  transition bumps ``BlockStore.version`` and drops the tier, so a stale
  answer is structurally unreachable.

Adaptive builds are budgeted at the WORKLOAD level ("Towards Zero-Overhead
Adaptive Indexing" argues the build budget belongs to the workload, not
the job): one ``offer_rate`` quantum is drawn per flush
(``mapreduce.adaptive_quantum``) and shared by every batch in submission
order — eight concurrent tenants advance convergence by one job's worth,
not eight.

``ServerFrontend`` puts an ASYNC, latency-SLO event loop on top: callers
``offer`` queries with simulated arrival times and a ``FlushPolicy`` decides
when flushes fire — when the OLDEST pending query has waited ``window_s``
(the SLO knob) or a compatible batch fills to ``max_batch`` — instead of a
caller-driven ``flush()`` being the only trigger (``flush`` stays, for tests
and for the frontend's own cycles).  Per-query answers STREAM back as the
last split each query depends on completes (``FlushStats.query_done_s``, and
the scheduler bridge's ``query_completion_s``), not at a flush-end barrier;
and when pending work exceeds one flush's capacity, weighted-fair admission
(per-tenant virtual time) decides which batches dispatch first.

Each FLUSH is one job boundary for the governor (``note_job_start``) —
the flush is the user-visible workload unit, so claim-time eviction
hysteresis applies to server traffic exactly as to serial jobs: a column
seen for the first time cannot satisfy the threshold with its own flush's
batches.  The scheduler bridge (``flush_tasks``) turns a flush into
``runtime/scheduler.Task``s whose ``n_queries`` records the batch width —
one task's scheduling overhead amortized over Q answers is the serving
analogue of HailSplitting's fewer-map-tasks win.

Completion waits on one CUDA event per dispatched split
(``mapreduce._completion_event``), and each live member's matching rows
are selected on the device, so only they cross to the host (the JAX
package copies every split's full masks and columns and selects there;
the answers are the same rows in the same order).  With
``ServerConfig.mesh`` a batch's splits are read in WAVES of up to n_dev
splits, one launch a split on its own slot (device and stream) of the
mesh, as ``mapreduce.run_job(..., mesh=...)`` reads them; each split's
completion event is recorded on its slot's stream.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import governor as gvn
from repro_torch.core import mapreduce as mr
from repro_torch.core import query as q
from repro_torch.core.cache import BlockCache, ResultCache
from repro_torch.core.fault import (CorruptBlockError, RecoveryConfig,
                                    UnrecoverableDataError)
from repro_torch.core.query import HailQuery
from repro_torch.core.schema import ROWID
from repro_torch.core.splitting import Split, hadoop_splits, hail_splits
from repro_torch.core.store import BlockStore
from repro_torch.obs import explain as obs_explain
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.runtime.cluster import SimulatedCluster
from repro_torch.runtime.scheduler import Task, run_schedule


class AdmissionError(RuntimeError):
    """Submission rejected: the tenant (or the whole server) is over its
    pending-query quota."""


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving knobs.

    ``max_batch``: widest shared-scan batch (Q) per fused reader launch
    (the batch width is a runtime value of the kernel, not a variant).
    ``max_pending_per_tenant`` /
    ``max_pending_total``: admission-control quotas enforced by ``submit``.
    ``cache_bytes``: hot-block cache capacity (None = unbounded;
    ``cache=False`` disables caching entirely).  ``result_cache`` /
    ``result_cache_bytes``: the materialized-answer tier, same knob shape
    (measurements of the scan path itself disable it).  ``adaptive``:
    when set, flushes draw ONE shared build quantum (see module docstring).
    ``mesh``: a ``launch.mesh.DeviceMesh`` to SHARD each batch's fused scan
    over — splits gather as usual but are read in WAVES of up to n_dev
    splits, one launch a split on its own slot (see ``mapreduce.run_job``);
    a mesh without a scan axis of more than one slot takes the per-split
    path.
    """
    max_batch: int = 8
    max_pending_per_tenant: int = 8
    max_pending_total: int = 64
    reader: str = "kernels"
    mesh: Optional[object] = None
    cache: bool = True
    cache_bytes: Optional[int] = None
    result_cache: bool = True
    result_cache_bytes: Optional[int] = None
    adaptive: Optional[mr.AdaptiveConfig] = None
    cluster: mr.ClusterModel = dataclasses.field(
        default_factory=mr.ClusterModel)
    recovery: RecoveryConfig = dataclasses.field(
        default_factory=RecoveryConfig)


@dataclasses.dataclass
class QueryResult:
    """Materialized answer for one submitted query."""
    n_rows: int
    rows: dict[str, np.ndarray]    # projection (+__rowid__) of matching rows
    batch_size: int                # Q of the shared-scan batch that served it
    n_splits: int                  # fused launches that batch issued
    from_cache: bool = False       # served by the result cache (no scan)


@dataclasses.dataclass
class Ticket:
    ticket_id: int
    tenant: str
    query: HailQuery
    status: str = "queued"         # queued -> done | failed
    result: Optional[QueryResult] = None
    error: Optional[str] = None    # typed terminal failure (retry budget
    #   exhausted mid-flush) — set alongside status="failed", never silently
    #   stranded "queued"
    explain_ctx: Optional[object] = None   # shared per-flush EXPLAIN
    #   context (obs.explain.FlushExplain), attached by the flush that
    #   answered this ticket; resolved lazily by ``explain()``

    def explain(self):
        """Reconstruct why this query took the time it did — queue wait vs
        service, flush trigger, per-split scan modes, cache-tier outcome,
        retries survived, build/demotion walls charged.  Returns an
        ``obs.explain.ExplainRecord`` (render with ``str()``); raises if
        the ticket has not been through a flush yet."""
        return obs_explain.explain_ticket(self)


@dataclasses.dataclass
class FlushStats:
    """One ``flush``: every pending query answered."""
    n_queries: int
    n_batches: int
    n_splits: int                  # fused launches == (split, batch) pairs
    batch_sizes: list
    blocks_indexed: int = 0        # shared adaptive quantum actually spent
    blocks_demoted: int = 0
    rescheduled_tasks: int = 0
    bytes_read: int = 0            # PHYSICAL shared-scan bytes (union range)
    split_s: list = dataclasses.field(default_factory=list)
    build_s: list = dataclasses.field(default_factory=list)
    demote_s: list = dataclasses.field(default_factory=list)
    batch_of_split: list = dataclasses.field(default_factory=list)
    # ^ batch width (Q) per executed split, aligned with split_s — the
    #   scheduler bridge stamps it into Task.n_queries
    queries_of_split: list = dataclasses.field(default_factory=list)
    # ^ ticket ids whose answer DEPENDS on each executed split (its LIVE
    #   members: key-range overlap, or any full-scan block), aligned with
    #   split_s — the scheduler bridge stamps them into Task.query_ids so
    #   run_schedule can emit per-query completion timestamps
    split_scan_modes: list = dataclasses.field(default_factory=list)
    # ^ (index_blocks, full_scan_blocks) per executed split, aligned with
    #   split_s — per-query scan-mode attribution for ``Ticket.explain()``
    query_done_s: dict = dataclasses.field(default_factory=dict)
    # ^ ticket id -> wall seconds after flush start when its answer
    #   FINALIZED (streamed back) — result-cache hits and fully-pruned
    #   queries land near 0, batch members do not wait for the flush end
    failed_queries: list = dataclasses.field(default_factory=list)
    # ^ ticket ids terminally failed this flush (typed, not stranded)
    demote_residue_s: float = 0.0  # demotion wall charged at claim time but
    #   not carried by any executed split (every split after the claim was
    #   pruned or re-planned away) — flushed here so the scheduler bridge
    #   never undercharges
    cache_hits: int = 0            # this flush's block-cache traffic
    cache_misses: int = 0
    result_cache_hits: int = 0     # queries answered without any scan
    result_cache_misses: int = 0
    wall_s: float = 0.0
    modeled_s: float = 0.0         # deterministic: scheduling + shared disk
    blocks_quarantined: int = 0    # corrupt (replica, block)s this flush found
    corrupt_retries: int = 0       # batch splits re-planned after corruption
    scrub_s: float = 0.0           # boundary scrub wall (verify + repair)


def flush_tasks(stats: FlushStats) -> list[Task]:
    """Bridge a flush into the event-driven cluster simulator: one Task per
    executed (split, batch), duration = measured read wall, piggybacked
    build/demotion walls charged like ``mapreduce.job_tasks``, and the batch
    width recorded in ``Task.n_queries`` (totaled by ``run_schedule`` as
    ``ScheduleResult.n_query_answers`` — (query, split) answers, from which
    callers derive throughput against their distinct-query count).  Each
    task also carries the ticket ids live on its split (``Task.query_ids``),
    so ``run_schedule`` yields per-query completion timestamps — the
    ServerFrontend's latency signal.  Demotion wall not carried by any
    executed split (``demote_residue_s``) is charged to the first task, or
    to a synthetic zero-duration task when the flush executed none."""
    qids = stats.queries_of_split or [()] * len(stats.split_s)
    tasks = [Task(i, dur, preferred_nodes=(), index_build_s=build,
                  rekey_s=rekey, n_queries=nq, query_ids=tuple(qq))
             for i, (dur, build, rekey, nq, qq)
             in enumerate(zip(stats.split_s, stats.build_s, stats.demote_s,
                              stats.batch_of_split, qids))]
    if stats.demote_residue_s:
        if tasks:
            tasks[0].rekey_s += stats.demote_residue_s
        else:
            tasks.append(Task(0, 0.0, preferred_nodes=(),
                              rekey_s=stats.demote_residue_s, n_queries=0))
    return tasks


class HailServer:
    """Multi-tenant serving frontend over one ``BlockStore``.

    ``submit`` enqueues (admission-controlled); ``flush`` answers every
    pending query via shared-scan batches.  The split between the two is
    the batching window: everything submitted since the last flush is
    eligible to share scans.
    """

    def __init__(self, store: BlockStore, config: ServerConfig = None):
        self.store = store
        self.config = config or ServerConfig()
        self.tickets: list[Ticket] = []        # completed + queued (by id)
        self._pending: list[Ticket] = []
        self._spans: dict = {}   # per-flush key spans (see _key_spans)
        self.cache: Optional[BlockCache] = None
        if self.config.cache:
            # an EXPLICIT capacity always wins: if the store already carries
            # a cache with a different budget, attach a fresh one at the
            # requested size (silently inheriting an unbounded cache would
            # make the configured budget a no-op); cache_bytes=None reuses
            # whatever is attached, else attaches unbounded
            existing = store.block_cache
            if existing is None or (
                    self.config.cache_bytes is not None
                    and existing.capacity_bytes != self.config.cache_bytes):
                existing = BlockCache(self.config.cache_bytes).attach(store)
            self.cache = existing
        self.result_cache: Optional[ResultCache] = None
        if self.config.result_cache:
            existing_rc = store.result_cache
            if existing_rc is None or (
                    self.config.result_cache_bytes is not None
                    and existing_rc.capacity_bytes
                    != self.config.result_cache_bytes):
                existing_rc = ResultCache(
                    self.config.result_cache_bytes).attach(store)
            self.result_cache = existing_rc

    # -- admission ----------------------------------------------------------

    def pending_count(self, tenant: Optional[str] = None) -> int:
        if tenant is None:
            return len(self._pending)
        return sum(1 for t in self._pending if t.tenant == tenant)

    def submit(self, query: HailQuery, tenant: str = "default") -> Ticket:
        """Enqueue one query for the next flush; rejects over quota."""
        if self.pending_count() >= self.config.max_pending_total:
            raise AdmissionError(
                f"server queue full ({self.config.max_pending_total})")
        if self.pending_count(tenant) >= self.config.max_pending_per_tenant:
            raise AdmissionError(
                f"tenant {tenant!r} over quota "
                f"({self.config.max_pending_per_tenant} pending)")
        t = Ticket(ticket_id=len(self.tickets), tenant=tenant, query=query)
        self.tickets.append(t)
        self._pending.append(t)
        return t

    # -- batching -----------------------------------------------------------

    def _batches(self, tickets: Sequence[Ticket]) -> list[list[Ticket]]:
        """Group compatible queries — same (filter column, projection) means
        same replica plan and one shared scan — into chunks of
        ``max_batch``, preserving submission order within a group.  Queries
        without a filter cannot share a scan and run as singletons."""
        groups: dict = {}
        for t in tickets:
            if t.query.filter is None or self.store.layout != "pax":
                key = ("__single__", t.ticket_id)
            else:
                key = (t.query.filter_col, tuple(t.query.projection))
            groups.setdefault(key, []).append(t)
        out = []
        for members in groups.values():
            for i in range(0, len(members), self.config.max_batch):
                out.append(members[i:i + self.config.max_batch])
        return out

    # -- execution ----------------------------------------------------------

    def flush(self, fail_node_at: Optional[float] = None) -> FlushStats:
        """Answer every pending query.

        ``fail_node_at``: failure-injection fraction (of the first batch's
        splits), the same knob ``run_job`` exposes — the killed node stays
        dead for the REST of the flush (later batches plan around it) and
        is revived at the end, so one flush exercises both the mid-batch
        retry path and cross-batch re-planning.
        """
        tickets, self._pending = self._pending, []
        self._spans = {}
        # ONE governor job boundary per flush (not per batch): the flush is
        # the user-visible workload unit, so a never-before-seen column
        # cannot satisfy claim-time hysteresis with its own batches —
        # "queries once" means "one flush", however many batches it takes.
        # Opened BEFORE the result-cache short-circuit so replayed
        # attribution lands in this job, like the scans it stands in for.
        gvn.note_job_start(self.store)
        rc = self.result_cache
        rc_h0 = rc.stats.hits if rc else 0
        rc_m0 = rc.stats.misses if rc else 0
        t0 = time.perf_counter()
        # tier 2 first: a repeated/subsumed range skips batching, planning
        # and the fused scan entirely — only the misses get batched below
        with obs_trace.span("result_cache_probe", track="server",
                            args={"queries": len(tickets)}):
            missed = [t for t in tickets
                      if not self._serve_from_result_cache(t)]
        with obs_trace.span("batching", track="server"):
            batches = self._batches(missed)
        stats = FlushStats(n_queries=len(tickets), n_batches=len(batches),
                           n_splits=0,
                           batch_sizes=[len(b) for b in batches])
        for t in tickets:
            if t.status == "done":     # result-cache hit: streamed at ~0
                stats.query_done_s[t.ticket_id] = time.perf_counter() - t0
        cache_h0 = self.cache.stats.hits if self.cache else 0
        cache_m0 = self.cache.stats.misses if self.cache else 0
        # ONE shared adaptive quantum for the whole flush: concurrent
        # tenants advance convergence by one job's worth, not Q jobs' worth
        budget = {"left": 0}
        if self.config.adaptive is not None and self.store.layout == "pax":
            budget["left"] = mr.adaptive_quantum(self.store,
                                                 self.config.adaptive)
        fail = {"frac": fail_node_at, "node": None}
        # corruption retry budget is per FLUSH per block — corruption and
        # node-failure retries share it, like run_job's
        retries: collections.Counter = collections.Counter()
        try:
            for batch in batches:
                t_b = time.perf_counter()
                try:
                    self._run_batch(batch, stats, budget, fail, retries, t0)
                except UnrecoverableDataError as e:
                    # the failed batch terminates TYPED — its not-yet-
                    # finalized tickets get status="failed" (never stranded
                    # "queued") and the remaining batches still run
                    for t in batch:
                        if t.status != "done":
                            t.status = "failed"
                            t.error = str(e)
                            stats.failed_queries.append(t.ticket_id)
                    # splits dispatched but never barriered leave the
                    # per-split lists longer than split_s; realign so the
                    # scheduler bridge's zip cannot silently drop their
                    # demotion wall (build wall is dropped with the batch —
                    # the claim-time demotion mutated the store, the builds
                    # answered nothing)
                    extra = len(stats.demote_s) - len(stats.split_s)
                    if extra > 0:
                        stats.demote_residue_s += sum(stats.demote_s[-extra:])
                        del stats.demote_s[-extra:]
                        del stats.build_s[-extra:]
                        del stats.batch_of_split[-extra:]
                        del stats.queries_of_split[-extra:]
                        del stats.split_scan_modes[-extra:]
                finally:
                    obs_trace.complete_wall(
                        "batch", t_b, time.perf_counter() - t_b,
                        track="server", args={"width": len(batch)})
        finally:
            # lifecycle invariants hold even when a batch dies terminally:
            # the injected-failure node is revived and the boundary scrub
            # ticks (background verify + repair of anything quarantined by
            # this flush's reads or the scrub itself)
            stats.wall_s = time.perf_counter() - t0
            if fail["node"] is not None:
                self.store.namenode.revive(fail["node"])
            if (self.config.recovery.scrub
                    and self.store.scrubber is not None):
                t_s = time.perf_counter()
                self.store.scrubber.tick()
                stats.scrub_s = time.perf_counter() - t_s
            # flush boundary: replication-controller quantum (this flush's
            # AccessLog heat moves replica counts — add hot / retire cold)
            if (self.store.layout == "pax"
                    and self.store.replicator is not None):
                self.store.replicator.tick()
        cluster = self.config.cluster
        overhead = stats.n_splits * cluster.hail_sched_overhead_s
        disk_s = stats.bytes_read / (cluster.disk_bw * cluster.n_nodes)
        stats.modeled_s = (overhead / (cluster.n_nodes * cluster.map_slots)
                           + disk_s)
        if self.cache:
            stats.cache_hits = self.cache.stats.hits - cache_h0
            stats.cache_misses = self.cache.stats.misses - cache_m0
        if rc:
            stats.result_cache_hits = rc.stats.hits - rc_h0
            stats.result_cache_misses = rc.stats.misses - rc_m0
        obs_trace.complete_wall("flush", t0, stats.wall_s, track="server",
                                args={"queries": stats.n_queries,
                                      "batches": stats.n_batches,
                                      "splits": stats.n_splits})
        obs_metrics.observe_flush(stats,
                                  tenants=[t.tenant for t in tickets])
        # one shared EXPLAIN context per flush: every ticket (result-cache
        # hits and failures included) can reconstruct its decomposition
        # lazily — the frontend enriches it with arrival/trigger/latency
        ctx = obs_explain.FlushExplain(stats, cluster)
        for t in tickets:
            t.explain_ctx = ctx
        return stats

    def _serve_from_result_cache(self, t: Ticket) -> bool:
        """Try to answer one ticket from the materialized-result tier.

        On a hit the ticket completes with ZERO reader launches; the
        entry's fill-time attribution recipe is replayed through
        ``governor.attribute_read`` so the AccessLog (and reader_stats)
        sees the same per-(replica, column) traffic the scan would have
        generated — a hot-but-result-cached index never looks LRU-cold."""
        rc = self.result_cache
        if (rc is None or self.store.layout != "pax"
                or t.query.filter is None):
            return False               # not result-cacheable: no miss counted
        col, lo, hi = t.query.filter
        ent = rc.lookup(col, lo, hi, tuple(t.query.projection),
                        self.store.version)
        if ent is None:
            return False
        for rid, n_idx, n_full in ent.attribution:
            gvn.attribute_read(self.store, rid, col, n_idx, n_full)
        t.result = QueryResult(n_rows=ent.n_rows, rows=dict(ent.rows),
                               batch_size=0, n_splits=0, from_cache=True)
        t.status = "done"
        return True

    def _read_batch(self, queries, qplan, ids):
        """-> (per-query ReadResults, physical shared bytes) for one split.

        PAX + filter + kernels reader is the shared-scan hot path; a
        row_ascii store routes to the Hadoop baseline reader (same as
        ``run_job``), and filterless/jnp reads fall back to per-query
        ``read_hail`` — no scan sharing, but one flush either way."""
        if self.store.layout != "pax":
            res = [q.read_hadoop(self.store, qq, ids) for qq in queries]
            return res, sum(r.bytes_read for r in res)
        if queries[0].filter is not None and self.config.reader == "kernels":
            return q.read_hail_batch(self.store, queries, qplan, ids)
        res = [q.read_hail(self.store, qq, qplan, ids) for qq in queries]
        return res, sum(r.bytes_read for r in res)

    def _key_spans(self, rid: int, col: str) -> np.ndarray:
        """(first key, last good key, good rows) of every block of one
        replica's ``col``, as int64 (3, n_blocks): one device-to-host copy,
        reused for the rest of the flush while the replica still holds the
        same root-directory and column tensors (every store transition
        rebinds them, so a commit mid-flush forces a fresh copy)."""
        store = self.store
        rep = store.replicas[rid]
        held = self._spans.get((rid, col))
        if (held is not None and held[0] is rep.mins
                and held[1] is rep.cols[col]):
            return held[2]
        n_good = store.rows_per_block - store.bad_counts.to(torch.int64)
        last = n_good.clamp(min=1)[:, None] - 1
        spans = torch.stack([rep.mins[:, 0].to(torch.int64),
                             rep.cols[col].gather(1, last)[:, 0].to(
                                 torch.int64),
                             n_good]).cpu().numpy()
        self._spans[(rid, col)] = (rep.mins, rep.cols[col], spans)
        return spans

    def _live_members(self, qplan: q.QueryPlan, sp: Split,
                      queries: Sequence[HailQuery]) -> list[int]:
        """Batch-member indices whose ANSWER can depend on this split.

        A full-scan block touches every row, so it keeps the whole batch
        live (conservative: no key metadata to prune with).  An index-scan
        block's good rows span exactly [root-directory min, last good sorted
        key] — bad records sort to the tail — so a query range that misses
        that span on every block of the split contributes zero rows and the
        member need not wait on (or even dispatch) it."""
        store = self.store
        if store.layout != "pax" or queries[0].filter is None:
            return list(range(len(queries)))
        if any(not qplan.index_scan[b] for b in sp.block_ids):
            return list(range(len(queries)))
        col = queries[0].filter_col
        live: set[int] = set()
        for b in sp.block_ids:
            kmin, kmax, n_good = (int(v) for v in self._key_spans(
                int(qplan.replica_for_block[b]), col)[:, b])
            if n_good <= 0:
                continue                     # every row bad: nothing to read
            for qi, qq in enumerate(queries):
                _, lo, hi = qq.filter
                if hi >= kmin and lo <= kmax:
                    live.add(qi)
            if len(live) == len(queries):
                break
        return sorted(live)

    def _empty_col(self, c: str) -> np.ndarray:
        """Zero-row column in the STORED dtype (a plan can yield zero live
        splits for a query; the empty answer must still type-check against
        the schema, not collapse to int32)."""
        if self.store.layout == "pax":
            dtype = self.store.template_replica().cols[c].dtype
        elif c == ROWID:
            dtype = torch.int32
        else:
            dtype = self.store.schema.col(c).dtype
        return torch.zeros((0,), dtype=dtype).numpy()

    def _run_batch(self, batch: list[Ticket], stats: FlushStats,
                   budget: dict, fail: dict,
                   retries: collections.Counter, t0: float):
        """Execute one shared-scan batch: plan once, launch one fused read
        per split, piggyback shared-quantum adaptive builds, handle node
        failure AND read-path corruption by re-planning lost splits
        (per-block retries, bounded by ``config.recovery``) — the same loop
        shape as ``run_job``, widened to Q queries.  Completion STREAMS:
        each ticket finalizes the moment the last split it is live on
        clears its completion event (``stats.query_done_s``), instead of at
        a batch-end barrier."""

        def note_retries(block_ids):
            for b in block_ids:
                retries[b] += 1
                if retries[b] > self.config.recovery.max_retries:
                    raise UnrecoverableDataError(
                        f"block {b}: re-plan retry budget "
                        f"({self.config.recovery.max_retries}) exhausted")

        store = self.store
        queries = [t.query for t in batch]
        query0 = queries[0]
        with obs_trace.span("plan", track="server",
                            args={"width": len(batch)}):
            qplan = q.plan(store, query0)
        splits = (hail_splits(store, qplan, self.config.cluster.map_slots)
                  if store.layout == "pax" else hadoop_splits(store, qplan))
        fail_after = (int(len(splits) * fail["frac"])
                      if fail["frac"] is not None and fail["node"] is None
                      else None)

        # claim-time adaptive state (shared flush budget as the quantum;
        # hysteresis + zero-quantum gating live in claim_adaptive_replica)
        adapt_col, adapt_rid = None, None
        demote_pending = 0.0
        if (self.config.adaptive is not None and store.layout == "pax"
                and query0.filter is not None and budget["left"] > 0):
            adapt_col = query0.filter_col
            adapt_rid, demoted, d_wall = mr.claim_adaptive_replica(
                store, adapt_col, budget["left"])
            stats.blocks_demoted += demoted
            demote_pending += d_wall
            if adapt_rid is not None and not len(
                    store.unindexed_blocks(adapt_rid)):
                adapt_rid = None             # already converged

        # (results, shared bytes, dispatch stamp, live qis, completion event)
        dispatched = []

        # sharded scan: buffer up to n_dev gathered splits a wave and read
        # the wave one launch a split on its own slot (the gathered inputs
        # are snapshots, so buffering cannot change any split's row-set)
        mesh = self.config.mesh
        scan_axes, n_dev = mr.scan_mesh(mesh, store, query0)
        use_sharded = n_dev > 1
        wave: list[tuple] = []        # (live qis, gathered inputs)

        def flush_wave():
            if not wave:
                return
            out = mr.read_wave(store, queries, [g for _, g in wave], mesh,
                               scan_axes)
            for (live_qis, _), (res, shared, ev) in zip(wave, out):
                dispatched.append((res, shared, time.perf_counter(),
                                   live_qis, ev))
            wave.clear()

        pending = list(splits)
        i = 0
        try:
            while i < len(pending):
                if (fail_after is not None and i == fail_after
                        and fail["node"] is None):
                    pending, qplan, fail["node"], n_retries = \
                        mr.failover_replan(store, query0, pending, i)
                    stats.rescheduled_tasks += n_retries
                    if n_retries:
                        note_retries(b for s in pending[-n_retries:]
                                     for b in s.block_ids)
                    if i >= len(pending):
                        break
                sp = pending[i]
                i += 1
                live = self._live_members(qplan, sp, queries)
                if not live:
                    # DEAD split: no member's answer depends on it, and a
                    # dead split is all-index-scan so no piggyback build
                    # rides it — skip the dispatch entirely
                    continue
                try:
                    if use_sharded:
                        gathered = q.gather_shared_scan_inputs(
                            store, queries, qplan, list(sp.block_ids))
                    else:
                        res, shared = self._read_batch(queries, qplan,
                                                       list(sp.block_ids))
                except CorruptBlockError as e:
                    # quarantine at the namenode, re-plan against the
                    # smaller replica set, re-queue this split's blocks as
                    # per-block retries — identical recovery to run_job's
                    store.quarantine_block(e.replica_id, e.block_id)
                    stats.blocks_quarantined += 1
                    stats.corrupt_retries += 1
                    note_retries(sp.block_ids)
                    qplan = q.plan(store, query0)
                    pending.extend(
                        Split(node=int(qplan.nodes[b]), block_ids=(b,),
                              index_scan=bool(qplan.index_scan[b]))
                        for b in sp.block_ids)
                    continue
                if use_sharded:
                    wave.append((tuple(live), gathered))
                else:
                    dispatched.append((res, shared, time.perf_counter(),
                                       tuple(live),
                                       mr._completion_event(store.device)))
                d_wall, demote_pending = demote_pending, 0.0
                b_wall = 0.0
                if adapt_rid is not None and budget["left"] > 0:
                    built, demoted, b_wall, dd_wall = mr.piggyback_build(
                        store, sp, adapt_rid, adapt_col, budget["left"])
                    budget["left"] -= built
                    stats.blocks_indexed += built
                    stats.blocks_demoted += demoted
                    d_wall += dd_wall
                stats.build_s.append(b_wall)
                stats.demote_s.append(d_wall)
                stats.batch_of_split.append(len(batch))
                stats.queries_of_split.append(
                    tuple(batch[qi].ticket_id for qi in live))
                n_idx = sum(bool(qplan.index_scan[b]) for b in sp.block_ids)
                stats.split_scan_modes.append(
                    (n_idx, len(sp.block_ids) - n_idx))
                if len(wave) == n_dev:
                    flush_wave()
            flush_wave()          # the ragged final wave
        finally:
            if demote_pending > 0.0:
                # no split carried the demotion wall the claim paid (every
                # one was pruned or re-planned away, or the batch died
                # terminally): it must not vanish from the scheduler
                # bridge — charge the last executed split, else the flush
                # residue
                if stats.demote_s:
                    stats.demote_s[-1] += demote_pending
                else:
                    stats.demote_residue_s += demote_pending
                demote_pending = 0.0

        # completion: STREAMING — splits were all dispatched asynchronously
        # above, so blocking them in dispatch order finalizes each ticket
        # the moment the LAST split it is live on clears the barrier; a
        # ticket live on early-finishing (or zero) splits completes before
        # the slowest batch member
        n_splits = len(dispatched)
        stats.n_splits += n_splits
        rc = self.result_cache
        recipe = None
        if (rc is not None and store.layout == "pax"
                and query0.filter is not None):
            # the attribution recipe a HIT will replay — recomputed against
            # a FRESH plan, because mid-batch commits/quarantines bumped
            # ``store.version`` past the plan the reads actually used, and
            # the entry keyed at the CURRENT version must describe what a
            # scan at the current version would attribute
            try:
                recipe = q.attribution_groups(
                    q.plan(store, query0), np.arange(store.n_blocks))
            except UnrecoverableDataError:
                recipe = None          # can't describe a fresh scan: no fill

        # per live query: its matching rows of each split it is live on,
        # as host arrays per column
        per_query: list[list] = [[] for _ in queries]

        def finalize(qi: int):
            ticket, parts = batch[qi], per_query[qi]
            rows: dict[str, np.ndarray] = {}
            for c in tuple(ticket.query.projection) + (q.ROWID,):
                rows[c] = np.concatenate([p[c] for p in parts]) \
                    if parts else self._empty_col(c)
            n_rows = len(rows[q.ROWID])
            ticket.result = QueryResult(n_rows=n_rows, rows=rows,
                                        batch_size=len(batch),
                                        n_splits=n_splits)
            ticket.status = "done"
            stats.query_done_s[ticket.ticket_id] = time.perf_counter() - t0
            obs_trace.instant("finalize", track="server",
                              args={"ticket": ticket.ticket_id,
                                    "rows": n_rows})
            if recipe is not None:
                col, lo, hi = ticket.query.filter
                rc.put(col, lo, hi, tuple(ticket.query.projection),
                       store.version, rows, recipe)

        remaining = [0] * len(queries)     # live splits still outstanding
        for _, _, _, live, _ in dispatched:
            for qi in live:
                remaining[qi] += 1
        for qi in range(len(queries)):
            if remaining[qi] == 0:
                finalize(qi)               # live on nothing: done at once
        for res, shared, t_disp, live, ev in dispatched:
            if ev is not None:
                ev.synchronize()
            split_wall = time.perf_counter() - t_disp
            stats.split_s.append(split_wall)
            obs_trace.complete_wall("split", t_disp, split_wall,
                                    track="server",
                                    args={"batch_width": len(batch),
                                          "queries": [batch[qi].ticket_id
                                                      for qi in live]})
            stats.bytes_read += int(shared)
            for qi in live:
                # the member's matching rows, selected where they lie
                r = res[qi]
                keep = torch.nonzero(r.mask.reshape(-1)).squeeze(1)
                per_query[qi].append(
                    {c: v.reshape(-1).index_select(0, keep).cpu().numpy()
                     for c, v in r.cols.items()})
                remaining[qi] -= 1
                if remaining[qi] == 0:
                    finalize(qi)


# ---------------------------------------------------------------------------
# Async latency-SLO frontend (simulated-clock event loop over HailServer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """Auto-flush + fairness knobs for the ``ServerFrontend`` event loop.

    ``window_s`` is the latency-SLO knob: a flush cycle fires once the
    OLDEST pending query has waited this long (``float('inf')`` never
    auto-fires — the single-big-flush baseline, drained only by ``drain``).
    An infinite window disables the batch-full trigger too — the baseline
    is ONE big flush, not an accumulation that self-fires.
    ``max_batches_per_flush`` is one cycle's capacity; when more batches are
    pending, weighted-fair admission decides which dispatch first and the
    rest carry to the next cycle (None = no cap).  ``weights`` are per-
    tenant WFQ weights (default 1.0): under sustained overload a tenant
    with weight w receives ~w times the batch slots of a weight-1 tenant.
    """
    window_s: float = 0.05
    max_batches_per_flush: Optional[int] = None
    weights: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Arrival:
    """One offered query waiting in the frontend's admission queue."""
    seq: int
    query: HailQuery
    tenant: str
    arrival_s: float


class ServerFrontend:
    """Async serving loop with latency SLOs on top of a ``HailServer``.

    Callers ``offer`` queries stamped with SIMULATED arrival times; the
    event loop fires a flush cycle when the ``FlushPolicy`` says so — the
    oldest pending query is ``window_s`` old, or a compatible batch fills
    to ``max_batch`` — rather than a caller choosing when to ``flush``.
    Each cycle WFQ-admits up to ``max_batches_per_flush`` batches (per-
    tenant virtual time; leftovers carry), submits them through the
    server's admission control (over-quota members stay queued for the
    next cycle), flushes, and bridges the flush into the event-driven
    cluster simulator: per-query latency is

        max(trigger time, cluster busy-until) + that query's completion
        offset in the modeled schedule  -  its arrival time

    where the completion offset comes from ``run_schedule``'s
    ``query_completion_s`` (a query streams back when the LAST split it is
    live on finishes — result-cache hits and fully-pruned queries complete
    at offset 0).  The modeled cluster is busy until the schedule's
    makespan elapses, so back-to-back cycles queue behind each other —
    offered load beyond the service rate shows up as queueing latency,
    which is exactly the p50/p99-vs-load curve a load sweep reads.
    """

    def __init__(self, server: HailServer,
                 policy: Optional[FlushPolicy] = None):
        self.server = server
        self.policy = policy or FlushPolicy()
        self.now = 0.0
        self.busy_until = 0.0          # sim time the modeled cluster frees
        self._queue: list[_Arrival] = []
        self._seq = 0
        self._vtime: dict[str, float] = collections.defaultdict(float)
        self.latencies: dict[int, float] = {}    # ticket id -> sim seconds
        self.completed: dict[int, Ticket] = {}
        self.failed: list[Ticket] = []
        self.flushes: list[FlushStats] = []

    # -- event loop ---------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def offer(self, query: HailQuery, tenant: str = "default",
              at: Optional[float] = None) -> None:
        """Enqueue one query arriving at simulated time ``at`` (default:
        now).  Window deadlines that elapse before the arrival fire first
        (in arrival-time order), then the batch-full trigger."""
        at = self.now if at is None else float(at)
        self._advance(at)
        self._queue.append(_Arrival(self._seq, query, tenant, self.now))
        self._seq += 1
        if (np.isfinite(self.policy.window_s)
                and self._full_batch_pending()):
            self._flush_cycle(self.now, trigger="batch_full")

    def drain(self) -> "ServerFrontend":
        """Flush until the queue empties (the end-of-workload drain; also
        the ONLY trigger under the ``window_s=inf`` baseline policy)."""
        while self._queue:
            if not self._flush_cycle(max(self.now, self.busy_until),
                                     trigger="drain"):
                break                  # nothing admissible: avoid spinning
        return self

    def percentile_latency(self, p: float) -> float:
        """NEAREST-RANK percentile of the completed queries' simulated
        latencies — pinned semantics (``obs.metrics.nearest_rank``, never
        interpolated), so p50/p99 guards always report an actually
        observed latency and small-N results cannot shift with a numpy
        interpolation default.

        >>> fe = ServerFrontend.__new__(ServerFrontend)
        >>> fe.latencies = {0: 1.0, 1: 2.0, 2: 3.0, 3: 4.0}
        >>> fe.percentile_latency(50)
        2.0
        >>> fe.percentile_latency(99)
        4.0
        >>> fe.percentile_latency(25)
        1.0
        """
        return obs_metrics.nearest_rank(self.latencies.values(), p)

    def _advance(self, to: float) -> None:
        """Fire every window deadline that falls at or before ``to``."""
        w = self.policy.window_s
        while self._queue:
            deadline = min(p.arrival_s for p in self._queue) + w
            if deadline > to:
                break
            if not self._flush_cycle(deadline, trigger="window"):
                break                  # nothing admissible: avoid spinning
        self.now = max(self.now, to)

    # -- flush cycle --------------------------------------------------------

    def _batch_key(self, p: _Arrival):
        # mirrors HailServer._batches: same (filter col, projection) means
        # one shared scan; filterless queries cannot share
        if p.query.filter is None or self.server.store.layout != "pax":
            return ("__single__", p.seq)
        return (p.query.filter_col, tuple(p.query.projection))

    def _full_batch_pending(self) -> bool:
        counts: collections.Counter = collections.Counter(
            self._batch_key(p) for p in self._queue)
        return any(n >= self.server.config.max_batch
                   for key, n in counts.items() if key[0] != "__single__")

    def _flush_cycle(self, trigger_s: float,
                     trigger: str = "manual") -> bool:
        """One cycle: WFQ-order the pending batches, admit up to the
        policy's capacity through the server, flush, and stream modeled
        per-query completion times into ``latencies``.  ``trigger`` names
        the policy condition that fired (window / batch_full / drain) —
        recorded on every admitted ticket's EXPLAIN context and trace
        events.  Returns whether any query was admitted (False = no
        progress possible right now)."""
        groups: dict = {}
        for p in self._queue:
            groups.setdefault(self._batch_key(p), []).append(p)
        maxb = self.server.config.max_batch
        batches = [members[i:i + maxb] for members in groups.values()
                   for i in range(0, len(members), maxb)]
        # WFQ: a batch's priority is its best member's tenant virtual time
        # (ties: earliest arrival) — dispatching advances each member
        # tenant's vtime by 1/weight, so heavy-weight tenants drain faster
        batches.sort(key=lambda b: (min(self._vtime[p.tenant] for p in b),
                                    min(p.arrival_s for p in b),
                                    min(p.seq for p in b)))
        cap = self.policy.max_batches_per_flush
        if cap is not None:
            batches = batches[:cap]
        admitted: list[tuple[_Arrival, Ticket]] = []
        taken: set[int] = set()
        for b in batches:
            for p in b:
                try:
                    tk = self.server.submit(p.query, tenant=p.tenant)
                except AdmissionError:
                    continue           # over quota: retained for next cycle
                admitted.append((p, tk))
                taken.add(p.seq)
                self._vtime[p.tenant] += (
                    1.0 / self.policy.weights.get(p.tenant, 1.0))
        if not admitted:
            return False
        self._queue = [p for p in self._queue if p.seq not in taken]
        start = max(trigger_s, self.busy_until)
        stats = self.server.flush()
        self.flushes.append(stats)
        cm = self.server.config.cluster
        tasks = flush_tasks(stats)
        sched = run_schedule(
            tasks,
            SimulatedCluster(n_nodes=cm.n_nodes, map_slots=cm.map_slots),
            spec_factor=None)
        # enrich the flush's shared EXPLAIN context with the frontend's
        # view: the firing trigger, simulated start, per-ticket arrivals —
        # and hand it THIS schedule, so explain() decomposes exactly the
        # latency reported below
        ctx = admitted[0][1].explain_ctx
        if ctx is not None:
            ctx.trigger = trigger
            ctx.start_s = start
            ctx.provide_schedule(sched, tasks)
        tracer = obs_trace.current()
        if tracer is not None:
            tracer.complete_sim(
                "flush_cycle", start, sched.makespan_s, track="frontend",
                args={"trigger": trigger, "queries": len(admitted),
                      "makespan_s": sched.makespan_s})
            # query slices (and their flow STARTS) go first, so the
            # schedule's per-task flow steps chain arrival -> splits
            for p, tk in admitted:
                done = start + sched.query_completion_s.get(
                    tk.ticket_id, 0.0)
                tracer.complete_sim(
                    f"q{tk.ticket_id}", p.arrival_s, done - p.arrival_s,
                    track=f"tenant {tk.tenant}",
                    args={"ticket": tk.ticket_id, "trigger": trigger,
                          "queue_wait_s": start - p.arrival_s})
                tracer.flow("s", tk.ticket_id, p.arrival_s,
                            track=f"tenant {tk.tenant}")
            tracer.add_schedule(sched, tasks, base_s=start)
        for p, tk in admitted:
            self.completed[tk.ticket_id] = tk
            if ctx is not None:
                ctx.arrival_s[tk.ticket_id] = p.arrival_s
            if tk.status == "failed":
                self.failed.append(tk)
                continue
            done = start + sched.query_completion_s.get(tk.ticket_id, 0.0)
            self.latencies[tk.ticket_id] = done - p.arrival_s
            if ctx is not None:
                ctx.latency_s[tk.ticket_id] = done - p.arrival_s
        self.busy_until = start + sched.makespan_s
        self.now = max(self.now, trigger_s)
        return True
