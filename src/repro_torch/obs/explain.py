"""Per-query EXPLAIN: reconstruct why a served query took the time it did.

Latency is per query (``FlushStats.query_done_s`` measured,
``ScheduleResult.query_completion_s`` modeled); this module decomposes it —
queue wait vs service, which flush trigger fired, index vs full-scan blocks
per split, cache-tier outcome, retries survived, build/demotion walls
charged.  The port's copy of the JAX package's framework-free module.

``HailServer.flush`` attaches one shared ``FlushExplain`` context to every
ticket it answers; ``Ticket.explain()`` resolves it lazily into an
``ExplainRecord``.  The modeled decomposition is EXACT by construction:
a ticket's modeled completion is the end of the last scheduler task run
carrying its id, and that run's end decomposes as

    completion = sched_wait (run start)
               + speed-scaled (read + adaptive build + demotion rekey)

so ``accounted_s`` equals ``query_completion_s`` to float precision and
``accounted_fraction`` is 1.0 for cold queries, quarantine survivors, and (by the zero-denominator
convention: a result-cache hit is carried by no task and completes at
offset 0) cache hits alike.  The ``ServerFrontend`` enriches the context
with the simulated arrival, flush trigger and observed latency, turning
``sched_wait`` into true queue wait against the SLO clock.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SplitShare:
    """One scheduler task run this query's answer depended on, with its
    modeled wall decomposed into what the split actually did."""
    task_id: int
    node: int
    start_s: float
    end_s: float
    read_s: float          # speed-scaled shared-scan read wall
    build_s: float         # adaptive index build piggybacked on this split
    rekey_s: float         # governor demotion (un-sort) charged here
    batch_width: int       # queries sharing the split's one fused dispatch
    index_blocks: int = 0  # split's blocks served by the clustered index
    full_blocks: int = 0   # split's blocks that had to full-scan


@dataclasses.dataclass
class ExplainRecord:
    ticket_id: int
    tenant: str
    query: str
    status: str
    outcome: str            # result_hit | warm | mixed | cold | failed
    trigger: str            # manual | window | batch_full | drain
    completion_s: float     # modeled end-to-end (query_completion_s)
    sched_wait_s: float     # modeled wait before its last carrying run
    read_s: float           # service decomposition of that run
    build_s: float
    rekey_s: float
    accounted_s: float      # sched_wait + read + build + rekey
    accounted_fraction: float
    splits: list            # every carrying SplitShare, start order
    index_blocks: int       # per-query scan-mode totals across its splits
    full_blocks: int
    done_wall_s: Optional[float]    # measured stream-back offset (flush t0)
    queue_wait_s: Optional[float]   # sim: flush trigger - arrival (frontend)
    latency_s: Optional[float]      # sim: completion - arrival (frontend)
    retries_survived: int           # flush-level corruption re-plans
    quarantined: int                # flush-level blocks quarantined
    flush: dict                     # flush-level summary (caches, walls)
    error: Optional[str] = None

    def render(self) -> str:
        lines = [f"query #{self.ticket_id} ({self.tenant}): {self.query}",
                 f"  status={self.status}  outcome={self.outcome}  "
                 f"trigger={self.trigger}"]
        if self.latency_s is not None:
            lines.append(f"  latency          {self.latency_s:.3f}s  "
                         f"(queue wait {self.queue_wait_s:.3f}s + "
                         f"modeled service {self.completion_s:.3f}s)")
        lines.append(f"  modeled e2e      {self.completion_s:.4f}s  "
                     f"accounted {self.accounted_s:.4f}s "
                     f"({self.accounted_fraction:.1%})")
        lines.append(f"    sched wait     {self.sched_wait_s:.4f}s")
        lines.append(f"    shared read    {self.read_s:.4f}s")
        if self.build_s:
            lines.append(f"    adaptive build {self.build_s:.4f}s")
        if self.rekey_s:
            lines.append(f"    demote rekey   {self.rekey_s:.4f}s")
        lines.append(f"  scan mode        {self.index_blocks} index / "
                     f"{self.full_blocks} full-scan blocks "
                     f"over {len(self.splits)} splits")
        if self.done_wall_s is not None:
            lines.append(f"  streamed back    {self.done_wall_s * 1e3:.2f}ms"
                         f" after flush start (measured)")
        if self.retries_survived or self.quarantined:
            lines.append(f"  survived         {self.quarantined} quarantines"
                         f", {self.retries_survived} re-plan retries "
                         f"(flush-level)")
        fl = self.flush
        lines.append(f"  flush            {fl.get('n_queries', 0)} queries /"
                     f" {fl.get('n_batches', 0)} batches /"
                     f" {fl.get('n_splits', 0)} splits; block cache"
                     f" {fl.get('cache_hits', 0)}h/{fl.get('cache_misses', 0)}m;"
                     f" result cache {fl.get('result_cache_hits', 0)}h/"
                     f"{fl.get('result_cache_misses', 0)}m")
        if self.error:
            lines.append(f"  error            {self.error}")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()


class FlushExplain:
    """Shared per-flush context: owns the FlushStats and lazily bridges
    them through the scheduler exactly once (the ServerFrontend provides
    its own schedule instead, so explain agrees with the latency it
    reported).  One instance is attached to every ticket of a flush."""

    def __init__(self, stats, cluster_model):
        self.stats = stats
        self.cluster = cluster_model
        self.trigger = "manual"
        self.start_s = 0.0
        self.arrival_s: dict[int, float] = {}
        self.latency_s: dict[int, float] = {}
        self._tasks = None
        self._sched = None

    def provide_schedule(self, sched, tasks):
        self._sched, self._tasks = sched, tasks

    def schedule(self):
        if self._sched is None:
            from repro_torch.runtime.cluster import SimulatedCluster
            from repro_torch.runtime.jobserver import flush_tasks
            from repro_torch.runtime.scheduler import run_schedule
            self._tasks = flush_tasks(self.stats)
            self._sched = run_schedule(
                self._tasks,
                SimulatedCluster(n_nodes=self.cluster.n_nodes,
                                 map_slots=self.cluster.map_slots),
                spec_factor=None)
        return self._sched, self._tasks


def explain_ticket(ticket) -> ExplainRecord:
    """Build the ExplainRecord for one flushed ticket (``Ticket.explain``)."""
    ctx: Optional[FlushExplain] = getattr(ticket, "explain_ctx", None)
    if ctx is None:
        raise RuntimeError(
            f"ticket {ticket.ticket_id} has not been flushed yet — "
            f"explain() reconstructs a completed flush")
    stats = ctx.stats
    sched, tasks = ctx.schedule()
    tid = ticket.ticket_id
    completion = float(sched.query_completion_s.get(tid, 0.0))

    by_id = {t.task_id: t for t in tasks}
    shares: list[SplitShare] = []
    scan_modes = list(getattr(stats, "split_scan_modes", ()))
    for run in sorted(sched.runs, key=lambda r: r.start_s):
        task = by_id.get(run.task_id)
        if task is None or tid not in task.query_ids:
            continue
        work = task.duration_s + task.index_build_s + task.rekey_s
        scale = (run.end_s - run.start_s) / work if work > 0 else 0.0
        n_idx = n_full = 0
        if run.task_id < len(scan_modes):
            n_idx, n_full = scan_modes[run.task_id]
        shares.append(SplitShare(
            task_id=run.task_id, node=run.node,
            start_s=run.start_s, end_s=run.end_s,
            read_s=task.duration_s * scale,
            build_s=task.index_build_s * scale,
            rekey_s=task.rekey_s * scale,
            batch_width=task.n_queries,
            index_blocks=n_idx, full_blocks=n_full))

    # the EXACT decomposition: completion == last carrying run's end ==
    # its start (scheduler wait) + its speed-scaled service components
    if shares:
        last = max(shares, key=lambda s: s.end_s)
        sched_wait = last.start_s
        read_s, build_s, rekey_s = last.read_s, last.build_s, last.rekey_s
    else:
        sched_wait = read_s = build_s = rekey_s = 0.0
    accounted = sched_wait + read_s + build_s + rekey_s
    fraction = accounted / completion if completion > 0 else 1.0

    result = ticket.result
    if ticket.status == "failed":
        outcome = "failed"
    elif result is not None and result.from_cache:
        outcome = "result_hit"
    elif stats.cache_hits > 0 and stats.cache_misses == 0:
        outcome = "warm"          # every block-gather this flush was cached
    elif stats.cache_hits > 0:
        outcome = "mixed"
    else:
        outcome = "cold"

    arrival = ctx.arrival_s.get(tid)
    queue_wait = (ctx.start_s - arrival) if arrival is not None else None
    return ExplainRecord(
        ticket_id=tid, tenant=ticket.tenant, query=repr(ticket.query),
        status=ticket.status, outcome=outcome, trigger=ctx.trigger,
        completion_s=completion, sched_wait_s=sched_wait,
        read_s=read_s, build_s=build_s, rekey_s=rekey_s,
        accounted_s=accounted, accounted_fraction=fraction,
        splits=shares,
        index_blocks=sum(s.index_blocks for s in shares),
        full_blocks=sum(s.full_blocks for s in shares),
        done_wall_s=stats.query_done_s.get(tid),
        queue_wait_s=queue_wait,
        latency_s=ctx.latency_s.get(tid),
        retries_survived=stats.corrupt_retries,
        quarantined=stats.blocks_quarantined,
        flush={"n_queries": stats.n_queries, "n_batches": stats.n_batches,
               "n_splits": stats.n_splits, "wall_s": stats.wall_s,
               "modeled_s": stats.modeled_s,
               "cache_hits": stats.cache_hits,
               "cache_misses": stats.cache_misses,
               "result_cache_hits": stats.result_cache_hits,
               "result_cache_misses": stats.result_cache_misses},
        error=ticket.error)
