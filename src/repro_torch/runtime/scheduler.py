"""Event-driven task scheduler with speculative execution (stragglers) and
replica-aware failover — the JobTracker analogue for the simulated cluster.
The port's copy of the JAX package's framework-free module.

Semantics implemented (and benchmarked in bench_failover / tests):
  * data-locality-first placement: a task prefers its replica nodes
    (namenode Dir_block), falling back to any free slot;
  * fail-stop nodes: tasks running on a node that dies are re-queued once
    the heartbeat expiry detects the death (paper §6.4.3's 30s);
  * speculative re-execution: when a running task exceeds
    ``spec_factor x`` the median completed duration, a duplicate launches on
    a different node; first finisher wins (straggler mitigation).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

from repro_torch.runtime.cluster import SimulatedCluster


@dataclasses.dataclass
class Task:
    task_id: int
    duration_s: float                   # nominal duration on a speed-1 node
    preferred_nodes: tuple[int, ...]    # replica locations
    index_build_s: float = 0.0          # adaptive indexing piggybacked on
    #   this map task (JobStats.build_s) — charged into the task's runtime
    #   so convergence-era tasks are honestly slower in the simulation
    rekey_s: float = 0.0                # governor demotion (un-sort +
    #   re-checksum of an evicted replica) triggered by this task
    #   (JobStats.demote_s) — charged the same way as index builds
    n_queries: int = 1                  # queries served by this task: a
    #   HailServer shared-scan task answers a whole batch with one fused
    #   dispatch, so Q rides on one task's scheduling overhead —
    #   ScheduleResult.n_query_answers totals these (query, split) answers
    #   across the schedule (distinct-query throughput is the caller's to
    #   compute: bench_server divides Q by the makespan)
    query_ids: tuple[int, ...] = ()     # the distinct queries whose answers
    #   DEPEND on this task (a shared-scan split carries the batch members
    #   it is live for) — run_schedule folds these into per-query
    #   completion timestamps (ScheduleResult.query_completion_s), the
    #   latency signal the ServerFrontend's SLO accounting consumes


@dataclasses.dataclass
class TaskRun:
    task_id: int
    node: int
    start_s: float
    end_s: float
    speculative: bool = False


@dataclasses.dataclass
class ScheduleResult:
    makespan_s: float
    runs: list[TaskRun]
    n_speculative: int
    n_failovers: int
    locality_fraction: float
    n_query_answers: int = 0            # total (query, split) answers the
    #   tasks produced — NOT distinct queries (a Q-wide batch over S splits
    #   counts Q*S), so dividing by makespan gives answer throughput; for
    #   query throughput divide the caller's distinct-query count instead
    query_completion_s: dict = dataclasses.field(default_factory=dict)
    #   query id -> simulated time its LAST carrying task finished (a query
    #   streams back the moment every split it depends on has completed,
    #   not at the schedule's end) — queries carried by no task (e.g.
    #   result-cache hits, fully pruned ranges) complete at time 0


def run_schedule(tasks: list[Task], cluster: SimulatedCluster,
                 spec_factor: Optional[float] = 1.8) -> ScheduleResult:
    """Simulate executing `tasks` to completion. Returns timing stats."""
    slots: dict[int, int] = {n.node_id: cluster.map_slots for n in cluster.nodes}
    queue = list(tasks)
    running: list[tuple[float, int, TaskRun]] = []   # heap by end time
    done: dict[int, TaskRun] = {}
    durations: list[float] = []
    now = 0.0
    n_spec = n_failover = local_hits = assignments = 0
    seq = 0
    launched_spec: set[int] = set()

    def launch(task: Task, speculative: bool, avoid: Optional[int] = None):
        nonlocal seq, local_hits, assignments
        alive = [n for n in cluster.alive_nodes()
                 if slots[n] > 0 and n != avoid and not cluster.is_failed(n, now)]
        if not alive:
            return False
        pref = [n for n in task.preferred_nodes if n in alive]
        node = pref[0] if pref else alive[seq % len(alive)]
        if pref:
            local_hits += 1
        assignments += 1
        seq += 1
        slots[node] -= 1
        speed = cluster.nodes[node].speed
        work_s = task.duration_s + task.index_build_s + task.rekey_s
        run = TaskRun(task.task_id, node, now, now + work_s * speed,
                      speculative=speculative)
        heapq.heappush(running, (run.end_s, seq, run))
        return True

    task_by_id = {t.task_id: t for t in tasks}
    # initial fill
    pending = list(queue)
    progressed = True
    while pending or running:
        # launch as many pending as possible
        still = []
        for t in pending:
            if t.task_id in done:
                continue
            if not launch(t, speculative=False):
                still.append(t)
        pending = still

        if not running:
            if pending:
                # all nodes busy/dead: advance detection clock
                now += cluster.heartbeat_expiry_s
                cluster.tick(now)
                continue
            break

        end_s, _, run = heapq.heappop(running)
        now = max(now, end_s)
        cluster.tick(now)

        if cluster.is_failed(run.node, now):
            # node died mid-task: requeue after detection
            if run.task_id not in done:
                n_failover += 1
                t = task_by_id[run.task_id]
                now = max(now, cluster._fail_at[run.node]
                          + cluster.heartbeat_expiry_s)
                cluster.tick(now)
                pending.append(t)
            continue

        slots[run.node] += 1
        if run.task_id not in done:
            done[run.task_id] = run
            durations.append(run.end_s - run.start_s)

        # speculative launch check for the slowest running tasks
        if spec_factor is not None and durations:
            med = sorted(durations)[len(durations) // 2]
            for (e, _, r) in list(running):
                if (r.task_id not in done and r.task_id not in launched_spec
                        and (e - r.start_s) > spec_factor * med):
                    if launch(task_by_id[r.task_id], speculative=True,
                              avoid=r.node):
                        launched_spec.add(r.task_id)
                        n_spec += 1

    makespan = max((r.end_s for r in done.values()), default=0.0)
    completion: dict = {}
    for run in done.values():
        for qid in task_by_id[run.task_id].query_ids:
            completion[qid] = max(completion.get(qid, 0.0), run.end_s)
    return ScheduleResult(
        makespan_s=makespan, runs=list(done.values()), n_speculative=n_spec,
        n_failovers=n_failover,
        locality_fraction=local_hits / max(assignments, 1),
        n_query_answers=sum(t.n_queries for t in tasks),
        query_completion_s=completion)
