"""The split-driven MapReduce executor over the HAIL block store.

``run_job`` is the Hadoop-pipeline analogue: one record-reader call per
split (HailSplitting batches many blocks per split), with per-task
overheads accounted explicitly (a configurable simulated scheduler
constant, the paper's multi-second Hadoop overhead).  Execution is ASYNC:
every split's read is enqueued on the device up front, each followed by a
CUDA event, and one completion pass waits on the events in order — split
execution pipelines instead of serialising, with per-split timing preserved
via dispatch/completion timestamps (``JobStats.split_s``).
``reader="kernels"`` routes PAX splits through the fused one-launch
``read_hail_kernels``.  Node-failure injection re-schedules a failed node's
splits onto surviving replicas, falling back to full scan when the lost
replica held the only matching index (paper Fig 8).

``adaptive=AdaptiveConfig(...)`` enables LAZY ADAPTIVE INDEXING ("Towards
Zero-Overhead Adaptive Indexing in Hadoop"): full-scan splits additionally
sort + index an offered fraction of their still-unindexed blocks — the
bitonic ``kernels/block_sort`` kernel does the sort, the clustered root
directory comes from ``core/index`` — and commit the result back into the
``BlockStore`` mid-job, so repeated jobs over the same store converge from
all-full-scan to all-index-scan with no eager upload cost.  With an
index governor attached (``governor.govern``), adaptive jobs also DEMOTE
replicas to make room, and at the job boundary the store's scrubber and
replication controller tick.

``run_job(..., mesh=...)`` reads the splits in WAVES of up to n_dev splits,
one launch a split on its own slot of a ``launch.mesh.DeviceMesh`` (a
device and a stream).  ``spmd_aggregate`` is a GROUP-BY sum over a mesh
axis: combine per slot, shuffle bucket chunks, reduce.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import checksum as ck
from repro_torch.core import governor as gvn
from repro_torch.core import index as idx
from repro_torch.core import query as q
from repro_torch.core.fault import (CorruptBlockError, RecoveryConfig,
                                    UnrecoverableDataError)
from repro_torch.core.splitting import Split, hadoop_splits, hail_splits
from repro_torch.core.store import BlockStore
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass
class JobStats:
    n_tasks: int
    map_compute_s: float       # dispatch-to-last-completion wall (pipelined)
    overhead_s: float          # simulated scheduling
    bytes_read: int
    end_to_end_s: float        # compute + overhead (simulated cluster walltime)
    record_reader_s: float
    results: dict
    rescheduled_tasks: int = 0
    split_s: list = dataclasses.field(default_factory=list)
    # ^ per split: completion timestamp - its dispatch timestamp (includes
    #   queue wait behind earlier splits)
    blocks_indexed: int = 0    # adaptive: indexes committed by THIS job
    index_build_s: float = 0.0 # measured wall spent building/committing them
    build_s: list = dataclasses.field(default_factory=list)
    # ^ per executed split, aligned with split_s: index-build wall piggy-
    #   backed on that split (0.0 for splits that offered nothing)
    full_scan_blocks: int = 0  # blocks this job read WITHOUT an index
    modeled_s: float = 0.0     # deterministic latency: scheduling + disk
    blocks_demoted: int = 0    # governor: per-block indexes dropped by THIS
    #   job's demotions (workload shift re-claiming / budget eviction)
    rekey_s: float = 0.0       # measured wall spent demoting
    demote_s: list = dataclasses.field(default_factory=list)
    # ^ per executed split, aligned with split_s: demotion wall charged to
    #   the split that needed the room (0.0 otherwise)
    blocks_quarantined: int = 0  # corrupt (replica, block)s this job found
    corrupt_retries: int = 0     # splits re-planned after CorruptBlockError
    scrub_s: float = 0.0         # background-scrubber wall at the job
    #   boundary (verify + repair of quarantined blocks)


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Lazy adaptive indexing (LIAH) knobs.

    ``offer_rate``: fraction of the store's blocks offered for in-job index
    building — the per-job build budget is ``ceil(offer_rate * n_blocks)``
    (so an unindexed store converges in ~``ceil(1/offer_rate)`` jobs), spent
    by full-scan splits in dispatch order.  ``max_build_per_job`` caps the
    budget to bound the per-job latency tax of building.
    """
    offer_rate: float = 0.25
    max_build_per_job: int = 64


def _build_block_indexes(store: BlockStore, replica_id: int, block_ids,
                         key: str, *, partition_size: int) -> int:
    """Sort + index + commit ``block_ids`` of one replica by ``key``, as one
    batched sort per call (the ``kernels/block_sort`` bitonic kernel when
    rows is a power of two).  Bad records are forced to the tail with the
    INT32_MAX sentinel, exactly like the eager upload sort."""
    from repro_torch.kernels import ops

    rep = store.replicas[replica_id]
    bsel = np.asarray(block_ids)
    sel = torch.as_tensor(bsel.astype(np.int64), device=store.device)
    if store.verify_reads and len(bsel):
        # verify BEFORE building: sorting corrupt bytes and committing them
        # would recompute valid checksums over garbage, laundering the
        # corruption.  Failing blocks are quarantined and dropped.
        names = sorted(rep.cols)
        data = torch.stack([rep.cols[c][sel] for c in names])
        sums = torch.stack([rep.checksums[c][sel] for c in names])
        okm = ops.verify_blocks(data, sums).all(dim=0).cpu().numpy()
        for b in bsel[~okm]:
            store.quarantine_block(replica_id, int(b))
        bsel = bsel[okm]
        if len(bsel) == 0:
            return 0
        sel = torch.as_tensor(bsel.astype(np.int64), device=store.device)
    bad = q._bad_mask(store, replica_id)[sel]     # pre-commit (upload order)
    sent = torch.where(bad, idx.INT32_MAX, rep.cols[key][sel])
    cols = {c: v[sel] for c, v in rep.cols.items()}
    _, sorted_cols, _ = ops.sort_block(sent, cols)
    mins = idx.build_block_roots(sorted_cols[key], partition_size)
    sums = {c: ck.batched_chunk_checksums(v) for c, v in sorted_cols.items()}
    return store.commit_block_indexes(replica_id, bsel, key, sorted_cols,
                                      mins, sums)


def adaptive_quantum(store: BlockStore, adaptive: AdaptiveConfig) -> int:
    """Per-job build budget: offer_rate of the store's blocks (not of the
    shrinking remainder), so an unindexed store converges in
    ceil(1/offer_rate) jobs."""
    return min(adaptive.max_build_per_job,
               int(np.ceil(adaptive.offer_rate * store.n_blocks)))


def claim_adaptive_replica(store: BlockStore, adapt_col: str,
                           quantum: int) -> tuple[Optional[int], int, float]:
    """Pick the replica to (keep) converging toward ``adapt_col``: one
    already keyed on it, else the first unclaimed one.

    When every replica is claimed by other keys, ask the governor for its
    LRU victim, demote it, and re-claim — splits already planned keep
    reading the demoted replica as a full scan (upload order + original bad
    mask: the row set is preserved).  Gated on (a) a usable build quantum —
    a job that cannot rebuild must not destroy an index for nothing — and
    (b) the governor's claim-time hysteresis (``may_reclaim``).

    Returns (replica_id or None, blocks demoted, demotion wall seconds).
    """
    governor = store.governor
    adapt_rid = store.adaptive_replica_for(adapt_col)
    demoted, d_wall = 0, 0.0
    if (adapt_rid is None and governor is not None and quantum > 0
            and governor.may_reclaim(store, adapt_col)):
        victim = governor.victim(store, protect=(adapt_col,))
        if victim is not None:
            t_d = time.perf_counter()
            demoted = store.demote_replica(victim)
            d_wall = time.perf_counter() - t_d
            obs_trace.complete_wall("demote", t_d, d_wall, track="adaptive",
                                    args={"replica": victim,
                                          "blocks": demoted,
                                          "reclaim_for": adapt_col})
            adapt_rid = store.adaptive_replica_for(adapt_col)
    return adapt_rid, demoted, d_wall


def piggyback_build(store: BlockStore, sp: Split, adapt_rid: int,
                    adapt_col: str, build_budget: int
                    ) -> tuple[int, int, float, float]:
    """Adaptive piggyback for ONE full-scan split: this split already read
    its blocks — sort + index an offered few of the still-unindexed ones
    and commit them for the NEXT job (the split's own read was dispatched
    pre-commit, on inputs the commit cannot touch).  Under budget pressure,
    evict LRU victims until the offer fits, else trim it (the budget is
    never exceeded).

    Returns (built, demoted, build wall seconds, demotion wall seconds).
    """
    governor = store.governor
    if build_budget <= 0 or sp.index_scan:
        return 0, 0, 0.0, 0.0
    rep = store.replicas[adapt_rid]
    dead = store.namenode.dead
    offer = [b for b in sp.block_ids
             if not rep.indexed[b]
             and int(rep.nodes[b]) not in dead
             and not store.is_quarantined(adapt_rid, b)][:build_budget]
    demoted, d_wall, b_wall = 0, 0.0, 0.0
    if offer and governor is not None:
        room = governor.room(store)
        while len(offer) > room:
            victim = governor.victim(store, protect=(adapt_col,))
            if victim is None:
                offer = offer[:max(int(room), 0)]
                break
            t_d = time.perf_counter()
            demoted += store.demote_replica(victim)
            d_wall += time.perf_counter() - t_d
            obs_trace.complete_wall("demote", t_d,
                                    time.perf_counter() - t_d,
                                    track="adaptive",
                                    args={"replica": victim,
                                          "reason": "budget"})
            room = governor.room(store)
    built = 0
    if offer:
        t_b = time.perf_counter()
        built = _build_block_indexes(store, adapt_rid, offer, adapt_col,
                                     partition_size=store.partition_size)
        b_wall = time.perf_counter() - t_b
        obs_trace.complete_wall("adaptive_build", t_b, b_wall,
                                track="adaptive",
                                args={"replica": adapt_rid,
                                      "column": adapt_col, "blocks": built})
    return built, demoted, b_wall, d_wall


def failover_replan(store: BlockStore, query: q.HailQuery,
                    pending: list, i: int):
    """Node-death re-plan: kill the node serving ``pending[i]``, re-plan the
    NOT-yet-executed splits it owned onto surviving replicas as per-block
    retry splits (falling back to full scan when the lost replica held the
    only matching index), and splice them after the surviving pending
    splits.  Splits dispatched before the failure already ran — their
    results stand, exactly as completed map tasks do in Hadoop.

    Returns (new_pending, new_qplan, failed_node, n_retries).
    """
    failed_node = pending[i].node
    store.namenode.kill_node(failed_node)
    qplan = q.plan(store, query)
    survivors = [s for s in pending[i:] if s.node != failed_node]
    lost = [b for s in pending[i:] if s.node == failed_node
            for b in s.block_ids]
    retries = [Split(node=int(qplan.nodes[b]), block_ids=(b,),
                     index_scan=bool(qplan.index_scan[b])) for b in lost]
    return (pending[:i] + survivors + retries, qplan, failed_node,
            len(retries))


@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """Simulated-cluster constants."""
    sched_overhead_s: float = 3.0      # Hadoop per-task scheduling (paper §6.4)
    hail_sched_overhead_s: float = 3.0 # same scheduler; fewer tasks is the win
    disk_bw: float = 100e6             # B/s (paper's 100MB/s disk)
    n_nodes: int = 10
    map_slots: int = 4


def job_tasks(stats: JobStats) -> list:
    """Bridge a finished job into the event-driven cluster simulator: one
    ``runtime/scheduler.Task`` per executed split, with the measured
    per-split read wall as the duration and the index-build and demotion
    walls the split piggybacked charged through ``Task.index_build_s`` and
    ``Task.rekey_s``."""
    from repro_torch.runtime.scheduler import Task
    demote = stats.demote_s or [0.0] * len(stats.split_s)
    return [Task(i, dur, preferred_nodes=(), index_build_s=build,
                 rekey_s=rekey)
            for i, (dur, build, rekey) in enumerate(zip(stats.split_s,
                                                        stats.build_s,
                                                        demote))]


def _completion_event(device: torch.device, stream=None):
    """A CUDA event recorded after everything enqueued so far on ``stream``
    (default: the device's current stream) — None on the CPU, where every
    operation has finished when it returns."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device) if stream is None
              else stream)
    return ev


def read_wave(store: BlockStore, queries, gathered: list, mesh,
              axes: tuple) -> list[tuple]:
    """Read one wave of gathered splits, one launch a split on its own
    slot (``query.read_hail_batch_sharded``) -> per split (results per
    query, shared bytes, completion event), the event recorded on the
    stream of the slot that ran the split."""
    out = q.read_hail_batch_sharded(store, queries, gathered, mesh, axes)
    return [(res, shared, _completion_event(slot.device, slot.stream))
            for slot, (res, shared) in zip(mesh.slots(axes), out)]


def scan_mesh(mesh, store: BlockStore, query) -> tuple[tuple, int]:
    """(scan axes, n_dev) when a job or batch over ``store`` shards its
    scan over ``mesh``: a PAX store, a range filter, and a scan axis of
    more than one slot; else ((), 1), the per-split path."""
    if mesh is None or store.layout != "pax" or query.filter is None:
        return (), 1
    from repro_torch.dist import sharding as shd
    axes = shd.scan_mesh_axes(mesh)
    n_dev = shd.scan_device_count(mesh, axes)
    return (axes, n_dev) if n_dev > 1 else ((), 1)


def run_job(store: BlockStore, query: q.HailQuery, *,
            splitting: str = "hail", cluster: ClusterModel = ClusterModel(),
            reduce_fn: Optional[Callable] = None,
            fail_node_at: Optional[float] = None,
            reader: str = "jnp",
            mesh=None,
            adaptive: Optional[AdaptiveConfig] = None,
            recovery: RecoveryConfig = RecoveryConfig(),
            on_split_complete: Optional[Callable] = None) -> JobStats:
    """Execute filter/project (+optional reduce) over all blocks, on the
    device the store's tensors live on.

    reader: 'jnp' (the batched plain-tensor record reader; the name is the
    JAX package's) or 'kernels' (the fused split reader — one kernel launch
    per split).

    mesh: a ``launch.mesh.DeviceMesh`` to SHARD the scan over — splits are
    gathered as usual (cache, verification and attribution per split,
    keeping the serial semantics of piggyback commits and failover) but
    read in WAVES of up to n_dev splits, each split one fused reader
    launch on its own slot (``query.read_hail_batch_sharded``: waves =
    ceil(splits / n_dev)).  The scan axes come from
    ``dist.sharding.scan_mesh_axes`` (size-1 axes dropped); a mesh with no
    scan axis of more than one slot, a non-PAX store or an unfiltered
    query takes the per-split path.  Row-sets are identical to the per-split
    path's.

    adaptive: when set (and the job filters a PAX store), full-scan splits
    piggyback clustered-index builds for an offered fraction of their
    unindexed blocks and commit them back into the store — this job's reads
    keep their dispatch-time plan; the NEXT job plans against the richer
    store.  Re-queued failover splits full-scan and are offered too.

    When the store carries an index governor (``governor.govern(store)``),
    adaptive jobs also DEMOTE: if every replica is claimed by other keys,
    the governor's LRU victim is dropped back to unclaimed so this workload
    can re-claim it; if committing an offer would exceed the storage
    budget, victims are evicted (or the offer trimmed) first.  Demotion
    walls are charged per split (``JobStats.demote_s``/``rekey_s``).

    recovery: corruption/failover retry policy.  A split whose read-path
    verification raises ``CorruptBlockError`` quarantines the corrupt
    (replica, block) at the namenode and re-plans the split's blocks onto
    surviving replicas as per-block retry splits.  Retries are BOUNDED per
    block (``recovery.max_retries``); exhausting it, or losing every replica
    of a block, raises ``UnrecoverableDataError`` — never silent wrong rows.
    With ``recovery.scrub`` and a scrubber attached (``store.scrubber``),
    the job boundary also verifies a budgeted batch of blocks and repairs
    whatever is quarantined (``JobStats.scrub_s``); an attached replication
    controller (``store.replicator``) ticks there too.

    on_split_complete: streaming hook — called once per executed split, in
    completion order, as each result's barrier clears, with
    ``(split_index, read_result, split_wall_s)``.
    """
    gvn.note_job_start(store)
    with obs_trace.span("job_plan", track="job"):
        qplan = q.plan(store, query)
    if store.layout != "pax":
        splits = hadoop_splits(store, qplan)
    elif splitting == "hail":
        splits = hail_splits(store, qplan, cluster.map_slots)
    else:
        splits = hadoop_splits(store, qplan)

    fail_after = (int(len(splits) * fail_node_at)
                  if fail_node_at is not None else None)
    failed_node = None
    rescheduled = 0

    # --- adaptive offer budget: ceil(offer_rate * n_blocks), capped --------
    adapt_rid, adapt_col, build_budget = None, None, 0
    blocks_demoted = 0
    demote_pending_s = 0.0    # job-start demotion wall, charged to split 0
    if (adaptive is not None and store.layout == "pax"
            and query.filter is not None):
        adapt_col = query.filter_col
        quantum = adaptive_quantum(store, adaptive)
        adapt_rid, claim_demoted, claim_wall = claim_adaptive_replica(
            store, adapt_col, quantum)
        blocks_demoted += claim_demoted
        demote_pending_s += claim_wall
        if adapt_rid is not None and len(store.unindexed_blocks(adapt_rid)):
            build_budget = quantum

    def read_split(sp: Split):
        if store.layout != "pax":
            return q.read_hadoop(store, query, list(sp.block_ids))
        if reader == "kernels" and query.filter is not None:
            return q.read_hail_kernels(store, query, qplan,
                                       list(sp.block_ids))
        return q.read_hail(store, query, qplan, list(sp.block_ids))

    # --- sharded scan: waves of up to n_dev splits, one launch a split ----
    scan_axes, n_dev = scan_mesh(mesh, store, query)
    use_sharded = n_dev > 1

    # --- dispatch phase: enqueue every split's read without waiting --------
    dispatched: list[tuple] = []   # (ReadResult, completion event, stamp)
    build_s: list[float] = []      # per split, aligned with dispatched
    demote_s: list[float] = []     # per split, aligned with dispatched
    blocks_indexed = 0
    full_scan_blocks = 0
    blocks_quarantined = 0
    corrupt_retries = 0
    retry_count: collections.Counter = collections.Counter()

    def note_retries(block_ids):
        """Charge one re-plan attempt to each block; a block that keeps
        failing surfaces a typed error instead of looping forever."""
        for b in block_ids:
            retry_count[b] += 1
            if retry_count[b] > recovery.max_retries:
                raise UnrecoverableDataError(
                    f"block {b}: re-plan retry budget "
                    f"({recovery.max_retries}) exhausted")

    wave: list = []                # gathered inputs of the buffered splits

    def flush_wave():
        """Read the buffered wave, one launch a split on its own slot; the
        gathered inputs are snapshots, so commits, demotions and failover
        that landed since gathering cannot change these splits' row-sets."""
        if not wave:
            return
        for res, _, ev in read_wave(store, [query], wave, mesh, scan_axes):
            dispatched.append((res[0], ev, time.perf_counter()))
        wave.clear()

    t_start = time.perf_counter()
    with obs_trace.span("job_dispatch", track="job"):
        i = 0
        pending = list(splits)
        while i < len(pending):
            if (fail_after is not None and i == fail_after
                    and failed_node is None):
                # kill the node that would serve the next split and re-plan
                # (splits already in the wave buffer gathered their inputs:
                # like completed map tasks, their results stand)
                pending, qplan, failed_node, rescheduled = failover_replan(
                    store, query, pending, i)
                if rescheduled:
                    note_retries(b for s in pending[-rescheduled:]
                                 for b in s.block_ids)
                if i >= len(pending):
                    break
            sp = pending[i]
            i += 1
            try:
                if use_sharded:
                    gathered = q.gather_shared_scan_inputs(
                        store, [query], qplan, list(sp.block_ids))
                else:
                    res = read_split(sp)
            except CorruptBlockError as e:
                # detection -> recovery: quarantine the corrupt copy,
                # re-plan against the now-smaller replica set, and re-queue
                # this split's blocks as per-block retry splits
                store.quarantine_block(e.replica_id, e.block_id)
                blocks_quarantined += 1
                corrupt_retries += 1
                obs_trace.instant("corrupt_retry", track="job",
                                  args={"replica": e.replica_id,
                                        "block": e.block_id})
                note_retries(sp.block_ids)
                qplan = q.plan(store, query)
                pending.extend(
                    Split(node=int(qplan.nodes[b]), block_ids=(b,),
                          index_scan=bool(qplan.index_scan[b]))
                    for b in sp.block_ids)
                continue
            if use_sharded:
                wave.append(gathered)
            else:
                dispatched.append((res, _completion_event(store.device),
                                   time.perf_counter()))
            if not sp.index_scan:
                full_scan_blocks += len(sp.block_ids)
            # --- adaptive piggyback: this full-scan split already read these
            # blocks — sort + index an offered few and commit them for the
            # NEXT job (this split's own read was dispatched pre-commit) ------
            d_wall, demote_pending_s = demote_pending_s, 0.0
            b_wall = 0.0
            if build_budget > 0:
                built, demoted, b_wall, dd_wall = piggyback_build(
                    store, sp, adapt_rid, adapt_col, build_budget)
                build_budget -= built
                blocks_indexed += built
                blocks_demoted += demoted
                d_wall += dd_wall
            build_s.append(b_wall)
            demote_s.append(d_wall)
            if len(wave) == n_dev:
                flush_wave()
        flush_wave()               # the ragged final wave

    # --- completion phase: one pass of barriers over the queued results ---
    with obs_trace.span("job_complete", track="job"):
        bytes_read = 0
        masks, cols, split_s = [], [], []
        for k, (res, ev, t_disp) in enumerate(dispatched):
            if ev is not None:
                ev.synchronize()
            split_s.append(time.perf_counter() - t_disp)
            obs_trace.complete_wall("split", t_disp, split_s[-1], track="job",
                                    args={"split": k})
            bytes_read += int(res.bytes_read)   # lazy scalar, post-barrier
            masks.append(res.mask.cpu().numpy())
            cols.append({c: v.cpu().numpy() for c, v in res.cols.items()})
            if on_split_complete is not None:
                on_split_complete(k, res, split_s[-1])
    compute_s = time.perf_counter() - t_start

    n_tasks = len(pending)
    overhead = n_tasks * (cluster.hail_sched_overhead_s
                          if splitting == "hail" and store.layout == "pax"
                          else cluster.sched_overhead_s)
    if failed_node is not None:
        store.namenode.revive(failed_node)

    # job boundary: budgeted background scrub (verify cold blocks, repair
    # anything quarantined) — corruption is found before queries hit it
    scrub_s = 0.0
    if recovery.scrub and store.scrubber is not None:
        t_s = time.perf_counter()
        store.scrubber.tick()
        scrub_s = time.perf_counter() - t_s
        obs_trace.complete_wall("scrub_tick", t_s, scrub_s, track="job")

    # job boundary: replication-controller quantum — the heat this job just
    # wrote into the AccessLog moves replica COUNTS (add hot / retire cold)
    if store.layout == "pax" and store.replicator is not None:
        store.replicator.tick()

    mask = np.concatenate(masks, axis=0)
    out = {c: np.concatenate([d[c] for d in cols], axis=0)
           for c in cols[0]} if cols else {}
    results = {"n_rows": int(mask.sum()),
               "sample": {c: v.reshape(-1)[mask.reshape(-1)][:8]
                          for c, v in out.items()}}
    if reduce_fn is not None:
        results["reduce"] = reduce_fn(out, mask)

    # simulated end-to-end: scheduling overhead amortized over the cluster's
    # parallel task slots, measured map compute spread over the nodes, and
    # modeled disk time for the bytes actually read (index scans read less).
    disk_s = bytes_read / (cluster.disk_bw * cluster.n_nodes)
    e2e = (overhead / (cluster.n_nodes * cluster.map_slots)
           + compute_s / cluster.n_nodes + disk_s)
    modeled = overhead / (cluster.n_nodes * cluster.map_slots) + disk_s
    stats = JobStats(n_tasks=n_tasks, map_compute_s=compute_s,
                     overhead_s=overhead, bytes_read=bytes_read,
                     end_to_end_s=e2e,
                     record_reader_s=compute_s / cluster.n_nodes + disk_s,
                     results=results, rescheduled_tasks=rescheduled,
                     split_s=split_s, blocks_indexed=blocks_indexed,
                     index_build_s=sum(build_s), build_s=build_s,
                     full_scan_blocks=full_scan_blocks, modeled_s=modeled,
                     blocks_demoted=blocks_demoted, rekey_s=sum(demote_s),
                     demote_s=demote_s,
                     blocks_quarantined=blocks_quarantined,
                     corrupt_retries=corrupt_retries, scrub_s=scrub_s)
    obs_trace.complete_wall("job", t_start, compute_s, track="job",
                            args={"tasks": n_tasks,
                                  "bytes_read": bytes_read,
                                  "blocks_indexed": blocks_indexed,
                                  "rescheduled": rescheduled})
    obs_metrics.observe_job(stats)
    return stats


# ---------------------------------------------------------------------------
# SPMD aggregation: map + combine per slot -> shuffle -> reduce
# ---------------------------------------------------------------------------


def spmd_aggregate(mesh, key_col: torch.Tensor, val_col: torch.Tensor,
                   mask: torch.Tensor, n_buckets: int, axis: str = "data"):
    """GROUP-BY-sum: (blocks, rows) keys / values / mask, blocks split over
    the slots of ``axis`` in equal tiles -> (n_buckets,) float32 sums and
    counts, on ``key_col``'s device.  n_buckets must divide by the axis'
    size.

    A loop over the axis' slots, one process: each slot's combiner sums its
    blocks' masked values and counts per bucket (``key % n_buckets``) in
    float32 with ``index_add_``, block by block, then over its blocks; the
    shuffle sends bucket chunk j of every slot's partials to slot j's
    device; slot j's reduce sums the chunks it received.  Unlike the JAX
    package's one segment sum per device, the combiner keeps one partial
    per block before summing them, so the float32 error stays that of a
    block's rows (the two agree exactly where every partial sum is an
    integer below 2^24)."""
    slots = mesh.slots((axis,))
    n_dev = len(slots)
    if n_dev <= 0 or n_buckets % n_dev != 0:
        raise ValueError(
            f"spmd_aggregate: n_buckets={n_buckets} must be a positive "
            f"multiple of mesh axis {axis!r} size {n_dev} (each slot "
            f"reduces n_buckets/n_dev buckets after the shuffle)")
    if key_col.shape[0] % n_dev != 0:
        raise ValueError(f"spmd_aggregate: {key_col.shape[0]} blocks do not "
                         f"split into {n_dev} equal tiles")
    per_dev = n_buckets // n_dev
    tile = key_col.shape[0] // n_dev
    partials = []                            # per slot: (sums, counts)
    for i, slot in enumerate(slots):
        part = [t[i * tile:(i + 1) * tile] for t in (key_col, val_col, mask)]
        with slot.run(part):
            keys, vals, msk = (t.to(slot.device) for t in part)
            nb, rows = keys.shape
            # one bucket row per block: (block, bucket) flattened
            k = ((keys.long() % n_buckets)
                 + n_buckets * torch.arange(nb, device=slot.device)[:, None])
            v = torch.where(msk, vals.to(torch.float32), 0.0)
            c = msk.to(torch.float32)
            out = []
            for x in (v, c):
                acc = torch.zeros(nb * n_buckets, dtype=torch.float32,
                                  device=slot.device)
                acc.index_add_(0, k.reshape(-1), x.reshape(-1))
                out.append(acc.view(nb, n_buckets).sum(dim=0))
        slot.join(out)
        partials.append(out)
    sums, cnts = [], []
    for j, slot in enumerate(slots):
        chunk = slice(j * per_dev, (j + 1) * per_dev)
        sums.append(sum(p[0][chunk].to(slot.device) for p in partials)
                    .to(key_col.device))
        cnts.append(sum(p[1][chunk].to(slot.device) for p in partials)
                    .to(key_col.device))
    return torch.cat(sums), torch.cat(cnts)
