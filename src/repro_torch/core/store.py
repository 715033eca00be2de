"""Replicated PAX block store + namenode metadata (paper §3.2-§3.3).

``BlockStore`` holds R physically different replicas of every logical block:
replica r is sorted by its own key with a sparse clustered index and its own
checksums (sort order differs => checksums differ, exactly as in the paper).
An implicit ``__rowid__`` column preserves logical row identity, so *any*
replica reconstructs the logical block (failover invariant).

``Namenode`` is the central directory: ``dir_block`` (blockID -> datanodes)
plus HAIL's addition ``dir_rep`` ((blockID, node) -> HAILBlockReplicaInfo)
used by the scheduler to route map tasks to matching indexes (§3.3, §4.3).

Adaptive indexing (LIAH) makes the store STATE-EVOLVING: blocks may upload
unindexed (``Replica.indexed`` all-False) and running jobs commit per-block
clustered indexes back via ``commit_block_indexes`` — the replica's columns,
root directory, checksums, per-block index flags and the namenode's Dir_rep
all advance together, and query-side caches (the bad-row mask, any
attached ``core/cache.BlockCache``) are invalidated.

The index governor (``core/governor.py``) adds the reverse transition:
``demote_replica`` drops a replica's per-block indexes back to upload order
(un-sorted through the logical ``__rowid__`` column, root directory zeroed,
checksums recomputed, Dir_rep rewound), so a shifted workload can re-claim
the replica.  Dynamic replication adds ``add_replica`` (a fresh unclaimed
replica cloned in upload order) and ``decommission_replica`` (a retired
tombstone).  Corruption found on the read path or by the scrubber is
quarantined per (block, node) and rebuilt by ``repair_blocks`` from a
healthy replica, under the victim's own sort order.

Aliasing: the replicas of a lazy upload share their column tensors, and a
reader's gathered inputs may still be in flight on the device when a commit
lands.  JAX updates are functional, so sharing costs nothing there; in
PyTorch ``t[b] = v`` writes in place and would silently rewrite every
replica and every pending read that shares ``t``.  So every store
transition here (commit, repair, demotion) COPIES ON WRITE (``index_copy``
out of place) and rebinds the replica's entry; no tensor the store hands
out is ever written again.  Only a tensor the transition has just made
(``add_replica``'s new columns) is filled in place.

``store_from_numpy`` builds a store from a plain dict of numpy arrays (the
layout ``store_to_numpy`` writes), so both packages can start from identical
state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import checksum as ck
from repro_torch.core import index as idx
from repro_torch.core.schema import ROWID, SCHEMAS, Schema


def default_device(device) -> torch.device:
    """``None`` means the card."""
    return torch.device("cuda" if device is None else device)


@dataclasses.dataclass(frozen=True)
class ReplicaInfo:
    """HAILBlockReplicaInfo: what the namenode knows about one replica."""
    block_id: int
    node: int
    sort_key: Optional[str]        # clustered-index key (None = unindexed)
    partition_size: int
    n_rows: int
    layout: str                    # 'pax' | 'row_ascii'
    nbytes: int


class Namenode:
    """Central metadata service (Dir_block + Dir_rep + liveness)."""

    def __init__(self):
        self.dir_block: dict[int, list[int]] = {}
        self.dir_rep: dict[tuple[int, int], ReplicaInfo] = {}
        self.dead: set[int] = set()
        # (block_id, node) pairs whose replica failed read-path checksum
        # verification — excluded from placement like a dead node, but at
        # BLOCK granularity, and reversible only by repair_blocks (never by
        # revive: a revived node's corrupt block is still corrupt)
        self.quarantined: set[tuple[int, int]] = set()

    def register(self, info: ReplicaInfo):
        self.dir_block.setdefault(info.block_id, []).append(info.node)
        self.dir_rep[(info.block_id, info.node)] = info

    def locate(self, block_id: int) -> list[int]:
        return [n for n in self.dir_block[block_id]
                if n not in self.dead
                and (block_id, n) not in self.quarantined]

    def quarantine(self, block_id: int, node: int):
        self.quarantined.add((block_id, node))

    def clear_quarantine(self, block_id: int, node: int):
        self.quarantined.discard((block_id, node))

    def is_quarantined(self, block_id: int, node: int) -> bool:
        return (block_id, node) in self.quarantined

    def replicas(self, block_id: int) -> list[ReplicaInfo]:
        return [self.dir_rep[(block_id, n)] for n in self.locate(block_id)]

    def get_hosts_with_index(self, block_id: int, key: str) -> list[int]:
        """The paper's new BlockLocation.getHostsWithIndex()."""
        return [r.node for r in self.replicas(block_id) if r.sort_key == key]

    def update_index(self, block_id: int, node: int,
                     sort_key: Optional[str]):
        """Adaptive-index commit (or governor demotion rewind): a running
        job built — or the governor dropped — a clustered index for this
        replica; advance or rewind Dir_rep so later planning sees it.
        ``sort_key=None`` rewinds the replica to unindexed."""
        info = self.dir_rep[(block_id, node)]
        self.dir_rep[(block_id, node)] = dataclasses.replace(
            info, sort_key=sort_key)

    def unregister(self, block_id: int, node: int):
        """Decommission: drop one replica's (block, node) registration —
        Dir_block, Dir_rep and any quarantine record for the pair."""
        nodes = self.dir_block.get(block_id, [])
        if node in nodes:
            nodes.remove(node)
        self.dir_rep.pop((block_id, node), None)
        self.quarantined.discard((block_id, node))

    def kill_node(self, node: int):
        self.dead.add(node)

    def revive(self, node: int | None = None):
        if node is None:
            self.dead.clear()
        else:
            self.dead.discard(node)


@dataclasses.dataclass
class Replica:
    """One sort order of the whole dataset: per-column (n_blocks, rows).

    ``sort_key`` is the replica's clustered-index key; ``indexed`` tracks the
    PER-BLOCK index state.  An unindexed block's rows sit in upload order; an
    indexed block's rows are sorted by ``sort_key`` with bad records at the
    tail.  ``sort_key is None`` with all-False ``indexed`` means the replica
    is still unclaimed.
    """
    sort_key: Optional[str]
    cols: dict[str, torch.Tensor]
    mins: Optional[torch.Tensor]           # (n_blocks, n_partitions) int32
    checksums: dict[str, torch.Tensor]     # col -> (n_blocks, n_chunks) int64
    nodes: np.ndarray                      # (n_blocks,) datanode per block
    indexed: Optional[np.ndarray] = None   # (n_blocks,) bool per-block state
    retired: bool = False                  # decommissioned TOMBSTONE: the
    #   slot stays (replica ids are baked into caches, the AccessLog and
    #   recorded plans) but planning, repair, scrubbing and byte accounting
    #   all skip it; its columns are dropped

    def __post_init__(self):
        if self.indexed is None:
            self.indexed = np.full(len(self.nodes),
                                   self.sort_key is not None, dtype=bool)

    def block_indexed(self, block_id: int) -> bool:
        return self.sort_key is not None and bool(self.indexed[block_id])

    @property
    def nbytes(self) -> int:
        return int(sum(v.numel() * v.element_size()
                       for v in self.cols.values()))


@dataclasses.dataclass
class RepairStats:
    """What one ``repair_blocks`` pass did: modeled repair I/O is
    ``bytes_rewritten`` read from the donor and written to the victim."""
    blocks_repaired: int = 0
    unrepairable: int = 0
    bytes_rewritten: int = 0
    wall_s: float = 0.0


@dataclasses.dataclass
class BlockStore:
    schema: Schema
    n_blocks: int
    rows_per_block: int
    partition_size: int
    replicas: list[Replica]
    bad_counts: torch.Tensor               # (n_blocks,) bad records per block
    namenode: Namenode
    layout: str = "pax"
    bad_original: Optional[torch.Tensor] = None  # (n_blocks, rows) upload order
    access_log: Any = None                 # governor.AccessLog (lazy)
    governor: Any = None                   # governor.IndexGovernor when the
    #   store is budget-governed (commit_block_indexes enforces its budget)
    block_cache: Any = None                # cache.BlockCache when a serving
    #   layer caches decoded split inputs — destructive transitions
    #   invalidate the touched replica's entries
    verify_reads: bool = True              # read-path checksum verification
    #   (amortized to BlockCache fills when a cache is attached)
    scrubber: Any = None                   # runtime.scrubber.Scrubber when
    #   background verification is attached (ticks at job/flush boundaries)
    result_cache: Any = None               # cache.ResultCache when a serving
    #   layer caches materialized answers — dropped wholesale by every
    #   destructive transition (and keyed by ``version`` as a backstop)
    replicator: Any = None                 # governor.ReplicationController
    #   when heat-driven dynamic replication is attached
    version: int = 0                       # bumped by every destructive
    #   transition; part of the result-cache key
    bad_mask_cache: dict = dataclasses.field(default_factory=dict)
    # ^ replica -> (n_blocks, rows) bad-row mask in that replica's row order

    def _note_destructive(self):
        """Every state transition that changes what a query would read
        (index commit, demotion, quarantine, repair) funnels through here:
        bump the store version and drop all materialized answers."""
        self.version += 1
        if self.result_cache is not None:
            self.result_cache.invalidate_store()

    @property
    def device(self) -> torch.device:
        return self.bad_counts.device

    @property
    def replication(self) -> int:
        return len(self.replicas)

    def live_replica_ids(self) -> list[int]:
        """Replica slots that are not decommissioned tombstones."""
        return [i for i, r in enumerate(self.replicas) if not r.retired]

    def template_replica(self) -> Replica:
        """A live replica to read schema/dtype metadata from (replica 0
        may be a retired tombstone with its columns dropped)."""
        for r in self.replicas:
            if not r.retired:
                return r
        raise ValueError("store has no live replicas")

    def replica_for(self, key: str) -> Optional[int]:
        """Replica to READ a ``key`` index from: the one with the highest
        ``indexed`` fraction among those keyed on ``key``; ties go to the
        lowest id."""
        best, best_frac = None, -1.0
        for i, r in enumerate(self.replicas):
            if not r.retired and r.sort_key == key:
                frac = float(r.indexed.mean()) if len(r.indexed) else 0.0
                if frac > best_frac:
                    best, best_frac = i, frac
        return best

    def replica_by_key(self, key: str) -> Optional[int]:
        return self.replica_for(key)

    def alive_replica_ids(self, block_id: int) -> list[int]:
        """Replica indices whose datanode for this block is alive AND whose
        copy of the block is not quarantined — the set ``plan()`` may place
        reads on."""
        out = []
        for i, r in enumerate(self.replicas):
            if r.retired:
                continue
            node = int(r.nodes[block_id])
            if (node not in self.namenode.dead
                    and not self.namenode.is_quarantined(block_id, node)):
                out.append(i)
        return out

    # -- corruption: quarantine / verification / repair ---------------------

    def quarantine_block(self, replica_id: int, block_id: int):
        """Record that this replica's copy of a block failed verification.
        The (block, node) pair leaves ``locate``/``alive_replica_ids`` (and
        hence ``plan``) until ``repair_blocks`` restores it; any cached
        gathers touching it are dropped."""
        node = int(self.replicas[replica_id].nodes[block_id])
        self.namenode.quarantine(block_id, node)
        if self.block_cache is not None:
            self.block_cache.invalidate_blocks(replica_id, [block_id])
        self._note_destructive()
        from repro_torch.kernels import ops
        ops.DISPATCH_COUNTS["blocks_quarantined"] += 1
        from repro_torch.obs import trace as obs_trace
        obs_trace.instant("quarantine", track="store",
                          args={"replica": replica_id, "block": block_id,
                                "node": node})

    def is_quarantined(self, replica_id: int, block_id: int) -> bool:
        return self.namenode.is_quarantined(
            block_id, int(self.replicas[replica_id].nodes[block_id]))

    def quarantined_blocks(self, replica_id: int) -> list[int]:
        nodes = self.replicas[replica_id].nodes
        return [b for b in range(self.n_blocks)
                if (b, int(nodes[b])) in self.namenode.quarantined]

    def verify_block(self, replica_id: int, block_id: int) -> bool:
        """Full integrity check of one (replica, block): every column's
        chunk checksums, plus root-directory consistency (mins re-derived
        from the verified key column) when the block is indexed.  Used by
        the scrubber and by repair-source selection."""
        from repro_torch.kernels import ops
        rep = self.replicas[replica_id]
        names = sorted(rep.cols)
        sl = slice(block_id, block_id + 1)
        data = torch.stack([rep.cols[c][sl] for c in names])
        sums = torch.stack([rep.checksums[c][sl] for c in names])
        if not bool(ops.verify_blocks(data, sums).all()):
            return False
        if rep.block_indexed(block_id):
            return bool(ops.verify_root(
                rep.mins[sl], rep.cols[rep.sort_key][sl],
                partition_size=self.partition_size).all())
        return True

    def _healthy_source(self, victim_id: int, block_id: int) -> Optional[int]:
        """A replica that can donate this block: alive, unquarantined, and
        freshly verified (a donor with latent corruption must not launder
        its rot into the repair)."""
        for rid in self.alive_replica_ids(block_id):
            if rid != victim_id and self.verify_block(rid, block_id):
                return rid
        return None

    def repair_blocks(self) -> RepairStats:
        """Rebuild every quarantined block of this store from a healthy
        replica — preserving the victim's clustered index instead of
        byte-copying the donor's (differently sorted) bytes:

        1. donor rows return to upload order by sorting on the logical
           ``__rowid__`` column (``ops.sort_block``: any replica
           reconstructs the logical block);
        2. if the victim block was indexed, re-sort under the VICTIM's own
           ``sort_key`` with bad records to the tail (the stable sort
           reproduces a fresh eager upload's layout bit for bit) and
           rebuild the root-directory row;
        3. splice columns, root and freshly recomputed checksums (copy on
           write), clear the quarantine, and invalidate the bad-mask and
           block caches for just the touched blocks.

        The AccessLog is untouched — repair restores bytes, it is not a
        workload event.  Blocks with no healthy donor stay quarantined and
        are counted ``unrepairable``.
        """
        import time as _time
        from repro_torch.kernels import ops
        assert self.layout == "pax", "repair targets PAX replicas"
        t0 = _time.perf_counter()
        stats = RepairStats()
        by_rep: dict[int, list[int]] = {}
        node_rep = {(b, int(r.nodes[b])): i
                    for i, r in enumerate(self.replicas) if not r.retired
                    for b in range(self.n_blocks)}
        for (b, node) in sorted(self.namenode.quarantined):
            rid = node_rep.get((b, node))
            if rid is not None:
                by_rep.setdefault(rid, []).append(b)
        for rid, blocks in sorted(by_rep.items()):
            rep = self.replicas[rid]
            repaired = []
            for b in blocks:
                src_id = self._healthy_source(rid, b)
                if src_id is None:
                    stats.unrepairable += 1
                    continue
                src = self.replicas[src_id]
                # donor -> upload order via logical row identity
                _, upload_cols, _ = ops.sort_block(
                    src.cols[ROWID][b][None],
                    {c: v[b][None] for c, v in src.cols.items()})
                sel = torch.tensor([b], dtype=torch.int64, device=self.device)
                if rep.block_indexed(b):
                    keys = torch.where(self.bad_original[b][None],
                                       idx.INT32_MAX,
                                       upload_cols[rep.sort_key])
                    _, new_cols, _ = ops.sort_block(keys, upload_cols)
                    root = idx.build_block_roots(new_cols[rep.sort_key],
                                                 self.partition_size)
                else:
                    new_cols = upload_cols
                    root = torch.zeros_like(rep.mins[sel])
                rep.mins = rep.mins.index_copy(0, sel, root)
                for c, v in new_cols.items():
                    rep.cols[c] = rep.cols[c].index_copy(0, sel, v)
                    rep.checksums[c] = rep.checksums[c].index_copy(
                        0, sel, ck.batched_chunk_checksums(v))
                    stats.bytes_rewritten += v.numel() * v.element_size()
                self.namenode.clear_quarantine(b, int(rep.nodes[b]))
                repaired.append(b)
                stats.blocks_repaired += 1
                ops.DISPATCH_COUNTS["blocks_repaired"] += 1
            if repaired:
                self.bad_mask_cache.pop(rid, None)
                if self.block_cache is not None:
                    self.block_cache.invalidate_blocks(rid, repaired)
        if stats.blocks_repaired:
            self._note_destructive()
        stats.wall_s = _time.perf_counter() - t0
        from repro_torch.obs import trace as obs_trace
        obs_trace.complete_wall("repair_blocks", t0, stats.wall_s,
                                track="store",
                                args={"repaired": stats.blocks_repaired,
                                      "unrepairable": stats.unrepairable,
                                      "bytes": stats.bytes_rewritten})
        return stats

    @property
    def nbytes(self) -> int:
        return sum(r.nbytes for r in self.replicas)

    # -- adaptive indexing: the store is state-evolving ---------------------

    def adaptive_replica_for(self, key: str) -> Optional[int]:
        """Replica to (keep) converging toward a ``key`` index: a replica
        already keyed on ``key`` if one exists, else the first unclaimed
        (sort_key None) PAX replica.  None when every replica is claimed by
        some other key."""
        rid = self.replica_by_key(key)
        if rid is not None:
            return rid
        if self.layout != "pax":
            return None
        for i, r in enumerate(self.replicas):
            if not r.retired and r.sort_key is None:
                return i
        return None

    def unindexed_blocks(self, replica_id: int) -> np.ndarray:
        return np.nonzero(~self.replicas[replica_id].indexed)[0]

    def indexed_fraction(self, key: str) -> float:
        """Fraction of blocks index-scannable for ``key`` (convergence)."""
        rid = self.replica_for(key)
        if rid is None:
            return 0.0
        return float(self.replicas[rid].indexed.mean())

    def total_indexed_blocks(self) -> int:
        """Per-block indexes held across ALL replicas — the quantity the
        governor's storage budget bounds."""
        return int(sum(int(r.indexed.sum()) for r in self.replicas
                       if r.sort_key is not None))

    def commit_block_indexes(self, replica_id: int, block_ids,
                             sort_key: str, sorted_cols: dict,
                             new_mins: torch.Tensor,
                             new_checksums: dict) -> int:
        """Commit freshly built per-block clustered indexes (adaptive path).

        Splices the sorted columns, per-block root directories and
        recomputed checksums into the replica — copy on write, so reads
        already dispatched against the old tensors and the replicas that
        share them are unaffected — flips the blocks' ``indexed`` flags,
        advances the namenode's Dir_rep, and invalidates the replica's
        bad-row-mask and block-cache entries (tail layout changed).
        Quarantined blocks are never committed.  When a governor is
        attached, the commit is trimmed to the budget's remaining room (a
        hard backstop — ``run_job`` normally demotes or trims before
        building).  Returns the number of blocks committed.
        """
        rep = self.replicas[replica_id]
        assert rep.sort_key in (None, sort_key), \
            f"replica {replica_id} already keyed on {rep.sort_key!r}"
        bsel = np.asarray(block_ids)
        # never commit a quarantined block: a commit would recompute "valid"
        # checksums over corrupt data, laundering the corruption
        clean = np.array([not self.is_quarantined(replica_id, int(b))
                          for b in bsel], dtype=bool)
        if not clean.all():
            keep = torch.as_tensor(np.nonzero(clean)[0], device=self.device)
            bsel = bsel[clean]
            sorted_cols = {c: v[keep] for c, v in sorted_cols.items()}
            new_mins = new_mins[keep]
            new_checksums = {c: s[keep] for c, s in new_checksums.items()}
        if self.governor is not None:
            fit = self.governor.admit(self, replica_id, len(bsel))
            if fit < len(bsel):
                bsel = bsel[:fit]
                sorted_cols = {c: v[:fit] for c, v in sorted_cols.items()}
                new_mins = new_mins[:fit]
                new_checksums = {c: s[:fit]
                                 for c, s in new_checksums.items()}
        if len(bsel) == 0:
            return 0                     # nothing fits: do not even claim
        rep.sort_key = sort_key
        sel = torch.as_tensor(bsel.astype(np.int64), device=self.device)
        for c, v in sorted_cols.items():
            rep.cols[c] = rep.cols[c].index_copy(0, sel, v)
        rep.mins = idx.merge_block_roots(rep.mins, bsel, new_mins)
        for c, s in new_checksums.items():
            rep.checksums[c] = rep.checksums[c].index_copy(0, sel, s)
        rep.indexed[bsel] = True
        for b in bsel:
            self.namenode.update_index(int(b), int(rep.nodes[b]), sort_key)
        self.bad_mask_cache.pop(replica_id, None)
        if self.block_cache is not None:
            self.block_cache.invalidate_replica(replica_id)
        self._note_destructive()
        from repro_torch.core import governor as gv
        gv.note_commit(self, replica_id, sort_key)
        return len(bsel)

    def demote_replica(self, replica_id: int) -> int:
        """Governor eviction: drop a replica's clustered index entirely.

        The replica's indexed blocks return to upload order by sorting on
        the logical ``__rowid__`` column (one batched ``ops.sort_block``),
        their checksums are recomputed for the restored byte order (copy on
        write), the root directory zeroes, ``sort_key``/``indexed`` rewind
        to unclaimed, the namenode's Dir_rep rewinds per block, and the
        bad-mask and block caches invalidate.  Quarantined blocks are NOT
        un-sorted or re-checksummed — that would launder their corruption —
        and keep their quarantine for ``repair_blocks``.  The replica is
        then re-claimable through ``adaptive_replica_for`` +
        ``commit_block_indexes``.  Returns the per-block indexes dropped.
        """
        assert self.layout == "pax", "only PAX replicas carry indexes"
        rep = self.replicas[replica_id]
        assert rep.sort_key is not None, \
            f"replica {replica_id} is already unindexed"
        old_key = rep.sort_key
        bsel = np.nonzero(rep.indexed)[0]
        dropped = len(bsel)
        qset = {int(b) for b in self.quarantined_blocks(replica_id)}
        if qset:
            bsel = np.array([b for b in bsel if int(b) not in qset],
                            dtype=np.int64)
        if len(bsel):
            from repro_torch.kernels import ops
            sel = torch.as_tensor(bsel.astype(np.int64), device=self.device)
            _, unsorted, _ = ops.sort_block(
                rep.cols[ROWID][sel],
                {c: v[sel] for c, v in rep.cols.items()})
            rep.cols = {c: v.index_copy(0, sel, unsorted[c])
                        for c, v in rep.cols.items()}
            rep.checksums = {
                c: s.index_copy(0, sel,
                                ck.batched_chunk_checksums(unsorted[c]))
                for c, s in rep.checksums.items()}
        rep.mins = torch.zeros(
            (self.n_blocks, self.rows_per_block // self.partition_size),
            dtype=torch.int32, device=self.device)
        rep.sort_key = None
        rep.indexed = np.zeros(self.n_blocks, dtype=bool)
        for b in range(self.n_blocks):
            self.namenode.update_index(b, int(rep.nodes[b]), None)
        self.bad_mask_cache.pop(replica_id, None)
        if self.block_cache is not None:
            self.block_cache.invalidate_replica(replica_id)
        self._note_destructive()
        if self.access_log is not None:
            self.access_log.forget_replica(replica_id)
        if self.governor is not None:
            self.governor.note_demotion(replica_id, old_key, dropped)
        return dropped

    # -- dynamic replication: replica COUNT follows measured heat -----------

    def add_replica(self, n_nodes: Optional[int] = None) -> int:
        """Scale-UP arm of dynamic replication: clone the dataset into a
        fresh, UNCLAIMED replica in upload order — claimable by the next
        adaptive job for whatever column is hot (every replica carries its
        own clustered index, so a replica is an index slot).

        Per block, the first healthy (alive, unquarantined) replica
        donates; donor rows return to upload order through ONE batched
        ``ops.sort_block`` on ``__rowid__`` per donor replica, and
        checksums are recomputed.  Block b lands on ``(b + slot) %
        n_nodes`` for the lowest node offset ``slot`` no live replica
        occupies (replicas of a block stay on distinct nodes).  Appending
        is non-destructive: the store version is untouched.  Returns the
        new replica id.
        """
        from repro_torch.kernels import ops
        assert self.layout == "pax", "dynamic replication targets PAX stores"
        live = self.live_replica_ids()
        if n_nodes is None:
            n_nodes = max(int(self.replicas[i].nodes.max())
                          for i in live) + 1
        taken = {int(self.replicas[i].nodes[0]) % n_nodes for i in live}
        free = [s for s in range(n_nodes) if s not in taken]
        if not free:
            raise ValueError(
                f"cannot add replica: all {n_nodes} node offsets hold a "
                f"live replica (replication would exceed cluster size)")
        slot = free[0]
        donor = np.empty(self.n_blocks, dtype=np.int64)
        for b in range(self.n_blocks):
            alive = self.alive_replica_ids(b)
            if not alive:
                raise ValueError(
                    f"cannot add replica: block {b} has no healthy copy "
                    f"to clone from")
            donor[b] = alive[0]
        tmpl = self.template_replica()
        rows = self.rows_per_block
        # fresh tensors nobody else holds yet: filled in place
        new_cols = {c: torch.zeros((self.n_blocks, rows), dtype=v.dtype,
                                   device=self.device)
                    for c, v in tmpl.cols.items()}
        for rid in np.unique(donor):
            bsel = np.nonzero(donor == rid)[0]
            sel = torch.as_tensor(bsel, device=self.device)
            src = self.replicas[int(rid)]
            _, up, _ = ops.sort_block(
                src.cols[ROWID][sel],
                {c: v[sel] for c, v in src.cols.items()})
            for c in new_cols:
                new_cols[c].index_copy_(0, sel, up[c])
        new_sums = {c: ck.batched_chunk_checksums(v)
                    for c, v in new_cols.items()}
        nodes = np.array([(b % n_nodes + slot) % n_nodes
                          for b in range(self.n_blocks)], dtype=np.int64)
        rep = Replica(sort_key=None, cols=new_cols,
                      mins=torch.zeros(
                          (self.n_blocks, rows // self.partition_size),
                          dtype=torch.int32, device=self.device),
                      checksums=new_sums, nodes=nodes)
        self.replicas.append(rep)
        rid = len(self.replicas) - 1
        per_block_bytes = rep.nbytes // self.n_blocks
        for b in range(self.n_blocks):
            self.namenode.register(ReplicaInfo(
                block_id=b, node=int(nodes[b]), sort_key=None,
                partition_size=self.partition_size, n_rows=rows,
                layout="pax", nbytes=per_block_bytes))
        ops.DISPATCH_COUNTS["replicas_added"] += 1
        from repro_torch.obs import trace as obs_trace
        obs_trace.instant("add_replica", track="store",
                          args={"replica": rid, "node_offset": slot})
        return rid

    def decommission_replica(self, replica_id: int) -> int:
        """Scale-DOWN arm of dynamic replication: retire a cold replica —
        destructive like a demotion, but terminal.

        The replica becomes a tombstone: its slot stays (replica ids are
        baked into caches, the AccessLog and recorded plans) but
        ``retired`` drops it from planning, repair, scrubbing and byte
        accounting, its columns and checksums are freed, and the namenode
        unregisters every (block, node) pair, quarantined ones included.
        Bumps ``version`` and invalidates both cache tiers.  Refuses
        (``ValueError``) when any block would lose its last healthy copy.
        Returns the number of per-block indexes dropped.
        """
        assert self.layout == "pax", "dynamic replication targets PAX stores"
        rep = self.replicas[replica_id]
        if rep.retired:
            raise ValueError(f"replica {replica_id} is already retired")
        for b in range(self.n_blocks):
            others = [i for i in self.alive_replica_ids(b)
                      if i != replica_id]
            if not others:
                raise ValueError(
                    f"cannot decommission replica {replica_id}: block {b} "
                    f"would lose its last healthy copy")
        dropped = (int(rep.indexed.sum())
                   if rep.sort_key is not None else 0)
        for b in range(self.n_blocks):
            self.namenode.unregister(b, int(rep.nodes[b]))
        rep.retired = True
        rep.sort_key = None
        rep.indexed = np.zeros(self.n_blocks, dtype=bool)
        rep.cols = {}
        rep.checksums = {}
        rep.mins = None
        self.bad_mask_cache.pop(replica_id, None)
        if self.block_cache is not None:
            self.block_cache.invalidate_replica(replica_id)
        self._note_destructive()
        if self.access_log is not None:
            self.access_log.forget_replica(replica_id)
        from repro_torch.kernels import ops
        ops.DISPATCH_COUNTS["replicas_decommissioned"] += 1
        from repro_torch.obs import trace as obs_trace
        obs_trace.instant("decommission_replica", track="store",
                          args={"replica": replica_id,
                                "indexes_dropped": dropped})
        return dropped


def assign_nodes(n_blocks: int, replication: int, n_nodes: int) -> np.ndarray:
    """(replication, n_blocks) datanode placement: replicas of a block land
    on distinct nodes (HDFS invariant), blocks round-robin."""
    if replication > n_nodes:
        raise ValueError(
            f"replication={replication} exceeds cluster size "
            f"n_nodes={n_nodes}: replicas of a block must land on "
            f"distinct nodes")
    out = np.zeros((replication, n_blocks), dtype=np.int64)
    for b in range(n_blocks):
        base = b % n_nodes
        for r in range(replication):
            out[r, b] = (base + r) % n_nodes
    return out


# ---------------------------------------------------------------------------
# state carried across packages: plain numpy dicts
# ---------------------------------------------------------------------------


def store_to_numpy(store: BlockStore) -> dict:
    """The store's state as a plain dict of numpy arrays and scalars (the
    layout ``store_from_numpy`` reads): copies, one per shared tensor, so
    replicas that share a tensor share the array.  Checksums come out as
    uint32."""
    seen: dict[int, np.ndarray] = {}

    def arr(t):
        if t is None:
            return None
        if id(t) not in seen:
            seen[id(t)] = t.cpu().numpy().copy()
        return seen[id(t)]

    return {
        "schema": store.schema.name,
        "n_blocks": store.n_blocks,
        "rows_per_block": store.rows_per_block,
        "partition_size": store.partition_size,
        "layout": store.layout,
        "bad_counts": arr(store.bad_counts),
        "bad_original": arr(store.bad_original),
        "replicas": [{
            "sort_key": r.sort_key,
            "cols": {c: arr(v) for c, v in r.cols.items()},
            "mins": arr(r.mins),
            "checksums": {c: arr(v).astype(np.uint32)
                          for c, v in r.checksums.items()},
            "nodes": np.asarray(r.nodes).copy(),
            "indexed": np.asarray(r.indexed).copy(),
            "retired": r.retired,
        } for r in store.replicas],
        "namenode": [dataclasses.astuple(info)
                     for info in store.namenode.dir_rep.values()],
        "quarantined": sorted(store.namenode.quarantined),
        "version": store.version,
    }


def store_from_numpy(state: dict, device=None) -> BlockStore:
    """Build a ``BlockStore`` on ``device`` (None = the card) from the plain
    dict ``store_to_numpy`` writes: per replica ``sort_key``, ``cols``,
    ``mins``, ``checksums`` (uint32 or int64 values), ``nodes``,
    ``indexed`` and ``retired``; beside them ``bad_counts``,
    ``bad_original``, ``n_blocks``, ``rows_per_block``, ``partition_size``,
    ``layout``, the ``schema`` name, the ``namenode`` registrations as
    ``ReplicaInfo`` field tuples in registration order, the namenode's
    ``quarantined`` (block, node) pairs and the store ``version`` (the
    last three default to a fresh store's: live, none, 0)."""
    dev = default_device(device)

    def tensor(a, dtype=None):      # a copy: the caller keeps its arrays
        return None if a is None else torch.tensor(a, dtype=dtype, device=dev)

    # replicas that share a numpy array share the tensor, as a lazy upload's
    # replicas share their columns
    shared: dict[int, torch.Tensor] = {}

    def col(a):
        if id(a) not in shared:
            shared[id(a)] = tensor(a)
        return shared[id(a)]

    replicas = [Replica(
        sort_key=r["sort_key"],
        cols={c: col(v) for c, v in r["cols"].items()},
        mins=tensor(r["mins"]),
        checksums={c: tensor(np.asarray(v).astype(np.int64))
                   for c, v in r["checksums"].items()},
        nodes=np.asarray(r["nodes"], np.int64).copy(),
        indexed=np.asarray(r["indexed"], bool).copy(),
        retired=bool(r.get("retired", False)))
        for r in state["replicas"]]
    namenode = Namenode()
    for fields in state["namenode"]:
        namenode.register(ReplicaInfo(*fields))
    namenode.quarantined = {(int(b), int(n))
                            for b, n in state.get("quarantined", ())}
    return BlockStore(
        schema=SCHEMAS[state["schema"]], n_blocks=int(state["n_blocks"]),
        rows_per_block=int(state["rows_per_block"]),
        partition_size=int(state["partition_size"]), replicas=replicas,
        bad_counts=tensor(state["bad_counts"], torch.int32),
        namenode=namenode, layout=state["layout"],
        bad_original=tensor(state["bad_original"], torch.bool),
        version=int(state.get("version", 0)))
