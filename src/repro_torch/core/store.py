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
all advance together, and the bad-row mask cache is invalidated.

Aliasing: the replicas of a lazy upload share their column tensors, and a
reader's gathered inputs may still be in flight on the device when a commit
lands.  JAX updates are functional, so sharing costs nothing there; in
PyTorch ``t[b] = v`` writes in place and would silently rewrite every
replica and every pending read that shares ``t``.  So every store
transition here COPIES ON WRITE (``index_copy`` out of place) and rebinds
the replica's entry; no tensor the store hands out is ever written again.

``store_from_numpy`` builds a store from a plain dict of numpy arrays (the
layout ``store_to_numpy`` writes), so both packages can start from identical
state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import index as idx
from repro_torch.core.schema import SCHEMAS, Schema


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
        # BLOCK granularity
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

    def is_quarantined(self, block_id: int, node: int) -> bool:
        return (block_id, node) in self.quarantined

    def replicas(self, block_id: int) -> list[ReplicaInfo]:
        return [self.dir_rep[(block_id, n)] for n in self.locate(block_id)]

    def get_hosts_with_index(self, block_id: int, key: str) -> list[int]:
        """The paper's new BlockLocation.getHostsWithIndex()."""
        return [r.node for r in self.replicas(block_id) if r.sort_key == key]

    def update_index(self, block_id: int, node: int,
                     sort_key: Optional[str]):
        """Adaptive-index commit: a running job built a clustered index for
        this replica; advance Dir_rep so later planning sees it."""
        info = self.dir_rep[(block_id, node)]
        self.dir_rep[(block_id, node)] = dataclasses.replace(
            info, sort_key=sort_key)

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
    verify_reads: bool = True              # read-path checksum verification
    version: int = 0                       # bumped by every destructive
    #   transition
    bad_mask_cache: dict = dataclasses.field(default_factory=dict)
    # ^ replica -> (n_blocks, rows) bad-row mask in that replica's row order

    def _note_destructive(self):
        """Every state transition that changes what a query would read
        (index commit, quarantine) bumps the store version."""
        self.version += 1

    @property
    def device(self) -> torch.device:
        return self.bad_counts.device

    @property
    def replication(self) -> int:
        return len(self.replicas)

    def template_replica(self) -> Replica:
        """A replica to read schema/dtype metadata from."""
        return self.replicas[0]

    def replica_for(self, key: str) -> Optional[int]:
        """Replica to READ a ``key`` index from: the one with the highest
        ``indexed`` fraction among those keyed on ``key``; ties go to the
        lowest id."""
        best, best_frac = None, -1.0
        for i, r in enumerate(self.replicas):
            if r.sort_key == key:
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
            node = int(r.nodes[block_id])
            if (node not in self.namenode.dead
                    and not self.namenode.is_quarantined(block_id, node)):
                out.append(i)
        return out

    # -- corruption: quarantine ---------------------------------------------

    def quarantine_block(self, replica_id: int, block_id: int):
        """Record that this replica's copy of a block failed verification.
        The (block, node) pair leaves ``locate``/``alive_replica_ids`` (and
        hence ``plan``)."""
        node = int(self.replicas[replica_id].nodes[block_id])
        self.namenode.quarantine(block_id, node)
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
            if r.sort_key is None:
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
        """Per-block indexes held across ALL replicas."""
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
        bad-row-mask cache (tail layout changed).  Quarantined blocks are
        never committed.  Returns the number of blocks committed.
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
        if len(bsel) == 0:
            return 0                     # nothing to commit: do not claim
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
        self._note_destructive()
        from repro_torch.core import governor as gv
        gv.note_commit(self, replica_id, sort_key)
        return len(bsel)


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
        } for r in store.replicas],
        "namenode": [dataclasses.astuple(info)
                     for info in store.namenode.dir_rep.values()],
    }


def store_from_numpy(state: dict, device=None) -> BlockStore:
    """Build a ``BlockStore`` on ``device`` (None = the card) from the plain
    dict ``store_to_numpy`` writes: per replica ``sort_key``, ``cols``,
    ``mins``, ``checksums`` (uint32 or int64 values), ``nodes`` and
    ``indexed``; beside them ``bad_counts``, ``bad_original``,
    ``n_blocks``, ``rows_per_block``, ``partition_size``, ``layout``, the
    ``schema`` name and the ``namenode`` registrations as
    ``ReplicaInfo`` field tuples, in registration order."""
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
        indexed=np.asarray(r["indexed"], bool).copy())
        for r in state["replicas"]]
    namenode = Namenode()
    for fields in state["namenode"]:
        namenode.register(ReplicaInfo(*fields))
    return BlockStore(
        schema=SCHEMAS[state["schema"]], n_blocks=int(state["n_blocks"]),
        rows_per_block=int(state["rows_per_block"]),
        partition_size=int(state["partition_size"]), replicas=replicas,
        bad_counts=tensor(state["bad_counts"], torch.int32),
        namenode=namenode, layout=state["layout"],
        bad_original=tensor(state["bad_original"], torch.bool))
