"""Upload pipelines: HAIL vs HDFS(Hadoop) vs Hadoop++ (paper §3, §6.3).

HAIL (one pass, everything piggy-backed):
  parse ASCII -> binary PAX once on the client, then per replica r:
  sort by key_r (bad records to the tail) -> gather all columns ->
  build sparse root index -> recompute per-replica checksums.
  No re-read of the data: the sort/index ride the upload pipeline.

Hadoop (HDFS): store the raw ASCII block R times + chunk checksums.  No
parse, no index — query time pays the full parse+scan.

Hadoop++: Hadoop upload first, THEN an extra MapReduce job re-reads every
replica, parses, sorts by ONE global key and rewrites + re-checksums.

The JAX package runs each pipeline over all blocks at once.  Here the same
per-block program runs over CHUNKS of blocks: parsing widens the ASCII
bytes to int32 (4x), and a 64-block upload of 2^19-row blocks would
otherwise need a ~12 GB temporary.  The results are identical, block for
block.  Upload walls end with a device synchronise, so they time the work,
not its enqueueing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import checksum as ck
from repro_torch.core import index as idx
from repro_torch.core import parse as ps
from repro_torch.core.schema import ROWID, Schema
from repro_torch.core.store import (BlockStore, Namenode, Replica,
                                    ReplicaInfo, assign_nodes, default_device)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

CHUNK_BYTES = 1 << 28   # ASCII bytes per pipeline chunk (int32 parse: 4x)


def _note_upload(kind: str, t0: float, stats: UploadStats):
    """Fold one finished upload into the flight recorder: an X slice per
    measured phase on the upload track plus the registry counters."""
    start = t0
    for phase, wall in stats.phases.items():
        obs_trace.complete_wall(f"upload:{phase}", start, wall,
                                track="upload",
                                args={"kind": kind,
                                      "ascii_bytes": stats.ascii_bytes,
                                      "written_bytes": stats.written_bytes})
        start += wall
    obs_metrics.observe_upload(kind, stats)


@dataclasses.dataclass
class UploadStats:
    wall_s: float                 # measured compute; == sum(phases.values())
    ascii_bytes: int              # bytes received by the client
    written_bytes: int            # bytes written across all replicas
    extra_read_bytes: int = 0     # Hadoop++ post-hoc job re-reads (modeled
    #   I/O — charged ONCE, by the disk model, never also as compute wall)
    n_indexes: int = 0
    phases: dict = dataclasses.field(default_factory=dict)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chunks(raw_blocks: np.ndarray):
    """(start, stop) block ranges of at most CHUNK_BYTES of ASCII each."""
    n_blocks = raw_blocks.shape[0]
    per_block = max(1, raw_blocks[0].size if n_blocks else 1)
    step = max(1, CHUNK_BYTES // per_block)
    return [(s, min(s + step, n_blocks)) for s in range(0, n_blocks, step)]


def _parse_chunk(schema: Schema, raw: torch.Tensor, start: int):
    """Parse blocks [start, start + len(raw)) and add the rowid column."""
    cols, bad = ps.parse_block(schema, raw)
    n, rows = bad.shape
    block_ids = torch.arange(start, start + n, dtype=torch.int32,
                             device=raw.device)
    cols[ROWID] = (block_ids[:, None] * rows
                   + torch.arange(rows, dtype=torch.int32,
                                  device=raw.device)[None, :])
    return cols, bad


def _checksums(cols: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Per-block chunk checksums of every column, sorted by column name."""
    return {k: ck.batched_chunk_checksums(v) for k, v in sorted(cols.items())}


def _cat(parts: list[dict]) -> dict[str, torch.Tensor]:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


# ---------------------------------------------------------------------------
# HAIL
# ---------------------------------------------------------------------------


def _hail_chunk(schema: Schema, raw: torch.Tensor, start: int,
                sort_keys: tuple, partition_size: int):
    """The per-block pipeline for blocks [start, start + len(raw))."""
    cols, bad = _parse_chunk(schema, raw, start)
    n, rows = bad.shape
    replicas = []
    for key in sort_keys:
        if key is None:
            sorted_cols = dict(cols)
            mins = torch.zeros((n, rows // partition_size), dtype=torch.int32,
                               device=raw.device)
        else:
            perm = idx.sort_permutation(cols[key], bad)
            sorted_cols = {k: torch.gather(v, 1, perm)
                           for k, v in cols.items()}
            mins = idx.build_block_roots(sorted_cols[key], partition_size)
        replicas.append((sorted_cols, mins, _checksums(sorted_cols)))
    return replicas, bad


def hail_upload(schema: Schema, raw_blocks: np.ndarray,
                sort_keys: Optional[Sequence[Optional[str]]] = None,
                partition_size: int = idx.PARTITION,
                n_nodes: int = 10, *,
                index_columns: Optional[Sequence[str]] = None,
                replication: Optional[int] = None,
                device=None) -> tuple[BlockStore, UploadStats]:
    """raw_blocks (n_blocks, rows, row_width) uint8 (host numpy).

    ``sort_keys`` (alias ``index_columns``): one entry per replica; ``None``
    entries ship that replica unindexed.  The EMPTY sequence
    (``index_columns=()``) is the LAZY fast path (``hail_lazy_upload``).
    With non-empty keys the replica count IS ``len(sort_keys)``; a
    conflicting ``replication`` is rejected rather than silently ignored.
    ``device`` None means the card.
    """
    if index_columns is not None:
        sort_keys = index_columns
    assert sort_keys is not None, "pass sort_keys or index_columns"
    sort_keys = tuple(sort_keys)
    if len(sort_keys) == 0:
        return hail_lazy_upload(schema, raw_blocks,
                                3 if replication is None else replication,
                                partition_size, n_nodes, device=device)
    if replication is not None and replication != len(sort_keys):
        raise ValueError(
            f"replication={replication} conflicts with {len(sort_keys)} "
            f"sort_keys — replica count is len(sort_keys) on the eager path")
    dev = default_device(device)
    n_blocks, rows, width = raw_blocks.shape
    t0 = time.perf_counter()
    per_rep = [[] for _ in sort_keys]
    bads = []
    for s, e in _chunks(raw_blocks):
        raw = torch.from_numpy(raw_blocks[s:e]).to(dev)
        reps, bad = _hail_chunk(schema, raw, s, sort_keys, partition_size)
        for r, rep in enumerate(reps):
            per_rep[r].append(rep)
        bads.append(bad)
    reps = [(_cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
             _cat([p[2] for p in parts])) for parts in per_rep]
    bad = torch.cat(bads)
    _sync(dev)
    wall = time.perf_counter() - t0
    bad_counts = bad.sum(dim=1).to(torch.int32)

    nodes = assign_nodes(n_blocks, len(sort_keys), n_nodes)
    namenode = Namenode()
    replicas = []
    written = 0
    for r, (cols, mins, sums) in enumerate(reps):
        rep = Replica(sort_key=sort_keys[r], cols=cols, mins=mins,
                      checksums=sums, nodes=nodes[r])
        replicas.append(rep)
        written += rep.nbytes
        per_block_bytes = rep.nbytes // n_blocks
        for b in range(n_blocks):
            namenode.register(ReplicaInfo(
                block_id=b, node=int(nodes[r, b]), sort_key=sort_keys[r],
                partition_size=partition_size, n_rows=rows, layout="pax",
                nbytes=per_block_bytes))
    store = BlockStore(schema=schema, n_blocks=n_blocks, rows_per_block=rows,
                       partition_size=partition_size, replicas=replicas,
                       bad_counts=bad_counts, namenode=namenode, layout="pax",
                       bad_original=bad)
    stats = UploadStats(wall_s=wall, ascii_bytes=raw_blocks.size,
                        written_bytes=written,
                        n_indexes=sum(k is not None for k in sort_keys),
                        phases={"hail": wall})
    _note_upload("hail", t0, stats)
    return store, stats


def hail_lazy_upload(schema: Schema, raw_blocks: np.ndarray,
                     replication: int = 3,
                     partition_size: int = idx.PARTITION,
                     n_nodes: int = 10, *,
                     device=None) -> tuple[BlockStore, UploadStats]:
    """Adaptive-HAIL upload (LIAH): ship PAX blocks UNINDEXED.

    One parse + one checksum pass serve all replicas (identical bytes until
    a replica is adaptively sorted), so upload pays neither the per-replica
    sort nor the index build.  Replicas start unclaimed (``sort_key=None``,
    ``indexed`` all-False) with zeroed root directories sized for
    ``partition_size``.  ``device`` None means the card.
    """
    dev = default_device(device)
    n_blocks, rows, width = raw_blocks.shape
    t0 = time.perf_counter()
    col_parts, sum_parts, bads = [], [], []
    for s, e in _chunks(raw_blocks):
        raw = torch.from_numpy(raw_blocks[s:e]).to(dev)
        cols, bad = _parse_chunk(schema, raw, s)
        col_parts.append(cols)
        sum_parts.append(_checksums(cols))
        bads.append(bad)
    cols, sums, bad = _cat(col_parts), _cat(sum_parts), torch.cat(bads)
    _sync(dev)
    wall = time.perf_counter() - t0
    bad_counts = bad.sum(dim=1).to(torch.int32)

    nodes = assign_nodes(n_blocks, replication, n_nodes)
    namenode = Namenode()
    replicas = []
    written = 0
    zero_mins = torch.zeros((n_blocks, rows // partition_size),
                            dtype=torch.int32, device=dev)
    for r in range(replication):
        # per-replica dicts (commit rebinds entries per replica); the column
        # tensors are shared until a copy-on-write commit diverges them
        rep = Replica(sort_key=None, cols=dict(cols), mins=zero_mins,
                      checksums=dict(sums), nodes=nodes[r])
        replicas.append(rep)
        written += rep.nbytes
        per_block_bytes = rep.nbytes // n_blocks
        for b in range(n_blocks):
            namenode.register(ReplicaInfo(
                block_id=b, node=int(nodes[r, b]), sort_key=None,
                partition_size=partition_size, n_rows=rows, layout="pax",
                nbytes=per_block_bytes))
    store = BlockStore(schema=schema, n_blocks=n_blocks, rows_per_block=rows,
                       partition_size=partition_size, replicas=replicas,
                       bad_counts=bad_counts, namenode=namenode, layout="pax",
                       bad_original=bad)
    stats = UploadStats(wall_s=wall, ascii_bytes=raw_blocks.size,
                        written_bytes=written, n_indexes=0,
                        phases={"hail_lazy": wall})
    _note_upload("hail_lazy", t0, stats)
    return store, stats


# ---------------------------------------------------------------------------
# Hadoop (plain HDFS)
# ---------------------------------------------------------------------------


def hdfs_upload(schema: Schema, raw_blocks: np.ndarray, replication: int = 3,
                n_nodes: int = 10, *,
                device=None) -> tuple[BlockStore, UploadStats]:
    """Raw ASCII replicated R times; checksums only (what HDFS computes).
    ``device`` None means the card."""
    dev = default_device(device)
    n_blocks, rows, width = raw_blocks.shape
    t0 = time.perf_counter()
    raw = torch.from_numpy(raw_blocks).to(dev, copy=True)
    sums = torch.cat([ck.batched_chunk_checksums(raw[s:e])
                      for s, e in _chunks(raw_blocks)])
    _sync(dev)
    wall = time.perf_counter() - t0

    nodes = assign_nodes(n_blocks, replication, n_nodes)
    namenode = Namenode()
    replicas = []
    for r in range(replication):
        rep = Replica(sort_key=None, cols={"__raw__": raw}, mins=None,
                      checksums={"__raw__": sums}, nodes=nodes[r])
        replicas.append(rep)
        for b in range(n_blocks):
            namenode.register(ReplicaInfo(
                block_id=b, node=int(nodes[r, b]), sort_key=None,
                partition_size=0, n_rows=rows, layout="row_ascii",
                nbytes=rows * width))
    store = BlockStore(schema=schema, n_blocks=n_blocks, rows_per_block=rows,
                       partition_size=0, replicas=replicas,
                       bad_counts=torch.zeros((n_blocks,), dtype=torch.int32,
                                              device=dev),
                       namenode=namenode, layout="row_ascii")
    stats = UploadStats(wall_s=wall, ascii_bytes=raw_blocks.size,
                        written_bytes=raw_blocks.size * replication,
                        phases={"hdfs": wall})
    _note_upload("hdfs", t0, stats)
    return store, stats


# ---------------------------------------------------------------------------
# Hadoop++ (trojan index: post-hoc MapReduce job, one global sort key)
# ---------------------------------------------------------------------------


def hadooppp_upload(schema: Schema, raw_blocks: np.ndarray, sort_key: str,
                    replication: int = 3, partition_size: int = idx.PARTITION,
                    n_nodes: int = 10, *,
                    device=None) -> tuple[BlockStore, UploadStats]:
    # phase 1: plain HDFS upload (pays checksum pass over raw bytes)
    _, s1 = hdfs_upload(schema, raw_blocks, replication, n_nodes,
                        device=device)
    # phase 2: the trojan-index MapReduce job re-reads every replica, parses,
    # sorts by the ONE key, rewrites every replica.  The REWRITE compute is
    # measured; the RE-READ is disk I/O charged once, as extra_read_bytes.
    keys = tuple([sort_key] * replication)
    store, s2 = hail_upload(schema, raw_blocks, keys, partition_size, n_nodes,
                            device=device)
    phases = {"hdfs": s1.wall_s, "trojan_rewrite": s2.wall_s}
    stats = UploadStats(
        wall_s=sum(phases.values()),
        ascii_bytes=s1.ascii_bytes,
        written_bytes=s1.written_bytes + s2.written_bytes,
        extra_read_bytes=s1.written_bytes,  # job re-reads each replica
        n_indexes=1,
        phases=phases)
    obs_metrics.observe_upload("hadooppp", stats)
    return store, stats
