"""HAIL query pipeline (paper §4): annotations, replica planning, record
readers (index scan vs full scan), PAX->row reconstruction.

Replica selection mirrors §4.3: for each block, prefer an *alive* replica
whose clustered index matches the filter attribute; otherwise fall back to
any alive replica with a full scan (failover path — Fig 8's experiment).

Record readers are *batched over many blocks per call* — that batching is
exactly what HailSplitting enables (ONE launch per split instead of one per
block):

* ``read_hail_kernels`` makes exactly one fused ``hail_read`` launch per
  split regardless of block count, including MIXED-replica and failover
  splits (per-block ``use_index`` flags select pruned index scan vs full
  scan inside the kernel), with the query range as a device tensor;
* ``read_hail_batch`` extends that to a QUERY dimension: one launch serves
  a whole batch of compatible concurrent queries (same filter column, same
  projection) with per-query match masks;
* ``read_hail`` is the plain tensor reader the kernel reader is held
  against, and ``read_hadoop`` the parse-and-scan baseline over raw ASCII.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import governor as gov
from repro_torch.core import index as idx
from repro_torch.core import parse as ps
from repro_torch.core.fault import CorruptBlockError, UnrecoverableDataError
from repro_torch.core.schema import ROWID, Schema
from repro_torch.core.store import BlockStore
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class HailQuery:
    """filter: (column, lo, hi) inclusive range (point = lo==hi)."""
    filter: Optional[tuple[str, int, int]]
    projection: tuple[str, ...]

    @property
    def filter_col(self) -> Optional[str]:
        return self.filter[0] if self.filter else None


def hail_annotation(schema: Schema, filter: str = "", projection: str = ""):
    """Parse the paper's @HailQuery annotation syntax:

      @HailQuery(filter="@3 between(7305,7670)", projection={@1})
      filter forms: "@k between(a,b)" | "@k = v"   (@k is 1-based position)
    """
    flt = None
    if filter:
        m = re.match(r"@(\d+)\s+between\((-?\d+),\s*(-?\d+)\)", filter.strip())
        if m:
            col = schema.columns[int(m.group(1)) - 1].name
            flt = (col, int(m.group(2)), int(m.group(3)))
        else:
            m = re.match(r"@(\d+)\s*=\s*(-?\d+)", filter.strip())
            if not m:
                raise ValueError(f"bad filter annotation: {filter!r}")
            col = schema.columns[int(m.group(1)) - 1].name
            v = int(m.group(2))
            flt = (col, v, v)
    proj = tuple(schema.columns[int(p) - 1].name
                 for p in re.findall(r"@(\d+)", projection))
    return HailQuery(filter=flt, projection=proj or schema.names)


def hail_query(filter: str = "", projection: str = "", schema: Schema = None):
    """Decorator flavour: @hail_query(filter=..., projection=...) on a map fn."""
    def deco(fn):
        fn.__hail_query__ = hail_annotation(schema, filter, projection)
        return fn
    return deco


# ---------------------------------------------------------------------------
# Planning (the JobClient/JobTracker side)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryPlan:
    replica_for_block: np.ndarray    # (n_blocks,) replica idx used for reading
    index_scan: np.ndarray           # (n_blocks,) bool: index scan possible
    nodes: np.ndarray                # (n_blocks,) datanode serving the read


def plan(store: BlockStore, query: HailQuery) -> QueryPlan:
    """Replica selection against the store's LIVE per-block index state.

    A replica qualifies a block for index scan only if its clustered index
    both matches the filter attribute AND has actually been built for that
    block (``Replica.block_indexed``).
    """
    nb = store.n_blocks
    rep = np.zeros(nb, dtype=np.int64)
    is_idx = np.zeros(nb, dtype=bool)
    nodes = np.zeros(nb, dtype=np.int64)
    want = query.filter_col
    for b in range(nb):
        alive = store.alive_replica_ids(b)
        if not alive:
            raise UnrecoverableDataError(
                f"block {b}: all replicas lost or quarantined")
        choice = None
        if want is not None and store.layout == "pax":
            for i in alive:
                if (store.replicas[i].sort_key == want
                        and store.replicas[i].block_indexed(b)):
                    choice = i
                    is_idx[b] = True
                    break
        if choice is None:
            choice = alive[0]
        rep[b] = choice
        nodes[b] = int(store.replicas[choice].nodes[b])
    return QueryPlan(replica_for_block=rep, index_scan=is_idx, nodes=nodes)


# ---------------------------------------------------------------------------
# Record readers (batched over blocks)
# ---------------------------------------------------------------------------


def _index_read(sorted_key, mins, bad, lo, hi, *, partition_size: int):
    mask = idx.index_scan_mask(sorted_key, mins, lo, hi,
                               partition_size) & ~bad
    frac = idx.rows_read_fraction(mins, lo, hi, partition_size,
                                  sorted_key.shape[1])
    return mask, frac


def _full_read(key_col, bad, lo, hi):
    return idx.full_scan_mask(key_col, lo, hi) & ~bad


@dataclasses.dataclass
class ReadResult:
    """Fixed-shape result: projected columns + qualifying mask."""
    cols: dict[str, torch.Tensor]  # col -> (n_blocks, rows)
    mask: torch.Tensor             # (n_blocks, rows) bool
    rows_read_frac: torch.Tensor   # (n_blocks,) I/O model input
    bytes_read: "int | torch.Tensor"  # modeled bytes (index scan reads less);
    # may be a LAZY 0-d tensor so building a ReadResult never forces a
    # device sync — run_job materializes it at the completion barrier


def _sel(ids: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


def _bad_mask(store: BlockStore, replica: int) -> torch.Tensor:
    """Bad rows sit at the tail of INDEXED blocks (sorted there); for a
    block that is still unindexed they stay at their original upload
    positions — under adaptive indexing one replica mixes both, per block.
    Cached per replica; ``commit_block_indexes`` invalidates the entry."""
    cache = store.bad_mask_cache
    if replica in cache:
        return cache[replica]
    rep = store.replicas[replica]
    orig = (store.bad_original if store.bad_original is not None
            else torch.zeros((store.n_blocks, store.rows_per_block),
                             dtype=torch.bool, device=store.device))
    if rep.sort_key is None:
        m = orig
    else:
        r = torch.arange(store.rows_per_block, dtype=torch.int32,
                         device=store.device)[None, :]
        tail = r >= (store.rows_per_block - store.bad_counts[:, None])
        if rep.indexed.all():
            m = tail
        else:
            flags = torch.as_tensor(rep.indexed, device=store.device)
            m = torch.where(flags[:, None], tail, orig)
    cache[replica] = m
    return m


def _verify_replica_blocks(store: BlockStore, rid: int, bsel, names):
    """Read-path integrity gate for one replica's blocks (§3.2: HDFS always
    verifies chunk checksums on read; HAIL keeps that working with
    per-replica checksums).  Verifies exactly the columns this read will
    touch in ONE batched call, plus root-directory consistency for indexed
    blocks when the read uses the index.  Raises ``CorruptBlockError``
    carrying the first failing (replica, block, col)."""
    if not store.verify_reads or store.layout != "pax":
        return
    from repro_torch.kernels import ops
    rep = store.replicas[rid]
    names = tuple(dict.fromkeys(names))
    bsel = np.asarray(bsel)
    sel = _sel(bsel, store.device)
    data = torch.stack([rep.cols[c][sel] for c in names])
    sums = torch.stack([rep.checksums[c][sel] for c in names])
    ok = ops.verify_blocks(data, sums).cpu().numpy()
    if not ok.all():
        ci, bi = np.argwhere(~ok)[0]
        ops.DISPATCH_COUNTS["verify_failures"] += 1
        b = int(bsel[bi])
        raise CorruptBlockError(rid, b, names[ci], int(rep.nodes[b]))
    if rep.sort_key in names:
        isel = np.asarray(rep.indexed[bsel], bool)
        if isel.any():
            sub = bsel[isel]
            ssel = _sel(sub, store.device)
            rok = ops.verify_root(
                rep.mins[ssel], rep.cols[rep.sort_key][ssel],
                partition_size=store.partition_size).cpu().numpy()
            if not rok.all():
                ops.DISPATCH_COUNTS["verify_failures"] += 1
                b = int(sub[np.argwhere(~rok)[0][0]])
                raise CorruptBlockError(rid, b, "__root__",
                                        int(rep.nodes[b]))


def _empty_read(store: BlockStore, proj_cols: tuple,
                rows: int) -> ReadResult:
    """Degenerate split: empty fixed-shape result."""
    tmpl = store.template_replica()
    dev = store.device
    return ReadResult(
        cols={c: torch.zeros((0, rows), dtype=tmpl.cols[c].dtype, device=dev)
              for c in proj_cols},
        mask=torch.zeros((0, rows), dtype=torch.bool, device=dev),
        rows_read_frac=torch.zeros((0,), dtype=torch.float32, device=dev),
        bytes_read=0)


def read_hail(store: BlockStore, query: HailQuery, qplan: QueryPlan,
              block_ids: Sequence[int] | None = None) -> ReadResult:
    """HAIL record reader over (a subset of) blocks, per-replica batched,
    in plain tensor operations.

    Assembly is GATHER-based: per-replica batches are concatenated in
    replica order and restored to input order with one inverse-permutation
    take per tensor.
    """
    nb = store.n_blocks
    ids = np.arange(nb) if block_ids is None else np.asarray(block_ids)
    rows = store.rows_per_block
    proj_cols = query.projection + (ROWID,)
    if len(ids) == 0:
        return _empty_read(store, proj_cols, rows)
    from repro_torch.kernels import ops
    dev = store.device
    col_bytes = 4 * rows
    bytes_read = torch.zeros((), dtype=torch.float32, device=dev)
    order: list[np.ndarray] = []     # input positions, concatenation order
    masks, fracs = [], []
    cols_parts: dict[str, list] = {c: [] for c in proj_cols}
    for rid in np.unique(qplan.replica_for_block[ids]):
        sel = np.nonzero(qplan.replica_for_block[ids] == rid)[0]
        bsel = ids[sel]
        bt = _sel(bsel, dev)
        rep = store.replicas[int(rid)]
        _verify_replica_blocks(
            store, int(rid), bsel,
            (proj_cols if query.filter is None
             else (query.filter[0],) + proj_cols))
        bad = _bad_mask(store, int(rid))[bt]
        use_index = (bool(qplan.index_scan[bsel].all())
                     and query.filter is not None)
        if query.filter is not None:
            kind = "index_scan_blocks" if use_index else "full_scan_blocks"
            ops.DISPATCH_COUNTS[kind] += len(bsel)
            col, lo, hi = query.filter
            # per-column attribution: reader_stats + the store's AccessLog
            gov.attribute_read(store, int(rid), col,
                               len(bsel) if use_index else 0,
                               0 if use_index else len(bsel))
            if use_index:
                m, fr = _index_read(rep.cols[col][bt], rep.mins[bt], bad,
                                    lo, hi,
                                    partition_size=store.partition_size)
            else:
                m = _full_read(rep.cols[col][bt], bad, lo, hi)
                fr = torch.ones((len(bsel),), dtype=torch.float32,
                                device=dev)
        else:
            m = ~bad
            fr = torch.ones((len(bsel),), dtype=torch.float32, device=dev)
        # modeled I/O: filter column read per partition range; projected
        # columns read for qualifying partitions only (PAX pruning)
        bytes_read = bytes_read + fr.sum() * col_bytes * (
            1 + len(query.projection))
        order.append(sel)
        masks.append(m)
        fracs.append(fr)
        for c in proj_cols:
            cols_parts[c].append(rep.cols[c][bt])
    if len(order) == 1:              # single replica: concat+gather is a noop
        mask, frac = masks[0], fracs[0]
        out_cols = {c: v[0] for c, v in cols_parts.items()}
    else:
        inv = np.empty(len(ids), dtype=np.int64)
        inv[np.concatenate(order)] = np.arange(len(ids))
        it = _sel(inv, dev)
        mask = torch.cat(masks)[it]
        frac = torch.cat(fracs)[it]
        out_cols = {c: torch.cat(v)[it] for c, v in cols_parts.items()}
    return ReadResult(cols=out_cols, mask=mask, rows_read_frac=frac,
                      bytes_read=bytes_read)


def _gather_replica_inputs(store: BlockStore, rid: int, bsel: np.ndarray,
                           col: str, proj_cols: tuple):
    """Decoded reader inputs for one replica's blocks: (keys, stacked
    projection, bad mask, root directories).  Each is a fresh tensor, so a
    later commit cannot change a read already in flight.

    When the store carries a hot-block cache (``core/cache.BlockCache``,
    attached by the HailServer) the gathered tensors are served from it;
    the store's destructive transitions invalidate the touched replica's
    entries, so a hit never observes a half-committed replica.  Checksums
    are verified when the cache is FILLED, not when it is hit: a cached
    gather is a separate tensor already proven against the stored
    checksums, which nothing writes afterwards."""
    cache = store.block_cache
    key = (rid, tuple(int(b) for b in bsel), col, proj_cols)
    if cache is not None:
        hit = cache.get(key)
        if hit is not None:
            obs_trace.instant("block_cache_hit", track="cache",
                              args={"replica": rid, "blocks": len(bsel)})
            return hit
    rep = store.replicas[rid]
    bt = _sel(bsel, store.device)
    with obs_trace.span("cache_fill", track="cache",
                        args={"replica": rid, "blocks": len(bsel)}):
        _verify_replica_blocks(store, rid, bsel, (col,) + proj_cols)
        val = (rep.cols[col][bt],
               torch.stack([rep.cols[c][bt] for c in proj_cols], dim=-1),
               _bad_mask(store, rid)[bt],
               rep.mins[bt])
    if cache is not None:
        cache.put(key, val)
    return val


def _gather_split_inputs(store: BlockStore, qplan: QueryPlan,
                         ids: np.ndarray, col: str, proj_cols: tuple,
                         n_queries: int = 1):
    """Per-block kernel inputs for a split, replica-batched and restored to
    input order with one inverse-permutation take per tensor — shared by
    the single-query and shared-scan fused readers.

    Attribution: each replica group is charged ``n_queries`` reads (one per
    query sharing the scan) through ``governor.attribute_read``."""
    rids = qplan.replica_for_block[ids]
    order, keys_p, proj_p, bad_p, mins_p, uidx_p = [], [], [], [], [], []
    for rid in np.unique(rids):
        sel = np.nonzero(rids == rid)[0]
        bsel = ids[sel]
        n_idx = int(np.asarray(qplan.index_scan[bsel], bool).sum())
        for _ in range(n_queries):
            gov.attribute_read(store, int(rid), col, n_idx,
                               len(bsel) - n_idx)
        k, p, b, m = _gather_replica_inputs(store, int(rid), bsel, col,
                                            proj_cols)
        order.append(sel)
        keys_p.append(k)
        proj_p.append(p)
        bad_p.append(b)
        mins_p.append(m)
        uidx_p.append(np.asarray(qplan.index_scan[bsel], np.int32))
    if len(order) == 1:              # single replica: concat+gather is a noop
        return (mins_p[0], keys_p[0], proj_p[0], bad_p[0], uidx_p[0])
    inv = np.empty(len(ids), dtype=np.int64)
    inv[np.concatenate(order)] = np.arange(len(ids))
    it = _sel(inv, store.device)
    return (torch.cat(mins_p)[it], torch.cat(keys_p)[it],
            torch.cat(proj_p)[it], torch.cat(bad_p)[it],
            np.concatenate(uidx_p)[inv])


def attribution_groups(qplan: QueryPlan, block_ids: Sequence[int]
                       ) -> tuple[tuple[int, int, int], ...]:
    """The per-replica (replica_id, index-scanned, full-scanned) block
    counts ``_gather_split_inputs`` charges ONE query for this split."""
    ids = np.asarray(block_ids)
    rids = qplan.replica_for_block[ids]
    out = []
    for rid in np.unique(rids):
        bsel = ids[rids == rid]
        n_idx = int(np.asarray(qplan.index_scan[bsel], bool).sum())
        out.append((int(rid), n_idx, len(bsel) - n_idx))
    return tuple(out)


def read_hail_kernels(store: BlockStore, query: HailQuery, qplan: QueryPlan,
                      block_ids: Sequence[int] | None = None) -> ReadResult:
    """Kernel-backed record reader: ONE fused ``hail_read`` launch per
    split, regardless of block count or replica mix.

    The kernel reads each block's root directory, prunes row tiles outside
    the qualifying partition range (per-block ``use_index`` selects pruned
    index scan vs failover full scan), and masks bad rows.  Semantics
    identical to ``read_hail``."""
    from repro_torch.kernels import ops

    assert query.filter is not None and store.layout == "pax"
    col, lo, hi = query.filter
    ids = (np.arange(store.n_blocks) if block_ids is None
           else np.asarray(block_ids))
    rows = store.rows_per_block
    proj_cols = tuple(query.projection) + (ROWID,)
    if len(ids) == 0:
        return _empty_read(store, proj_cols, rows)

    mins, keys, proj, bad, uidx = _gather_split_inputs(store, qplan, ids,
                                                       col, proj_cols)
    # one launch for the whole split; uidx stays a host array so ops'
    # scan-mode counters cost no device sync
    mask, out, frac = ops.hail_read(mins, keys, proj, bad, uidx, lo, hi,
                                    partition_size=store.partition_size)
    cols = {c: out[..., j] for j, c in enumerate(proj_cols)}
    col_bytes = 4 * rows
    return ReadResult(cols=cols, mask=mask, rows_read_frac=frac,
                      bytes_read=frac.sum() * col_bytes
                      * (1 + len(query.projection)))


def read_hail_batch(store: BlockStore, queries: Sequence[HailQuery],
                    qplan: QueryPlan,
                    block_ids: Sequence[int] | None = None
                    ) -> tuple[list[ReadResult], "int | torch.Tensor"]:
    """SHARED-SCAN record reader: ONE fused launch serves a whole batch of
    compatible queries (same filter column, same projection, same plan)
    over a split.

    Returns (one ReadResult per query, shared physical bytes).  The per-
    query results carry that query's own mask and rows-read fraction; the
    projection columns are SHARED tensors masked by the union of the batch's
    masks, which is exact under each query's own mask.  The second return
    value models the PHYSICAL I/O of the shared scan — per block, the widest
    partition range any query in the batch needed (a lazy 0-d tensor).
    """
    from repro_torch.kernels import ops

    assert store.layout == "pax" and len(queries) >= 1
    col = queries[0].filter_col
    assert col is not None, "shared-scan batches need a range filter"
    proj = tuple(queries[0].projection)
    for qq in queries[1:]:
        assert qq.filter_col == col and tuple(qq.projection) == proj, \
            "batched queries must share filter column and projection"
    ids = (np.arange(store.n_blocks) if block_ids is None
           else np.asarray(block_ids))
    rows = store.rows_per_block
    proj_cols = proj + (ROWID,)
    col_bytes = 4 * rows
    if len(ids) == 0:
        return [_empty_read(store, proj_cols, rows) for _ in queries], 0

    mins, keys, proj_arr, bad, uidx = _gather_split_inputs(
        store, qplan, ids, col, proj_cols, n_queries=len(queries))
    lohi = np.asarray([[qq.filter[1], qq.filter[2]] for qq in queries],
                      np.int32)
    mask, out, frac = ops.hail_read_batch(mins, keys, proj_arr, bad, uidx,
                                          lohi,
                                          partition_size=store.partition_size)
    return _batch_results(mask, out, frac, proj_cols, col_bytes)


def _batch_results(mask, out, frac, proj_cols: tuple, col_bytes: int
                   ) -> tuple[list[ReadResult], torch.Tensor]:
    """One split's shared-scan reader outputs -> (one ReadResult per query,
    shared physical bytes): the filter column plus the projection (without
    the row id) read over each query's, or the widest, partition range."""
    # 1 + len(projection) columns read: the filter column and the
    # projection (proj_cols ends in the row id, which is not read)
    n_read = len(proj_cols)
    cols = {c: out[..., j] for j, c in enumerate(proj_cols)}
    results = [
        ReadResult(cols=cols, mask=mask[..., qi],
                   rows_read_frac=frac[:, qi],
                   bytes_read=frac[:, qi].sum() * col_bytes * n_read)
        for qi in range(frac.shape[1])]
    shared_bytes = frac.max(dim=1).values.sum() * col_bytes * n_read
    return results, shared_bytes


def gather_shared_scan_inputs(store: BlockStore,
                              queries: Sequence[HailQuery],
                              qplan: QueryPlan,
                              block_ids: Sequence[int]):
    """Gathered fused-reader inputs for ONE split of a (possibly sharded)
    shared scan: (mins, keys, proj, bad, use_index).

    This is the host-side half of the fused read — BlockCache traffic,
    read-path checksum verification (raising ``CorruptBlockError`` exactly
    like the unsharded readers, so executors keep their quarantine/re-plan
    handling per split) and governor attribution all happen HERE; the wave
    executor then hands many splits' inputs to one sharded read.  Each
    tensor is a fresh gather (or a read-only block-cache value), so a
    commit, demotion or repair that lands before the wave launches cannot
    change it."""
    ids = np.asarray(block_ids)
    col = queries[0].filter_col
    assert col is not None and store.layout == "pax"
    proj_cols = tuple(queries[0].projection) + (ROWID,)
    return _gather_split_inputs(store, qplan, ids, col, proj_cols,
                                n_queries=len(queries))


def read_hail_batch_sharded(store: BlockStore,
                            queries: Sequence[HailQuery],
                            gathered: Sequence[tuple], mesh, axes
                            ) -> list[tuple[list[ReadResult],
                                            "int | torch.Tensor"]]:
    """SHARDED shared-scan reader: a WAVE of up to n_dev splits, each split
    one fused reader launch on its own slot of ``mesh`` along ``axes``
    (``ops.hail_read_batch_sharded``), all against the batch's (Q, 2)
    ranges.

    ``gathered`` holds per-split inputs from ``gather_shared_scan_inputs``
    (1 <= len <= n_dev).  Nothing is padded (the JAX package pads ragged
    splits and the wave only to run one SPMD program): each split's
    row-sets, fractions and bytes are those of ``read_hail_batch`` on the
    same blocks.  Returns one (results per query, shared bytes) pair per
    split, shaped exactly like ``read_hail_batch``'s return value; split
    k's tensors live on slot k's device and were made on its stream, where
    the caller records the split's completion event
    (``mesh.slots(axes)[k]``)."""
    from repro_torch.dist import sharding as dsh
    from repro_torch.kernels import ops

    assert store.layout == "pax" and len(queries) >= 1
    col = queries[0].filter_col
    assert col is not None, "shared-scan batches need a range filter"
    proj_cols = tuple(queries[0].projection) + (ROWID,)
    n_dev = dsh.scan_device_count(mesh, axes)
    assert 1 <= len(gathered) <= n_dev, (len(gathered), n_dev)
    n_q = len(queries)
    lohi = np.asarray([[qq.filter[1], qq.filter[2]] for qq in queries],
                      np.int32)
    # scan-mode counters here, as the JAX package keeps them: each query is
    # charged the blocks it scanned (the ops wrapper counts waves)
    for g in gathered:
        u = np.asarray(g[4])
        n_idx = int(u.astype(bool).sum())
        ops.DISPATCH_COUNTS["index_scan_blocks"] += n_q * n_idx
        ops.DISPATCH_COUNTS["full_scan_blocks"] += n_q * (u.shape[0] - n_idx)
    outs = ops.hail_read_batch_sharded(
        gathered, lohi, partition_size=store.partition_size, mesh=mesh,
        axes=axes)
    col_bytes = 4 * store.rows_per_block
    split_results = []
    for (mask, out, frac), slot in zip(outs, mesh.slots(axes)):
        with slot.run():      # the sums read frac after the slot's launch
            results, shared = _batch_results(mask, out, frac, proj_cols,
                                             col_bytes)
        slot.hand_back([r.bytes_read for r in results] + [shared])
        split_results.append((results, shared))
    return split_results


def read_hadoop(store: BlockStore, query: HailQuery,
                block_ids: Sequence[int] | None = None) -> ReadResult:
    """Hadoop baseline: parse raw ASCII rows, then scan (row layout)."""
    assert store.layout == "row_ascii"
    ids = (np.arange(store.n_blocks) if block_ids is None
           else np.asarray(block_ids))
    dev = store.device
    raw = store.replicas[0].cols["__raw__"][_sel(ids, dev)]
    cols, bad = ps.parse_block(store.schema, raw)
    rows = raw.shape[1]
    bids = torch.as_tensor(np.asarray(ids), dtype=torch.int32, device=dev)
    cols[ROWID] = (bids[:, None] * rows
                   + torch.arange(rows, dtype=torch.int32, device=dev))
    if query.filter is not None:
        col, lo, hi = query.filter
        mask = idx.full_scan_mask(cols[col], lo, hi) & ~bad
    else:
        mask = ~bad
    return ReadResult(cols={c: cols[c] for c in query.projection + (ROWID,)},
                      mask=mask,
                      rows_read_frac=torch.ones((len(ids),), device=dev),
                      bytes_read=int(raw.numel()))


def collect(result: ReadResult) -> dict[str, np.ndarray]:
    """Materialize qualifying rows (host side, for tests/examples)."""
    m = result.mask.cpu().numpy().reshape(-1)
    return {c: v.cpu().numpy().reshape(-1)[m]
            for c, v in result.cols.items()}
