"""HailSplitting (paper §4.3, §6.5).

Hadoop default: one input split per block -> one map task per block; each
task pays constant scheduling overhead, which dominates short (index-scan)
tasks — the paper measured jobs where overhead was ~95% of runtime (Fig 6c).

HailSplitting, for index-scan jobs: cluster the job's blocks by the datanode
holding the chosen replica, then emit ``map_slots`` splits per node, each
covering MANY blocks.  3,200 tasks became 20 in the paper (68x end-to-end).
For full-scan jobs the default per-block splitting is kept (failover story
unchanged).

On the card the analogue is real: one kernel launch per *split* instead of
one per *block*.  The fused reader (kernels/hail_reader.py) executes a whole
split — index lookup, tile-pruned scan, projection — as a SINGLE launch with
a (row tile, block) grid, even when the split mixes index-scan and failover
full-scan blocks.  ``run_job`` then enqueues every split before one
completion pass, so split execution pipelines.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.query import QueryPlan
from repro_torch.core.store import BlockStore


@dataclasses.dataclass(frozen=True)
class Split:
    node: int
    block_ids: tuple[int, ...]
    index_scan: bool


def hadoop_splits(store: BlockStore, qplan: QueryPlan) -> list[Split]:
    """Default policy: one split per block."""
    return [Split(node=int(qplan.nodes[b]), block_ids=(b,),
                  index_scan=bool(qplan.index_scan[b]))
            for b in range(store.n_blocks)]


def hail_splits(store: BlockStore, qplan: QueryPlan,
                map_slots: int = 4) -> list[Split]:
    if not qplan.index_scan.all():
        # full-scan (or mixed) job: keep Hadoop's per-block splitting for the
        # scan part, coalesce only the indexed part
        idx_blocks = np.nonzero(qplan.index_scan)[0]
        scan_blocks = np.nonzero(~qplan.index_scan)[0]
        out = [Split(int(qplan.nodes[b]), (int(b),), False)
               for b in scan_blocks]
        out += _coalesce(idx_blocks, qplan, map_slots)
        return out
    return _coalesce(np.arange(store.n_blocks), qplan, map_slots)


def _coalesce(blocks: np.ndarray, qplan: QueryPlan,
              map_slots: int) -> list[Split]:
    splits: list[Split] = []
    for node in np.unique(qplan.nodes[blocks]):
        mine = blocks[qplan.nodes[blocks] == node]
        n_splits = min(map_slots, len(mine))
        for part in np.array_split(mine, n_splits):
            if len(part):
                splits.append(Split(node=int(node),
                                    block_ids=tuple(int(b) for b in part),
                                    index_scan=True))
    return splits
