"""Seeded fault injection, the typed corruption-error vocabulary and the
recovery knobs.

HAIL recomputes per-replica checksums because each replica's sort order
differs (paper §3.2).  The read path verifies them and raises
``CorruptBlockError``; the executor quarantines the copy and re-plans, and
the scrubber (``runtime/scrubber.py``) repairs it.  ``FaultInjector`` is the
adversary that drives that pipeline: it flips bits in PAX columns,
scrambles root directories and truncates checksums of chosen (replica,
block)s, drawing from ``np.random.default_rng(seed)`` in the JAX package's
order, so one seed gives the same events in both packages.

Every fault COPIES ON WRITE: the replicas of a lazy upload share their
column (and root-directory) tensors, and an in-place write would corrupt
every replica at once — leaving no healthy donor to repair from.  So each
fault writes one block row into an out-of-place ``index_copy`` of the
tensor and rebinds only the targeted replica's entry, exactly as one
datanode's disk going bad; tensors already handed out (the block cache,
reads in flight) keep their clean copies.

The errors live here (not in ``query``) so ``store``/``mapreduce`` can
raise and catch them without import cycles.

* ``CorruptBlockError`` — a read-path checksum (or root-directory
  consistency) verification failed for one (replica, block, column).
* ``UnrecoverableDataError`` — every replica of some block is dead or
  quarantined, or the bounded re-plan retry budget is exhausted: the
  caller gets a clean typed failure, never silent wrong rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

import numpy as np
import torch


class CorruptBlockError(RuntimeError):
    """Read-path verification failed for one (replica, block, column).

    ``col`` is the column whose chunk checksums mismatched, or the
    sentinel ``"__root__"`` when the block's root directory disagreed
    with its sorted key column.
    """

    def __init__(self, replica_id: int, block_id: int, col: str,
                 node: Optional[int] = None):
        super().__init__(
            f"corrupt block: replica {replica_id}, block {block_id}, "
            f"col {col!r}" + (f", node {node}" if node is not None else ""))
        self.replica_id = replica_id
        self.block_id = block_id
        self.col = col
        self.node = node


class UnrecoverableDataError(RuntimeError):
    """No healthy replica can serve a block (all dead/quarantined), or the
    bounded re-plan retry budget ran out."""


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Knobs for the executor-side corruption/failover recovery loop.

    ``max_retries``: re-plan attempts PER BLOCK within one job (corruption
    retries and node-failure retries share the counter) — exceeding it
    raises ``UnrecoverableDataError`` instead of looping while replicas keep
    dying.  ``scrub``: run the store's attached background scrubber at the
    job/flush boundary.
    """
    max_retries: int = 3
    scrub: bool = True


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One injected fault (the injector's replayable audit trail)."""
    kind: str                      # chunk | column | root | checksum | node
    replica_id: int
    block_id: int
    col: Optional[str] = None
    node: Optional[int] = None


def _with_row(t: torch.Tensor, block_id: int, row: torch.Tensor):
    """``t`` with block row ``block_id`` replaced, out of place."""
    sel = torch.tensor([block_id], dtype=torch.int64, device=t.device)
    return t.index_copy(0, sel, row[None].to(t.dtype))


class FaultInjector:
    """Deterministic fault injection into one ``BlockStore``.

    All mutations are silent — no checksum is updated, no cache is
    invalidated — because that is what real corruption does.  Detection
    must come from the read path or the scrubber.
    """

    def __init__(self, store, seed: int = 0):
        self.store = store
        self.rng = np.random.default_rng(seed)
        self.events: list[FaultEvent] = []

    def _pick_col(self, replica_id: int, col: Optional[str]) -> str:
        if col is not None:
            return col
        names = sorted(self.store.replicas[replica_id].cols)
        return names[int(self.rng.integers(len(names)))]

    def _log(self, ev: FaultEvent) -> FaultEvent:
        self.events.append(ev)
        return ev

    def corrupt_chunk(self, replica_id: int, block_id: int,
                      col: Optional[str] = None) -> FaultEvent:
        """Flip ONE bit of one value in a column of a block — the smallest
        detectable fault: a one-bit flip moves a byte by ±2^k (k < 8), which
        cannot cancel mod 65521, so the chunk checksum must mismatch."""
        col = self._pick_col(replica_id, col)
        rep = self.store.replicas[replica_id]
        arr = rep.cols[col]
        pos = int(self.rng.integers(arr.shape[1]))
        bit = int(self.rng.integers(31))
        row = arr[block_id].clone()
        row[pos] = int(row[pos].item()) ^ (1 << bit)
        rep.cols[col] = _with_row(arr, block_id, row)
        return self._log(FaultEvent("chunk", replica_id, block_id, col))

    def corrupt_column(self, replica_id: int, block_id: int,
                       col: Optional[str] = None) -> FaultEvent:
        """Overwrite a block's whole column with random junk (a torn PAX
        minipage)."""
        col = self._pick_col(replica_id, col)
        rep = self.store.replicas[replica_id]
        arr = rep.cols[col]
        junk = self.rng.integers(0, 2**31 - 1, arr.shape[1], dtype=np.int32)
        rep.cols[col] = _with_row(arr, block_id,
                                  torch.from_numpy(junk).to(arr.device))
        return self._log(FaultEvent("column", replica_id, block_id, col))

    def corrupt_root(self, replica_id: int, block_id: int) -> FaultEvent:
        """Scramble a block's root directory (index mins) by an int32 add
        that wraps.  Checksums do not cover the directory — detection
        relies on the root-consistency check against the sorted key
        column."""
        rep = self.store.replicas[replica_id]
        shift = int(self.rng.integers(1, 1 << 20))
        row = (rep.mins[block_id].to(torch.int64) + shift + 2**31) \
            % 2**32 - 2**31
        rep.mins = _with_row(rep.mins, block_id, row)
        return self._log(FaultEvent("root", replica_id, block_id,
                                    "__root__"))

    def truncate_checksums(self, replica_id: int, block_id: int,
                           col: Optional[str] = None) -> FaultEvent:
        """Zero a block's stored checksums for one column — a truncated or
        stale checksum file.  The DATA is intact, but the read path cannot
        prove it: the block is treated as corrupt and repaired."""
        col = self._pick_col(replica_id, col)
        rep = self.store.replicas[replica_id]
        sums = rep.checksums[col]
        rep.checksums[col] = _with_row(sums, block_id,
                                       torch.zeros_like(sums[block_id]))
        return self._log(FaultEvent("checksum", replica_id, block_id, col))

    def corrupt_replicas(self, block_id: int, n_replicas: int,
                         col: Optional[str] = None) -> list[FaultEvent]:
        """Corrupt ``n_replicas`` DISTINCT replicas of one block (chunk
        flips).  ``n_replicas == R`` makes the block unrecoverable."""
        rids = self.rng.permutation(self.store.replication)[:n_replicas]
        return [self.corrupt_chunk(int(r), block_id, col) for r in rids]

    def kill_node(self, node: int) -> FaultEvent:
        """Fail-stop a datanode through the namenode liveness path — the
        mechanism ``run_job(fail_node_at=...)`` uses, so corruption and
        node death can interleave in one scenario."""
        self.store.namenode.kill_node(node)
        return self._log(FaultEvent("node", -1, -1, node=node))
