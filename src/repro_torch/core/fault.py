"""The typed corruption-error vocabulary and the recovery knobs.

HAIL recomputes per-replica checksums because each replica's sort order
differs (paper §3.2).  The read path verifies them and raises
``CorruptBlockError``; the executor quarantines the copy and re-plans.  The
errors live here (not in ``query``) so ``store``/``mapreduce`` can raise
and catch them without import cycles.

* ``CorruptBlockError`` — a read-path checksum (or root-directory
  consistency) verification failed for one (replica, block, column).
* ``UnrecoverableDataError`` — every replica of some block is dead or
  quarantined, or the bounded re-plan retry budget is exhausted: the
  caller gets a clean typed failure, never silent wrong rows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
    dying.
    """
    max_retries: int = 3
