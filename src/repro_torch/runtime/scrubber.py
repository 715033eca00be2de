"""Budgeted background scrubber: find corruption before queries do.

HDFS's DataBlockScanner walks every datanode's blocks in the background and
re-verifies their checksums so silent disk rot is caught long before a
client read trips over it.  This is its analogue for the HAIL store: a ``Scrubber`` attached to a ``BlockStore`` verifies a bounded batch
of (replica, block) pairs per ``tick()`` — ``run_job`` and
``HailServer.flush`` tick it at their job/flush boundaries, so scrubbing
rides the cluster's natural idle points instead of competing with the read
path — and immediately repairs whatever the tick (or earlier read-path
detection) quarantined, via ``BlockStore.repair_blocks``.

The scan order is a persistent round-robin cursor over all (replica, block)
pairs: every pair is re-verified once per full revolution regardless of
query traffic, which is exactly the coverage guarantee hot-path
verification cannot give (reads only verify what queries touch, and the
BlockCache means even that only on fills).  Verification reuses
``BlockStore.verify_block`` — all columns' chunk checksums plus
root-directory consistency for indexed blocks — so the scrubber detects
every fault class the read path does, including stale root directories on
blocks no query has ranged over yet.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.core.store import BlockStore
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class ScrubConfig:
    """``blocks_per_tick``: verification budget per job/flush boundary (the
    scrub tax a single job tolerates).  ``repair``: rebuild quarantined
    blocks from healthy replicas at the end of the tick."""
    blocks_per_tick: int = 8
    repair: bool = True


@dataclasses.dataclass
class ScrubStats:
    """Cumulative over the scrubber's lifetime."""
    ticks: int = 0
    blocks_verified: int = 0
    blocks_quarantined: int = 0
    blocks_repaired: int = 0
    unrepairable: int = 0
    bytes_rewritten: int = 0
    wall_s: float = 0.0


class Scrubber:
    """Round-robin verifier + repairer for one PAX ``BlockStore``."""

    def __init__(self, store: BlockStore,
                 config: ScrubConfig = ScrubConfig()):
        assert store.layout == "pax", "the scrubber targets PAX stores"
        self.store = store
        self.config = config
        self.stats = ScrubStats()
        self._cursor = 0

    def attach(self) -> "Scrubber":
        """Install on the store — ``run_job``/``flush`` tick
        ``store.scrubber`` at their boundaries."""
        self.store.scrubber = self
        return self

    def _schedule(self) -> list[tuple[int, int]]:
        """Next ``blocks_per_tick`` (replica, block) pairs under the
        persistent cursor, skipping dead nodes (nothing to read) and
        already-quarantined blocks (known bad; repair handles them)."""
        store = self.store
        pairs = [(r, b) for r in store.live_replica_ids()
                 for b in range(store.n_blocks)]
        if not pairs:
            return []
        out = []
        for k in range(len(pairs)):
            if len(out) >= self.config.blocks_per_tick:
                break
            rid, b = pairs[(self._cursor + k) % len(pairs)]
            node = int(store.replicas[rid].nodes[b])
            if (node in store.namenode.dead
                    or store.namenode.is_quarantined(b, node)):
                continue
            out.append((rid, b))
        self._cursor = (self._cursor + self.config.blocks_per_tick) \
            % len(pairs)
        return out

    def tick(self):
        """One scrub quantum: verify the scheduled pairs, quarantine
        failures, then repair everything quarantined (including blocks the
        READ PATH quarantined since the last tick).  Returns the
        cumulative ``ScrubStats``."""
        t0 = time.perf_counter()
        store = self.store
        self.stats.ticks += 1
        verified = quarantined = repaired = 0
        for rid, b in self._schedule():
            self.stats.blocks_verified += 1
            verified += 1
            if not store.verify_block(rid, b):
                store.quarantine_block(rid, b)
                self.stats.blocks_quarantined += 1
                quarantined += 1
                obs_trace.instant("scrub_quarantine", track="scrubber",
                                  args={"replica": rid, "block": b})
        if self.config.repair and store.namenode.quarantined:
            t_r = time.perf_counter()
            rs = store.repair_blocks()
            self.stats.blocks_repaired += rs.blocks_repaired
            self.stats.unrepairable += rs.unrepairable
            self.stats.bytes_rewritten += rs.bytes_rewritten
            repaired = rs.blocks_repaired
            obs_trace.complete_wall("repair", t_r,
                                    time.perf_counter() - t_r,
                                    track="scrubber",
                                    args={"repaired": rs.blocks_repaired,
                                          "unrepairable": rs.unrepairable})
        self.stats.wall_s += time.perf_counter() - t0
        obs_trace.complete_wall("scrub_tick", t0,
                                time.perf_counter() - t0, track="scrubber",
                                args={"cursor": self._cursor,
                                      "verified": verified,
                                      "quarantined": quarantined,
                                      "repaired": repaired})
        return self.stats
