"""Simulated cluster: nodes, heartbeats, failures, stragglers.  The port's
copy of the JAX package's framework-free module.

The CPU container cannot run 1000 nodes, but the *scheduling control plane*
can be exercised for real: this event-driven simulator drives the same task
scheduler that the HailSplitting benchmarks use, with per-node speed factors
(stragglers), fail-stop node deaths detected by heartbeat expiry (the
paper's 30s expiry in §6.4.3), and replica-aware rescheduling.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NodeState:
    node_id: int
    speed: float = 1.0            # task runtime multiplier (>1 = straggler)
    alive: bool = True
    last_heartbeat: float = 0.0


class SimulatedCluster:
    def __init__(self, n_nodes: int, map_slots: int = 4, seed: int = 0,
                 straggler_frac: float = 0.0, straggler_slow: float = 4.0,
                 heartbeat_expiry_s: float = 30.0):
        rng = np.random.default_rng(seed)
        self.nodes = [NodeState(i) for i in range(n_nodes)]
        n_strag = int(round(straggler_frac * n_nodes))
        for i in rng.choice(n_nodes, n_strag, replace=False):
            self.nodes[i].speed = straggler_slow
        self.map_slots = map_slots
        self.heartbeat_expiry_s = heartbeat_expiry_s
        self._fail_at: dict[int, float] = {}

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def schedule_failure(self, node_id: int, at_time_s: float):
        self._fail_at[node_id] = at_time_s

    def tick(self, now_s: float) -> list[int]:
        """Advance liveness; returns nodes newly detected dead (heartbeat
        expiry after their fail time)."""
        newly_dead = []
        for nid, t_fail in list(self._fail_at.items()):
            node = self.nodes[nid]
            if node.alive and now_s >= t_fail + self.heartbeat_expiry_s:
                node.alive = False
                newly_dead.append(nid)
        return newly_dead

    def is_failed(self, node_id: int, now_s: float) -> bool:
        """True once the node has actually died (even if not yet detected)."""
        t = self._fail_at.get(node_id)
        return t is not None and now_s >= t

    def alive_nodes(self) -> list[int]:
        return [n.node_id for n in self.nodes if n.alive]
