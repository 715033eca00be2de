"""The paper's OWN configuration surface (its 'architecture' is a cluster +
datasets + indexing policy, not a model): presets matching §6.1–6.2 scaled
to a single host, over the port's ``ClusterModel`` and schemas."""
from __future__ import annotations

import dataclasses

from repro_torch.core.mapreduce import ClusterModel
from repro_torch.core.schema import SYNTHETIC, USERVISITS


@dataclasses.dataclass(frozen=True)
class HailDemoCfg:
    name: str
    schema: object
    sort_keys: tuple            # one clustered index per replica
    rows_per_block: int
    n_blocks: int
    partition_size: int
    cluster: ClusterModel


# the paper: 10-node physical cluster, 64MB blocks, 20GB UserVisits/node,
# replication 3, indexes visitDate/sourceIP/adRevenue (§6.4.1)
USERVISITS_DEMO = HailDemoCfg(
    name="uservisits-10node",
    schema=USERVISITS,
    sort_keys=("visitDate", "sourceIP", "adRevenue"),
    rows_per_block=4096,
    n_blocks=40,
    partition_size=1024,
    cluster=ClusterModel(n_nodes=10, map_slots=4, sched_overhead_s=3.0,
                         disk_bw=100e6),
)

# Synthetic: 19 int attributes, 13GB/node, indexes on attr0..2 (§6.2)
SYNTHETIC_DEMO = HailDemoCfg(
    name="synthetic-10node",
    schema=SYNTHETIC,
    sort_keys=("attr0", "attr1", "attr2"),
    rows_per_block=4096,
    n_blocks=40,
    partition_size=1024,
    cluster=ClusterModel(n_nodes=10, map_slots=4, sched_overhead_s=3.0,
                         disk_bw=100e6),
)

# scale-out presets (Fig 5): 50/100-node EC2 cc1.4xlarge
SCALEOUT_50 = dataclasses.replace(
    USERVISITS_DEMO, name="uservisits-50node",
    cluster=ClusterModel(n_nodes=50, map_slots=4))
SCALEOUT_100 = dataclasses.replace(
    USERVISITS_DEMO, name="uservisits-100node",
    cluster=ClusterModel(n_nodes=100, map_slots=4))
