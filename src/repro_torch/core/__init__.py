"""HAIL core: the paper's contribution as a PyTorch data plane."""
from repro_torch.core.governor import (AccessLog, GovernorConfig,  # noqa: F401
                                       IndexGovernor, govern)
from repro_torch.core.index import PARTITION, ClusteredIndex  # noqa: F401
from repro_torch.core.mapreduce import ClusterModel, JobStats, run_job  # noqa: F401
from repro_torch.core.query import HailQuery, hail_annotation, plan  # noqa: F401
from repro_torch.core.schema import SYNTHETIC, USERVISITS, Schema  # noqa: F401
from repro_torch.core.store import (BlockStore, Namenode,  # noqa: F401
                                    store_from_numpy, store_to_numpy)
from repro_torch.core.upload import (hadooppp_upload, hail_lazy_upload,  # noqa: F401
                                     hail_upload, hdfs_upload)
