"""HAIL data-plane dry-run: trace the SPMD MapReduce engine on the
production meshes (the block-store analogue of the model-cell dry-run).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_hail

The counterpart of the JAX package's ``launch/dryrun_hail.py``, which
compiles ``spmd_aggregate`` over 4,096 blocks of 65,536 int32 rows on
512 placeholder devices.  The port traces its own ``spmd_aggregate``
(``core/mapreduce.py``) on the meta production mesh, the blocks split over
"data", under ``cost_analysis.CostTrace``: nothing is allocated.  Its
record has the JAX package's keys, ``trace_s`` where it has
``compile_s``; ``temp_bytes`` is the trace's peak of live bytes, which is
one slot's peak since the slots run one after another (plus the partials
they keep); ``combiner_ops`` counts the combiners' ``index_add_``
launches the trace saw, one for the sums and one for the counts a slot.
``all_to_all_ops`` and ``shuffle_bytes`` are not counted from the trace
(the slots of the meta mesh share one device, so the shuffle moves
nothing there) but modelled from ``spmd_aggregate``'s code, and listed
under ``modelled``: two shuffles, one for the sums and one for the
counts, in which a device sends its float32 partials of the other
devices' buckets.
"""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.core import mapreduce as mr
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.dryrun import ART_DIR
from repro_torch.launch.mesh import make_production_mesh


def run(multi_pod: bool, out_dir: str = ART_DIR) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    data_axis = "data"
    rows, blocks = 65536, 4096          # 4096 blocks of 64k rows (PAX int32)
    n_buckets = 4096
    n_dev = mesh.shape[data_axis]

    keys = torch.empty((blocks, rows), dtype=torch.int32, device="meta")
    vals = torch.empty((blocks, rows), dtype=torch.int32, device="meta")
    mask = torch.empty((blocks, rows), dtype=torch.bool, device="meta")

    t0 = time.time()
    with ca.CostTrace(device="meta") as trace:
        sums, cnts = mr.spmd_aggregate(mesh, keys, vals, mask, n_buckets,
                                       axis=data_axis)
    dt = time.time() - t0
    if sums.shape != (n_buckets,) or cnts.shape != (n_buckets,):
        raise RuntimeError(f"spmd_aggregate gave {tuple(sums.shape)} and "
                           f"{tuple(cnts.shape)}")
    rec = {"kind": "hail_mapreduce", "multi_pod": multi_pod,
           "devices": int(mesh.devices.size), "blocks": blocks,
           "rows": rows, "trace_s": dt,
           "temp_bytes": trace.peak_live_bytes,
           "combiner_ops": trace.op_counts["aten.index_add_.default"],
           "all_to_all_ops": 2,
           "shuffle_bytes": 2 * 4 * n_buckets * (n_dev - 1) // n_dev,
           "modelled": ["all_to_all_ops", "shuffle_bytes"],
           "hlo": trace.to_dict()}
    name = f"hail_mapreduce__{'multi' if multi_pod else 'single'}.json"
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)
    print(f"[ok] HAIL MR dry-run {'multi' if multi_pod else 'single'}-pod: "
          f"{mesh.devices.size} devices, trace {dt:.1f}s, "
          f"{rec['combiner_ops']} combiner launches, "
          f"{rec['all_to_all_ops']} shuffles of {rec['shuffle_bytes']} bytes "
          f"a device (modelled)", flush=True)
    return rec


if __name__ == "__main__":
    run(False)
    run(True)
