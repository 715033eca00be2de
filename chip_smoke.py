"""HAIL's main path on one NVIDIA H100, through the PyTorch port.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, then drives the
port's main path at the paper's widths — UserVisits (91 B a row), 2^19-row
blocks (47.7 MB, the power of two closest to a 64 MB HDFS block), 1,024-row
index partitions, three replicas indexed on visitDate / sourceIP /
adRevenue, 10 nodes with 4 map slots — cut to 64 blocks (33.5 M rows,
3.05 GB of ASCII):

1. device   the card, its count and its power limit;
2. build    the kernels' build time;
3. kernels  each kernel against its plain version at main-path shapes, and
            the whole slice at the test shape on the card against the CPU;
4. eager    HAIL upload + indexed query through the fused reader, against
            the same query over a plain HDFS upload;
5. shared   one split read for 8 queries at once against 8 single reads;
6. adaptive a lazy upload that 6 adaptive jobs converge to fully indexed,
            then one eager, HDFS, building and converged job each again
            under the CUDA profiler: device-busy time and host spans;
7. times    each kernel's time against its bound, its plain version's time
            and, where one exists, a library call's.

Each phase prints one JSON line; every check that fails raises, so the exit
code is not 0.  The last line is ``{"ok": true, "device": {...}}``.  Data
comes from a fixed seed.  Needs one CUDA card; exits non-zero without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
ROWS = 1 << 19                 # rows a block
BLOCKS = 64                    # the cut: a sixth of one datanode's 20 GB
PARTITION = 1024               # rows a leaf partition (the paper's)
N_NODES = 10
BAD_FRACTION = 0.001
KEYS = ("visitDate", "sourceIP", "adRevenue")
QUICK = ("visitDate", 10000, 10155)    # examples/quickstart.py's query
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT_OPS_PER_S = 67e12          # H100 SXM peak outside the tensor cores
INT32_MAX = 2**31 - 1


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` in ms, between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# kernel inputs at main-path shapes
# ---------------------------------------------------------------------------


def reader_inputs(rng, b, rows, parts, n_cols, n_q, use_index):
    """Blocks as the store holds them: indexed blocks sorted by key with a
    root directory of partition minima, unindexed ones in upload order
    with a zeroed directory; bad rows at ~0.1%.  Keys are even, so an odd
    point range matches nothing; the ranges include ones below the minimum,
    above the maximum, lo > hi and the whole int32 range."""
    ps = rows // parts
    keys = (rng.integers(3500, 6000, (b, rows)) * 2).astype(np.int32)
    keys[use_index > 0] = np.sort(keys[use_index > 0], axis=1)
    mins = np.where(use_index[:, None] > 0, keys[:, ::ps], 0).astype(np.int32)
    proj = rng.integers(-2**31, INT32_MAX, (b, rows, n_cols)).astype(np.int32)
    bad = rng.random((b, rows)) < 0.001
    lohi = np.array([[10000, 10155], [-50, 6999], [12001, 20000],
                     [9000, 8000], [8001, 8001], [7000, 7500],
                     [-2**31, INT32_MAX], [11000, 11999]], np.int32)[:n_q]
    arrays = (mins, keys, proj, bad, use_index.astype(np.int32), lohi)
    return [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays]


def reader_bound(inputs, outputs, partition_size):
    """Least bytes the reader must move for these inputs: keys and bad flags
    of the rows some query's partition range covers, the projection of the
    rows some query keeps, the root directories of indexed blocks, every
    output byte; and two compares per live row and query."""
    mins, keys, proj, _, uidx, lohi = inputs
    mins, uidx, lohi = (t.cpu().numpy() for t in (mins, uidx, lohi))
    mask = outputs[0]
    b, rows = keys.shape
    n_cols, n_q = proj.shape[2], lohi.shape[0]
    live = 0
    for i in range(b):
        if not uidx[i]:
            live += rows
            continue
        spans = []
        for lo, hi in lohi:
            p0 = max(int((mins[i] <= lo).sum()) - 1, 0)
            p1 = max(int((mins[i] <= hi).sum()) - 1, 0)
            spans.append((p0 * partition_size,
                          min((p1 + 1) * partition_size, rows)))
        end = -1
        for s, e in sorted(spans):
            s = max(s, end)
            if e > s:
                live += e - s
                end = e
    kept = int(mask.any(dim=-1).sum())
    n_bytes = (live * 5 + kept * 4 * n_cols
               + int(uidx.sum()) * mins.shape[1] * 4 + b * 4 + n_q * 8  # reads
               + b * rows * (n_q + 4 * n_cols) + b * n_q * 4)  # writes
    return bound_ms(n_bytes, 2 * live * n_q)


def sort_inputs(rng, b, n):
    """Heavy duplicates and INT32_MAX bad-row sentinels."""
    keys = rng.integers(7000, 7050, (b, n)).astype(np.int32)
    keys[rng.random((b, n)) < 0.01] = INT32_MAX
    return torch.from_numpy(keys).cuda()


def sort_bound(keys):
    b, n = keys.shape
    log_n = n.bit_length() - 1
    exchanges = b * n // 2 * log_n * (log_n + 1) // 2
    return bound_ms(b * n * 12, exchanges)


def max_abs_err(got, want) -> float:
    return max(float((g.to(torch.float64) - w.to(torch.float64)).abs().max())
               if g.numel() else 0.0 for g, w in zip(got, want))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernels(rng):
    from repro_torch.kernels import block_sort, hail_reader, ref

    reader_cases = []
    for b, rows, parts, q, mix in [(16, ROWS, 512, 1, True),
                                   (16, ROWS, 512, 8, True),
                                   (16, ROWS, 512, 1, False),
                                   (1, ROWS, 512, 1, True),
                                   (2, ROWS, 512, 1, False),
                                   (4, 1024, 8, 1, True),
                                   (4, 1024, 8, 8, True)]:
        uidx = (np.arange(b) % 3 != 2) if mix else np.zeros(b, bool)
        inputs = reader_inputs(rng, b, rows, parts, 2, q, uidx)
        ps = rows // parts
        got = hail_reader.hail_read_batch(*inputs, partition_size=ps)
        want = ref.hail_read_batch(*inputs, partition_size=ps)
        torch.cuda.synchronize()
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        check(equal, f"hail_read kernel == plain at B={b} R={rows} Q={q}")
        reader_cases.append({"blocks": b, "rows": rows, "parts": parts,
                             "queries": q, "mixed_index": mix,
                             "rows_kept": int(got[0].any(-1).sum()),
                             "max_abs_err": max_abs_err(got, want)})
    sort_cases = []
    for b, n in [(1, ROWS), (16, ROWS), (4, 1024)]:
        keys = sort_inputs(rng, b, n)
        got = block_sort.bitonic_sort(keys)
        want = block_sort.bitonic_sort_plain(keys)
        lib = ref.sort_by_key(keys)
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"bitonic_sort kernel == plain at ({b}, {n})")
        check(all(torch.equal(g, w) for g, w in zip(got, lib)),
              f"bitonic_sort kernel == stable argsort at ({b}, {n})")
        sort_cases.append({"blocks": b, "n": n,
                           "max_abs_err": max_abs_err(got, want)})
    emit("kernels", reader=reader_cases, sort=sort_cases)
    return (max(c["max_abs_err"] for c in reader_cases),
            max(c["max_abs_err"] for c in sort_cases))


def phase_small_slice():
    """The whole slice at the test shape (4 blocks x 1024 rows, partition
    128, 6 nodes) on the card, against the same run on the CPU, where the
    plain versions serve: equal stores, rows and convergence."""
    from repro_torch.core import mapreduce as mr
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.core import store as st
    from repro_torch.core import upload as up
    from repro_torch.core.parse import format_rows

    cols = sc.gen_uservisits(4 * 1024, seed=7)
    raw = format_rows(sc.USERVISITS, cols, bad_fraction=0.002).reshape(
        4, 1024, -1)
    query = q.HailQuery(filter=QUICK, projection=("sourceIP",))
    runs = {}
    for dev in ("cuda", "cpu"):
        hail, _ = up.hail_upload(sc.USERVISITS, raw, list(KEYS),
                                 partition_size=128, n_nodes=6, device=dev)
        lazy, _ = up.hail_lazy_upload(sc.USERVISITS, raw, partition_size=128,
                                      n_nodes=6, device=dev)
        jobs = [mr.run_job(hail, query, reader="kernels"),
                mr.run_job(hail, query, reader="kernels", fail_node_at=0.5)]
        jobs += [mr.run_job(lazy, query, reader="kernels",
                            adaptive=mr.AdaptiveConfig(offer_rate=0.25))
                 for _ in range(6)]
        runs[dev] = ([(j.n_tasks, j.results["n_rows"], j.full_scan_blocks,
                       j.blocks_indexed,
                       [v.tolist() for v in j.results["sample"].values()])
                      for j in jobs],
                     st.store_to_numpy(lazy), st.store_to_numpy(hail))
    (jobs_g, lazy_g, hail_g), (jobs_c, lazy_c, hail_c) = \
        runs["cuda"], runs["cpu"]
    check(jobs_g == jobs_c, "small slice: card jobs == CPU jobs")
    for got, want in ((lazy_g, lazy_c), (hail_g, hail_c)):
        for rg, rc in zip(got["replicas"], want["replicas"]):
            for part in ("cols", "checksums"):
                for c in rc[part]:
                    check(np.array_equal(rg[part][c], rc[part][c]),
                          f"small slice: replica {part}[{c}] card == CPU")
            check(np.array_equal(rg["mins"], rc["mins"]),
                  "small slice: root directories card == CPU")
    emit("small_slice", jobs=len(jobs_g),
         curve=[j[2] for j in jobs_g[2:]], rows=jobs_g[0][1])


def profile_job(run) -> dict:
    """One more run of a job under the CUDA profiler and the port's span
    tracer: host wall, device-busy time (the sum of the device-side events:
    kernels and copies; the port uses one stream, so they do not overlap),
    the busiest of them, and host time per traced span (the per-split and
    whole-job slices left out: they overlap the others).  Walls here include
    the profiler's own cost; the phases above report walls without it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import trace

    tracer = trace.install()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        trace.uninstall()

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    top = sorted(events, key=device_us, reverse=True)[:6]
    spans: dict[str, float] = {}
    opened: dict[tuple, list] = {}
    for ev in tracer.events:
        key = (ev.get("tid"), ev.get("name"))
        if ev["ph"] == "B":
            opened.setdefault(key, []).append(ev["ts"])
        elif ev["ph"] == "E":
            spans[ev["name"]] = (spans.get(ev["name"], 0.0)
                                 + (ev["ts"] - opened[key].pop()) / 1e3)
        elif ev["ph"] == "X" and ev["name"] not in ("split", "job"):
            spans[ev["name"]] = spans.get(ev["name"], 0.0) + ev["dur"] / 1e3
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "top_device_ms": [[e.key[:160], device_us(e) / 1e3] for e in top],
            "host_span_ms": spans}


def rowid_collector():
    from repro_torch.core import query as q
    parts = []

    def on_split(_k, res, _wall):
        parts.append(q.collect(res)["__rowid__"])

    return parts, on_split


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import mapreduce as mr
    from repro_torch.core import query as q
    from repro_torch.core import schema as sc
    from repro_torch.core import splitting as sp
    from repro_torch.core import upload as up
    from repro_torch.core.parse import format_rows
    from repro_torch.kernels import _build, block_sort, hail_reader, ops, ref

    t_run = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit("device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0,
         library_seconds=_build.build_seconds)

    rng = np.random.default_rng(SEED)
    reader_err, sort_err = phase_kernels(rng)
    phase_small_slice()

    # --- 4. eager main path -------------------------------------------------
    t0 = time.perf_counter()
    cols = sc.gen_uservisits(BLOCKS * ROWS, seed=SEED)
    raw = format_rows(sc.USERVISITS, cols, bad_fraction=BAD_FRACTION,
                      seed=SEED + 1).reshape(BLOCKS, ROWS, -1)
    del cols
    gen_s = time.perf_counter() - t0
    query = q.HailQuery(filter=QUICK, projection=("sourceIP",))
    torch.cuda.reset_peak_memory_stats()
    hail, hail_up = up.hail_upload(sc.USERVISITS, raw, list(KEYS),
                                   partition_size=PARTITION, n_nodes=N_NODES)
    hdfs, hdfs_up = up.hdfs_upload(sc.USERVISITS, raw, replication=3,
                                   n_nodes=N_NODES)
    hail_rows, on_hail = rowid_collector()
    ops.KERNEL_LAUNCHES.clear()
    hail_job = mr.run_job(hail, query, reader="kernels", splitting="hail",
                          on_split_complete=on_hail)
    eager_launches = dict(ops.KERNEL_LAUNCHES)
    hdfs_rows, on_hdfs = rowid_collector()
    hdfs_job = mr.run_job(hdfs, query, on_split_complete=on_hdfs)
    eager_ids = np.sort(np.concatenate(hail_rows))
    check(hail_job.results["n_rows"] == hdfs_job.results["n_rows"],
          "HAIL rows == Hadoop rows")
    check(np.array_equal(eager_ids, np.sort(np.concatenate(hdfs_rows))),
          "HAIL rowid set == Hadoop rowid set")
    check(eager_launches.get("hail_read", 0) == hail_job.n_tasks,
          "one fused reader launch per HAIL split")
    check(eager_launches.get("bitonic_sort", 0) == 0,
          "the eager path sorts with the library sort")
    emit("eager", ascii_bytes=int(raw.size), data_gen_s=gen_s,
         hail_upload_s=hail_up.wall_s, hdfs_upload_s=hdfs_up.wall_s,
         hail_written_bytes=hail_up.written_bytes,
         hail_job_s=hail_job.map_compute_s,
         hdfs_job_s=hdfs_job.map_compute_s,
         hail_tasks=hail_job.n_tasks, hdfs_tasks=hdfs_job.n_tasks,
         hail_bytes_read=hail_job.bytes_read,
         hdfs_bytes_read=hdfs_job.bytes_read,
         rows=hail_job.results["n_rows"], launches=eager_launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated())

    eager_profiles = {
        "hail_job": profile_job(lambda: mr.run_job(hail, query,
                                                   reader="kernels")),
        "hdfs_job": profile_job(lambda: mr.run_job(hdfs, query))}

    # --- 5. shared scan: one split, 8 queries at once vs 8 single reads ----
    qplan = q.plan(hail, query)
    split = max(sp.hail_splits(hail, qplan), key=lambda s: len(s.block_ids))
    los = [7000, 7400, 8000, 9000, 10000, 10500, 11000, 11900]
    queries = [q.HailQuery(filter=("visitDate", lo, lo + 155 + 10 * i),
                           projection=("sourceIP",))
               for i, lo in enumerate(los)]
    with ops.stats_scope() as s:
        batch, _ = q.read_hail_batch(hail, queries, qplan, split.block_ids)
    check(s.dispatches["hail_read"] == 1, "one launch for the batch")
    for qq, res in zip(queries, batch):
        single = q.read_hail_kernels(hail, qq, qplan, split.block_ids)
        check(torch.equal(single.mask, res.mask),
              f"shared-scan mask == single read for {qq.filter}")
    emit("shared", blocks=len(split.block_ids), queries=len(queries),
         rows=[int(r.mask.sum()) for r in batch])
    del hail, hdfs, batch, single
    torch.cuda.empty_cache()

    # --- 6. adaptive: a lazy upload converges over 6 jobs -------------------
    torch.cuda.reset_peak_memory_stats()
    lazy, lazy_up = up.hail_lazy_upload(sc.USERVISITS, raw,
                                        partition_size=PARTITION,
                                        n_nodes=N_NODES)
    cfg = mr.AdaptiveConfig(offer_rate=0.25)
    jobs = []
    ops.KERNEL_LAUNCHES.clear()
    for _ in range(6):
        rows, on_split = rowid_collector()
        job = mr.run_job(lazy, query, reader="kernels", adaptive=cfg,
                         on_split_complete=on_split)
        check(np.array_equal(np.sort(np.concatenate(rows)), eager_ids),
              "adaptive job rowid set == eager rowid set")
        jobs.append(job)
    adaptive_launches = dict(ops.KERNEL_LAUNCHES)
    curve = [j.full_scan_blocks for j in jobs]
    quantum = mr.adaptive_quantum(lazy, cfg)
    check(curve == [max(BLOCKS - i * quantum, 0) for i in range(6)],
          f"convergence curve {curve}")
    check(all(j.results["n_rows"] == hail_job.results["n_rows"]
              for j in jobs), "adaptive rows == eager rows")
    check(adaptive_launches.get("bitonic_sort", 0) > 0,
          "adaptive builds sort with the bitonic kernel")
    check(adaptive_launches.get("hail_read", 0) == sum(j.n_tasks
                                                        for j in jobs),
          "one fused reader launch per adaptive split")
    profiles = {
        "adaptive_converged_job": profile_job(lambda: mr.run_job(
            lazy, query, reader="kernels", adaptive=cfg))}
    del lazy
    torch.cuda.empty_cache()
    fresh, _ = up.hail_lazy_upload(sc.USERVISITS, raw,
                                   partition_size=PARTITION, n_nodes=N_NODES)
    profiles["adaptive_first_job"] = profile_job(lambda: mr.run_job(
        fresh, query, reader="kernels", adaptive=cfg))
    emit("adaptive", lazy_upload_s=lazy_up.wall_s, curve=curve,
         blocks_indexed=[j.blocks_indexed for j in jobs],
         tasks=[j.n_tasks for j in jobs],
         job_s=[j.map_compute_s for j in jobs],
         build_s=[j.index_build_s for j in jobs],
         bytes_read=[j.bytes_read for j in jobs],
         launches=adaptive_launches,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    emit("profile", jobs={**eager_profiles, **profiles})
    del fresh, raw
    torch.cuda.empty_cache()

    # --- 7. times at main-path shapes ---------------------------------------
    ps = ROWS // 512
    timed = {}
    for name, b, q_n, mix in [("full_scan_q1", 16, 1, False),
                              ("mixed_q1", 16, 1, True),
                              ("mixed_q8", 16, 8, True),
                              ("full_scan_q1_64blocks", 64, 1, False)]:
        uidx = (np.arange(b) % 3 != 2) if mix else np.zeros(b, bool)
        inputs = reader_inputs(rng, b, ROWS, 512, 2, q_n, uidx)
        out = hail_reader.hail_read_batch(*inputs, partition_size=ps)
        bound, by = reader_bound(inputs, out, ps)
        timed[name] = {
            "shape": f"B={b} R={ROWS} P=512 C=2 Q={q_n} "
                     f"{'mixed index' if mix else 'full scan'}",
            "ms": cuda_ms(lambda: hail_reader.hail_read_batch(
                *inputs, partition_size=ps), 20),
            "plain_ms": cuda_ms(lambda: ref.hail_read_batch(
                *inputs, partition_size=ps), 3, warmup=1),
            "bound_ms": bound, "bound_by": by}
        del inputs, out
    for b in (1, 16):
        keys = sort_inputs(rng, b, ROWS)
        bound, by = sort_bound(keys)
        timed[f"sort_{b}x2^19"] = {
            "shape": f"({b}, {ROWS}) int32",
            "ms": cuda_ms(lambda: block_sort.bitonic_sort(keys), 20),
            "plain_ms": cuda_ms(lambda: block_sort.bitonic_sort_plain(keys),
                                3, warmup=1),
            "library_ms": cuda_ms(lambda: torch.sort(keys, dim=-1,
                                                     stable=True), 20),
            "bound_ms": bound, "bound_by": by}
    emit("times", cases=timed)

    reader, sort = timed["full_scan_q1"], timed["sort_1x2^19"]
    kernels = [
        {"name": "hail_read", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hail_reader.cu",
         "replaces": "src/repro/kernels/hail_reader.py:48",
         "launches": eager_launches.get("hail_read", 0)
         + adaptive_launches.get("hail_read", 0),
         "max_abs_err": reader_err, "ms": reader["ms"],
         "plain_ms": reader["plain_ms"], "bound_ms": reader["bound_ms"],
         "bound_by": reader["bound_by"], "library_ms": None,
         "shape": reader["shape"]},
        {"name": "bitonic_sort", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/block_sort.cu",
         "replaces": "src/repro/kernels/block_sort.py:51",
         "launches": adaptive_launches.get("bitonic_sort", 0),
         "max_abs_err": sort_err, "ms": sort["ms"],
         "plain_ms": sort["plain_ms"], "bound_ms": sort["bound_ms"],
         "bound_by": sort["bound_by"], "library_ms": sort["library_ms"],
         "shape": sort["shape"]},
    ]
    emit("done", seconds=time.perf_counter() - t_run)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
