"""The PyTorch port's first slice against the JAX package, end to end, on
the conftest shape (4 blocks x 1024 rows, partition 128, bad_fraction
0.002, 6 nodes): the three uploads, planning and splitting, the record
readers, ``run_job`` with and without a node failure, and a 6-job adaptive
run on a lazy store.  Everything is bit-exact except ``bytes_read``, a
float32 sum whose order may differ (relative tolerance 1e-6).  The port
runs on the CPU, so through the kernels' plain versions.  (The port's index
scan starts one partition earlier than the JAX package's where a partition
minimum equals a query's lower bound — a fault of the JAX package, pinned
in test_torch_kernels.py; no block at this shape has one for these
ranges.)"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import mapreduce as jmr  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import schema as jsc  # noqa: E402
from repro.core import splitting as jsp  # noqa: E402
from repro.core import upload as jup  # noqa: E402
from repro_torch.core import mapreduce as mr  # noqa: E402
from repro_torch.core import query as q  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.core import splitting as sp  # noqa: E402
from repro_torch.core import store as st  # noqa: E402
from repro_torch.core import upload as up  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

from conftest import PART  # noqa: E402

KEYS = ["visitDate", "sourceIP", "adRevenue"]
CPU = "cpu"
QUICK = ("visitDate", 10000, 10155)            # the quickstart query
RANGES = [QUICK, ("visitDate", 7305, 7670), ("sourceIP", 0, 2**29),
          ("duration", 100, 900), ("visitDate", 20000, 30000)]
BYTES_RTOL = 1e-6     # float32 sums of per-block fractions, order may differ


def jax_state(store) -> dict:
    """A JAX store's state in ``store_to_numpy``'s layout (retired
    replicas, the namenode's quarantine set and the store version
    included); arrays that replicas share stay shared."""
    seen: dict[int, np.ndarray] = {}

    def arr(a):
        if a is None:
            return None
        if id(a) not in seen:
            seen[id(a)] = np.asarray(a)
        return seen[id(a)]

    return {
        "schema": store.schema.name, "n_blocks": store.n_blocks,
        "rows_per_block": store.rows_per_block,
        "partition_size": store.partition_size, "layout": store.layout,
        "bad_counts": arr(store.bad_counts),
        "bad_original": arr(store.bad_original),
        "replicas": [{
            "sort_key": r.sort_key,
            "cols": {c: arr(v) for c, v in r.cols.items()},
            "mins": arr(r.mins),
            "checksums": {c: arr(v) for c, v in r.checksums.items()},
            "nodes": np.asarray(r.nodes), "indexed": np.asarray(r.indexed),
            "retired": r.retired,
        } for r in store.replicas],
        "namenode": [dataclasses.astuple(i)
                     for i in store.namenode.dir_rep.values()],
        "quarantined": sorted(store.namenode.quarantined),
        "version": store.version,
    }


def assert_same(want, got, path="state"):
    if isinstance(want, dict):
        assert set(want) == set(got), path
        for k in want:
            assert_same(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(want) == len(got), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same(w, g, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and want.shape == got.shape, path
        np.testing.assert_array_equal(want, got, err_msg=path)
    else:
        assert want == got, path


def _query(flt):
    return (jq.HailQuery(filter=flt, projection=("sourceIP",)),
            q.HailQuery(filter=flt, projection=("sourceIP",)))


def _split_tuples(splits):
    return [dataclasses.astuple(s) for s in splits]


@pytest.fixture(scope="module")
def raw(uservisits_raw):
    return uservisits_raw[1]


@pytest.fixture(scope="module")
def hail_pair(raw):
    j, js = jup.hail_upload(jsc.USERVISITS, raw, KEYS, partition_size=PART,
                            n_nodes=6)
    t, ts = up.hail_upload(sc.USERVISITS, raw, KEYS, partition_size=PART,
                           n_nodes=6, device=CPU)
    return j, js, t, ts


@pytest.fixture(scope="module")
def hdfs_pair(raw):
    j, js = jup.hdfs_upload(jsc.USERVISITS, raw, replication=3, n_nodes=6)
    t, ts = up.hdfs_upload(sc.USERVISITS, raw, replication=3, n_nodes=6,
                           device=CPU)
    return j, js, t, ts


def _lazy_pair(raw):
    j, js = jup.hail_upload(jsc.USERVISITS, raw, index_columns=(),
                            partition_size=PART, n_nodes=6)
    t, ts = up.hail_upload(sc.USERVISITS, raw, index_columns=(),
                           partition_size=PART, n_nodes=6, device=CPU)
    return j, js, t, ts


def _assert_uploads(j, js, t, ts):
    assert_same(jax_state(j), st.store_to_numpy(t))
    for f in ("ascii_bytes", "written_bytes", "extra_read_bytes",
              "n_indexes"):
        assert getattr(js, f) == getattr(ts, f), f
    assert set(js.phases) == set(ts.phases)


def test_hail_upload_matches_jax(hail_pair):
    _assert_uploads(*hail_pair)


def test_hdfs_upload_matches_jax(hdfs_pair):
    _assert_uploads(*hdfs_pair)


def test_lazy_and_hadooppp_uploads_match_jax(raw):
    _assert_uploads(*_lazy_pair(raw))
    j, js = jup.hadooppp_upload(jsc.USERVISITS, raw, "visitDate",
                                partition_size=PART, n_nodes=6)
    t, ts = up.hadooppp_upload(sc.USERVISITS, raw, "visitDate",
                               partition_size=PART, n_nodes=6, device=CPU)
    _assert_uploads(j, js, t, ts)


@pytest.mark.parametrize("flt", RANGES + [None])
def test_plan_and_splits_match_jax(hail_pair, flt):
    j, _, t, _ = hail_pair
    jqq, tq = _query(flt)
    jp, tp = jq.plan(j, jqq), q.plan(t, tq)
    for f in ("replica_for_block", "index_scan", "nodes"):
        np.testing.assert_array_equal(getattr(jp, f), getattr(tp, f))
    assert _split_tuples(jsp.hail_splits(j, jp)) == \
        _split_tuples(sp.hail_splits(t, tp))
    assert _split_tuples(jsp.hadoop_splits(j, jp)) == \
        _split_tuples(sp.hadoop_splits(t, tp))


def _assert_read(a, b):
    np.testing.assert_array_equal(np.asarray(a.mask), b.mask.numpy())
    np.testing.assert_array_equal(np.asarray(a.rows_read_frac),
                                  b.rows_read_frac.numpy())
    assert set(a.cols) == set(b.cols)
    for c in a.cols:
        np.testing.assert_array_equal(np.asarray(a.cols[c]),
                                      b.cols[c].numpy())
    np.testing.assert_allclose(float(a.bytes_read), float(b.bytes_read),
                               rtol=BYTES_RTOL)


@pytest.mark.parametrize("flt", RANGES[:4])
@pytest.mark.parametrize("failover", [False, True])
def test_readers_match_jax(hail_pair, flt, failover):
    """read_hail and read_hail_kernels on whole-store and partial splits,
    on a plan that mixes index and full scans after a node failure."""
    j, _, t, _ = hail_pair
    jqq, tq = _query(flt)
    if failover:
        j.namenode.kill_node(1)
        t.namenode.kill_node(1)
    try:
        jp, tp = jq.plan(j, jqq), q.plan(t, tq)
        for ids in (None, [2, 0], [3]):
            _assert_read(jq.read_hail(j, jqq, jp, ids),
                         q.read_hail(t, tq, tp, ids))
            with ops.stats_scope() as s:
                got = q.read_hail_kernels(t, tq, tp, ids)
            _assert_read(jq.read_hail_kernels(j, jqq, jp, ids), got)
            assert s.dispatches["hail_read"] == 1
            assert s.dispatches["index_search"] == 0
            assert s.dispatches["pax_scan"] == 0
    finally:
        j.namenode.revive()
        t.namenode.revive()


def test_shared_scan_matches_jax_and_single_reads(hail_pair):
    j, _, t, _ = hail_pair
    flts = [QUICK, ("visitDate", 7305, 7670), ("visitDate", 20000, 30000)]
    jqs = [jq.HailQuery(filter=f, projection=("sourceIP",)) for f in flts]
    tqs = [q.HailQuery(filter=f, projection=("sourceIP",)) for f in flts]
    jp, tp = jq.plan(j, jqs[0]), q.plan(t, tqs[0])
    jres, jshared = jq.read_hail_batch(j, jqs, jp, [0, 1, 3])
    with ops.stats_scope() as s:
        tres, tshared = q.read_hail_batch(t, tqs, tp, [0, 1, 3])
    assert s.dispatches["hail_read"] == 1
    np.testing.assert_allclose(float(jshared), float(tshared),
                               rtol=BYTES_RTOL)
    for a, b, tqq in zip(jres, tres, tqs):
        _assert_read(a, b)
        single = q.read_hail_kernels(t, tqq, tp, [0, 1, 3])
        assert torch.equal(single.mask, b.mask)


def _assert_jobs(a, b):
    assert a.n_tasks == b.n_tasks
    assert a.rescheduled_tasks == b.rescheduled_tasks
    assert a.full_scan_blocks == b.full_scan_blocks
    assert a.blocks_indexed == b.blocks_indexed
    assert a.results["n_rows"] == b.results["n_rows"]
    assert set(a.results["sample"]) == set(b.results["sample"])
    for c, v in a.results["sample"].items():
        np.testing.assert_array_equal(v, b.results["sample"][c])
    np.testing.assert_allclose(a.bytes_read, b.bytes_read, rtol=BYTES_RTOL)


@pytest.mark.parametrize("fail_node_at", [None, 0.5])
def test_run_job_kernels_matches_jax(hail_pair, hdfs_pair, fail_node_at):
    j, _, t, _ = hail_pair
    jqq, tq = _query(QUICK)
    a = jmr.run_job(j, jqq, reader="kernels", fail_node_at=fail_node_at)
    with ops.stats_scope() as s:
        b = mr.run_job(t, tq, reader="kernels", fail_node_at=fail_node_at)
    _assert_jobs(a, b)
    assert s.dispatches["hail_read"] == b.n_tasks     # one per split
    assert s.dispatches["index_search"] == 0
    assert s.dispatches["pax_scan"] == 0
    if fail_node_at is not None:
        assert b.rescheduled_tasks > 0
    # the plain-Hadoop baseline gives the same rows
    jh, _, th, _ = hdfs_pair
    h = mr.run_job(th, tq)
    _assert_jobs(jmr.run_job(jh, jqq), h)
    assert h.results["n_rows"] == b.results["n_rows"]


def test_adaptive_run_matches_jax(raw):
    """Six adaptive jobs on a lazy store: the same convergence curve, rows
    and final replica state as the JAX package."""
    j, _, t, _ = _lazy_pair(raw)
    jqq, tq = _query(QUICK)
    cfg_j = jmr.AdaptiveConfig(offer_rate=0.25)
    cfg_t = mr.AdaptiveConfig(offer_rate=0.25)
    curve = []
    for _ in range(6):
        a = jmr.run_job(j, jqq, reader="kernels", adaptive=cfg_j)
        b = mr.run_job(t, tq, reader="kernels", adaptive=cfg_t)
        _assert_jobs(a, b)
        curve.append((b.full_scan_blocks, b.blocks_indexed))
    assert curve == [(4, 1), (3, 1), (2, 1), (1, 1), (0, 0), (0, 0)]
    assert_same(jax_state(j), st.store_to_numpy(t))


def test_adaptive_commit_copies_on_write(raw):
    """Lazy replicas share their column tensors: a commit to one replica
    must leave its neighbours (and every tensor handed out before) as they
    were."""
    _, _, t, _ = _lazy_pair(raw)
    before = {c: v.clone() for c, v in t.replicas[0].cols.items()}
    handed_out = dict(t.replicas[0].cols)
    mr.run_job(t, _query(QUICK)[1], reader="kernels",
               adaptive=mr.AdaptiveConfig(offer_rate=0.5))
    rid = t.replica_by_key("visitDate")
    assert t.replicas[rid].indexed.sum() == 2
    for i, rep in enumerate(t.replicas):
        for c, v in before.items():
            assert torch.equal(handed_out[c], v)
            if i != rid:
                assert rep.cols[c] is handed_out[c]
    assert not torch.equal(t.replicas[rid].cols["visitDate"],
                           before["visitDate"])


def test_both_packages_start_from_the_same_state(hail_pair, raw):
    """A port store built from a JAX store's numpy state answers like it,
    and keeps lazy replicas' sharing."""
    j, _, _, _ = hail_pair
    t = st.store_from_numpy(jax_state(j), device=CPU)
    assert_same(jax_state(j), st.store_to_numpy(t))
    jqq, tq = _query(("visitDate", 7305, 7670))
    _assert_jobs(jmr.run_job(j, jqq, reader="kernels"),
                 mr.run_job(t, tq, reader="kernels"))
    jl, _, _, _ = _lazy_pair(raw)
    tl = st.store_from_numpy(jax_state(jl), device=CPU)
    assert tl.replicas[0].cols["visitDate"] is tl.replicas[2].cols["visitDate"]
