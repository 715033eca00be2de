"""The multi-device wave dispatch of the PyTorch port against the JAX
package, on 12 blocks x 4096 rows (partition 256, bad_fraction 0.002, 6
nodes), with fake meshes of "cpu" slots (``make_mesh(..., devices=["cpu"]
* n)``): the scan axes of a mesh, the sharded shared-scan reader split by
split, ``run_job(mesh=...)`` (plain, failover, a block corrupted and
quarantined in mid-wave, the adaptive sequence), gathered inputs as
snapshots, ``HailServer`` flushes with a mesh, and ``spmd_aggregate``.

The oracle is the JAX package's UNSHARDED per-split reader and executor
(its sharded reader does not run on every jax version), and the port's own
unsharded path.  Tolerances: none.  Masks, projected columns, fractions,
row-id sets, ``JobStats`` counts, per-split lists, reader counters and
whole store states are bit-exact; ``bytes_read`` summed over a job's splits
is a float32 sum whose order may differ across packages (relative 1e-6,
as in test_torch_slice.py), and is exact against the port's own unsharded
job.  The expected counters of a sharded read are the unsharded read's
with ``hail_read`` / ``hail_read_batch`` replaced by one
``hail_read_sharded_waves`` a wave of up to n_dev splits and one
``hail_read_sharded_splits`` a split: the JAX package's sharded
accounting.  The query ranges start on no partition minimum, where the two
packages' index scans differ (test_torch_kernels.py pins that).  The JAX
package runs its plain references (``ops.use_kernels(False)``)."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import fault as jfault  # noqa: E402
from repro.core import mapreduce as jmr  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import schema as jsc  # noqa: E402
from repro.core import upload as jup  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.runtime import jobserver as jjs  # noqa: E402
from repro_torch.core import fault  # noqa: E402
from repro_torch.core import mapreduce as mr  # noqa: E402
from repro_torch.core import query as q  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.core import store as st  # noqa: E402
from repro_torch.core import upload as up  # noqa: E402
from repro_torch.core.parse import format_rows  # noqa: E402
from repro_torch.core.splitting import hail_splits  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
from repro_torch.runtime import jobserver as js  # noqa: E402

from test_torch_slice import BYTES_RTOL, assert_same, jax_state  # noqa: E402

BLOCKS, ROWS, PART = 12, 4096, 256
KEYS = ["visitDate", "sourceIP", "adRevenue"]
CPU = "cpu"
SEED = 11
# visitDate ranges whose lower bounds are no partition minimum (checked)
LOS = [7013, 7411, 8017, 9003, 10009, 10507, 11003, 11907]
PROJ = ("sourceIP",)
# ragged splits of 1, 2 and 3 blocks
SPLITS = [[0], [1, 2], [3, 4, 5], [6], [7, 8], [9, 10, 11]]
JOB_FIELDS = ("n_tasks", "rescheduled_tasks", "blocks_indexed",
              "full_scan_blocks", "blocks_demoted", "blocks_quarantined",
              "corrupt_retries")


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    jops.use_kernels(False)
    yield
    jops.use_kernels(True)


@pytest.fixture(scope="module")
def raw():
    cols = sc.gen_uservisits(BLOCKS * ROWS, seed=SEED)
    return format_rows(sc.USERVISITS, cols, bad_fraction=0.002).reshape(
        BLOCKS, ROWS, -1)


def _eager(raw):
    j, _ = jup.hail_upload(jsc.USERVISITS, raw, KEYS, partition_size=PART,
                           n_nodes=6)
    t, _ = up.hail_upload(sc.USERVISITS, raw, KEYS, partition_size=PART,
                          n_nodes=6, device=CPU)
    return j, t


def _lazy(raw):
    j, _ = jup.hail_lazy_upload(jsc.USERVISITS, raw, partition_size=PART,
                                n_nodes=6)
    t, _ = up.hail_lazy_upload(sc.USERVISITS, raw, partition_size=PART,
                               n_nodes=6, device=CPU)
    return j, t


@pytest.fixture
def eager(raw):
    return _eager(raw)


@pytest.fixture(scope="module")
def mixed(raw):
    """A lazy store whose visitDate replica one adaptive job has indexed on
    3 of 12 blocks — the JAX store, and the port's built from its state —
    so a visitDate plan mixes index and full scans."""
    j, _ = jup.hail_lazy_upload(jsc.USERVISITS, raw, partition_size=PART,
                                n_nodes=6)
    jmr.run_job(j, jq.HailQuery(filter=("visitDate", LOS[0], LOS[0] + 9),
                                projection=PROJ),
                adaptive=jmr.AdaptiveConfig(offer_rate=0.25))
    t = st.store_from_numpy(jax_state(j), device=CPU)
    jplan = jq.plan(j, jq.HailQuery(filter=("visitDate", 0, 1),
                                    projection=PROJ))
    assert 0 < int(np.asarray(jplan.index_scan).sum()) < BLOCKS
    return j, t


def _cpu_mesh(n: int):
    return make_mesh((n,), ("data",), devices=[CPU] * n)


def _queries(n_q: int, width: int = 400):
    flts = [("visitDate", lo, lo + width + 10 * i)
            for i, lo in enumerate(LOS[:n_q])]
    return ([jq.HailQuery(filter=f, projection=PROJ) for f in flts],
            [q.HailQuery(filter=f, projection=PROJ) for f in flts])


def _no_lo_on_a_minimum(store, queries):
    """Guard: no query's lower bound equals a partition minimum of the
    replicas it reads (where the two packages' index scans differ)."""
    for rep in store.replicas:
        if rep.sort_key == "visitDate":
            mins = set(rep.mins.reshape(-1).tolist())
            assert not {qq.filter[1] for qq in queries} & mins


def _sharded_counts(want: dict, n_splits: int, n_dev: int) -> dict:
    """The JAX package's unsharded reader counters -> its sharded ones."""
    want = dict(want)
    want.pop("hail_read", None)
    want.pop("hail_read_batch", None)
    want["hail_read_sharded_waves"] = math.ceil(n_splits / n_dev)
    want["hail_read_sharded_splits"] = n_splits
    return want


def _nonzero(d) -> dict:
    return {k: v for k, v in d.items() if v}


# ---------------------------------------------------------------------------
# Mesh axes
# ---------------------------------------------------------------------------

MESHES = [((1, 1), ("data", "model")), ((4,), ("data",)),
          ((2, 4), ("pod", "data")), ((4, 2), ("data", "model")),
          ((1, 4), ("data", "model"))]


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_scan_mesh_axes_match_reference(shape, axes):
    fake = types.SimpleNamespace(axis_names=axes,
                                 devices=np.empty(shape, dtype=object))
    want = jsh.scan_mesh_axes(fake)
    assert sh.scan_mesh_axes(fake) == want
    assert sh.scan_device_count(fake, want) == jsh.scan_device_count(
        fake, want)
    mesh = make_mesh(shape, axes, devices=[CPU] * math.prod(shape))
    assert sh.scan_mesh_axes(mesh) == want
    assert len(mesh.slots(want)) == jsh.scan_device_count(fake, want)
    assert mesh.shape == dict(zip(axes, shape))


def test_make_mesh_checks_its_devices():
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("data", "model"), devices=[CPU] * 3)
    host = make_host_mesh(CPU)
    assert host.shape == {"data": 1, "model": 1}
    assert sh.scan_mesh_axes(host) == ()
    slots = _cpu_mesh(4).slots(("data",))
    assert [s.device for s in slots] == [torch.device(CPU)] * 4
    assert all(s.stream is None for s in slots)


# ---------------------------------------------------------------------------
# The sharded shared-scan reader, split by split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_q", [1, 3, 8])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_sharded_reader_matches_reference(mixed, n_dev, n_q):
    j, t = mixed
    jqs, tqs = _queries(n_q)
    _no_lo_on_a_minimum(t, tqs)
    jplan, tplan = jq.plan(j, jqs[0]), q.plan(t, tqs[0])
    assert np.array_equal(np.asarray(jplan.index_scan), tplan.index_scan)
    assert tplan.index_scan.any() and not tplan.index_scan.all()
    with jops.stats_scope() as js_:
        want = [jq.read_hail_batch(j, jqs, jplan, ids) for ids in SPLITS]
    mesh = _cpu_mesh(n_dev)
    axes = sh.scan_mesh_axes(mesh) or ("data",)
    got = []
    with ops.stats_scope() as ts_:
        for w0 in range(0, len(SPLITS), n_dev):
            wave = [q.gather_shared_scan_inputs(t, tqs, tplan, ids)
                    for ids in SPLITS[w0:w0 + n_dev]]
            got += q.read_hail_batch_sharded(t, tqs, wave, mesh, axes)
    for (wres, wshared), (gres, gshared) in zip(want, got):
        assert float(np.asarray(wshared)) == float(gshared)
        for wr, gr in zip(wres, gres):
            np.testing.assert_array_equal(np.asarray(wr.mask),
                                          gr.mask.numpy())
            np.testing.assert_array_equal(np.asarray(wr.rows_read_frac),
                                          gr.rows_read_frac.numpy())
            assert float(np.asarray(wr.bytes_read)) == float(gr.bytes_read)
            assert set(wr.cols) == set(gr.cols)
            for c in wr.cols:
                np.testing.assert_array_equal(np.asarray(wr.cols[c]),
                                              gr.cols[c].numpy())
    assert _nonzero(ts_.dispatches) == _nonzero(_sharded_counts(
        js_.dispatches, len(SPLITS), n_dev))
    assert ts_.dispatches["hail_read_sharded_waves"] == math.ceil(
        len(SPLITS) / n_dev)


def test_sharded_reader_equals_the_unsharded_reader(mixed):
    """Against the port's own per-split reader: the same tensors, bytes
    included, bit for bit."""
    _, t = mixed
    _, tqs = _queries(3)
    tplan = q.plan(t, tqs[0])
    mesh = _cpu_mesh(3)
    wave = [q.gather_shared_scan_inputs(t, tqs, tplan, ids)
            for ids in SPLITS[3:]]
    got = q.read_hail_batch_sharded(t, tqs, wave, mesh, ("data",))
    for ids, (gres, gshared) in zip(SPLITS[3:], got):
        wres, wshared = q.read_hail_batch(t, tqs, tplan, ids)
        assert torch.equal(wshared, gshared)
        for wr, gr in zip(wres, gres):
            assert torch.equal(wr.mask, gr.mask)
            assert torch.equal(wr.rows_read_frac, gr.rows_read_frac)
            assert torch.equal(wr.bytes_read, gr.bytes_read)
            for c in wr.cols:
                assert torch.equal(wr.cols[c], gr.cols[c])


@pytest.mark.parametrize("change", ["demote", "repair"])
def test_gathered_inputs_are_snapshots(eager, change):
    """A demotion or a repair that lands between gathering a split and
    launching its wave leaves the split's row-set as gathered."""
    _, t = eager
    _, tqs = _queries(2)
    tplan = q.plan(t, tqs[0])
    ids = [3, 4, 5]
    want, _ = q.read_hail_batch(t, tqs, tplan, ids)
    wave = [q.gather_shared_scan_inputs(t, tqs, tplan, ids)]
    rid = int(tplan.replica_for_block[ids[0]])
    before = [g.clone() for g in wave[0][:4]]
    if change == "demote":
        assert t.demote_replica(rid) > 0
        assert not t.replicas[rid].indexed[ids].any()
    else:
        fault.FaultInjector(t, seed=SEED).corrupt_chunk(rid, 4, "visitDate")
        assert not bool(t.verify_block(rid, 4))
        t.quarantine_block(rid, 4)
        assert t.repair_blocks().blocks_repaired == 1
    for g, b in zip(wave[0][:4], before):
        assert torch.equal(g, b)
    [(got, _)] = q.read_hail_batch_sharded(t, tqs, wave, _cpu_mesh(2),
                                           ("data",))
    for wr, gr in zip(want, got):
        assert torch.equal(wr.mask, gr.mask)
        assert torch.equal(wr.cols[sc.ROWID][wr.mask],
                           gr.cols[sc.ROWID][gr.mask])


# ---------------------------------------------------------------------------
# run_job(mesh=...)
# ---------------------------------------------------------------------------


def _job(pkg, store, query, **kw):
    """-> (JobStats, sorted row ids, per-split fractions, reader counters)."""
    qmod, ops_mod = (jq, jops) if pkg == "jax" else (q, ops)
    ids, fracs = [], []

    def on_split(_k, res, _wall):
        ids.append(np.asarray(qmod.collect(res)[sc.ROWID]))
        fracs.append(np.asarray(res.rows_read_frac))

    mr_mod = jmr if pkg == "jax" else mr
    with ops_mod.stats_scope() as s:
        stats = mr_mod.run_job(store, query, reader="kernels",
                               on_split_complete=on_split, **kw)
    return stats, np.sort(np.concatenate(ids)), fracs, dict(s.dispatches)


def _same_job(a, b, exact_bytes=False):
    (sa, ia, fa, _), (sb, ib, fb, _) = a, b
    for f in JOB_FIELDS:
        assert getattr(sa, f) == getattr(sb, f), f
    assert sa.results["n_rows"] == sb.results["n_rows"]
    for c in sa.results["sample"]:
        np.testing.assert_array_equal(sa.results["sample"][c],
                                      sb.results["sample"][c])
    np.testing.assert_array_equal(ia, ib)
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        np.testing.assert_array_equal(x, y)
    if exact_bytes:
        assert sa.bytes_read == sb.bytes_read
    else:
        np.testing.assert_allclose(sa.bytes_read, sb.bytes_read,
                                   rtol=BYTES_RTOL)


@pytest.mark.parametrize("case", ["plain_2", "plain_3", "plain_4",
                                  "failover_4", "corrupt_4"])
def test_run_job_with_mesh_matches_reference(eager, case):
    j, t = eager
    kind, n_dev = case.split("_")
    n_dev = int(n_dev)
    flt = ("visitDate", LOS[1], LOS[1] + 2500)
    jquery = jq.HailQuery(filter=flt, projection=PROJ)
    tquery = q.HailQuery(filter=flt, projection=PROJ)
    _no_lo_on_a_minimum(t, [tquery])
    kw = {"fail_node_at": 0.5} if kind == "failover" else {}
    if kind == "corrupt":
        # a block of the third split — in mid-wave at n_dev = 4
        plan = q.plan(t, tquery)
        third = hail_splits(t, plan, 4)[2].block_ids[0]
        rid = int(plan.replica_for_block[third])
        jfault.FaultInjector(j, seed=SEED).corrupt_chunk(rid, third,
                                                         "visitDate")
        fault.FaultInjector(t, seed=SEED).corrupt_chunk(rid, third,
                                                        "visitDate")
    want = _job("jax", j, jquery, **kw)
    got = _job("torch", t, tquery, mesh=_cpu_mesh(n_dev), **kw)
    _same_job(want, got)
    assert _nonzero(got[3]) == _nonzero(_sharded_counts(
        want[3], want[3]["hail_read"], n_dev))
    if kind == "corrupt":
        assert got[0].blocks_quarantined == 1 and got[0].corrupt_retries == 1
    assert_same(jax_state(j), st.store_to_numpy(t))


def test_run_job_with_mesh_equals_the_unsharded_port(raw):
    """The port's sharded job against its own unsharded job on twin
    stores: the same stats, row ids, fractions and exact bytes; a (1,)
    mesh and a (1, 1) host mesh take the unsharded path, counters and
    all."""
    flt = ("visitDate", LOS[2], LOS[2] + 1500)
    query = q.HailQuery(filter=flt, projection=PROJ)
    _, a = _eager(raw)
    _, b = _eager(raw)
    base = _job("torch", a, query)
    _same_job(base, _job("torch", b, query, mesh=_cpu_mesh(4)),
              exact_bytes=True)
    for mesh in (_cpu_mesh(1), make_host_mesh(CPU)):
        one = _job("torch", b, query, mesh=mesh)
        _same_job(base, one, exact_bytes=True)
        assert one[3] == base[3]


def test_adaptive_jobs_with_mesh_match_reference(raw):
    """A lazy store converging over four adaptive jobs read in waves: the
    piggyback builds commit between a split's gather and its wave's launch,
    and the full-scan sequence, row ids and final store equal the JAX
    package's unsharded run."""
    j, t = _lazy(raw)
    flt = ("visitDate", LOS[3], LOS[3] + 900)
    jquery = jq.HailQuery(filter=flt, projection=PROJ)
    tquery = q.HailQuery(filter=flt, projection=PROJ)
    curve = []
    for _ in range(4):
        want = _job("jax", j, jquery,
                    adaptive=jmr.AdaptiveConfig(offer_rate=0.25))
        got = _job("torch", t, tquery, mesh=_cpu_mesh(4),
                   adaptive=mr.AdaptiveConfig(offer_rate=0.25))
        _same_job(want, got)
        assert _nonzero(got[3]) == _nonzero(_sharded_counts(
            want[3], want[3]["hail_read"], 4))
        curve.append(got[0].full_scan_blocks)
    assert curve == [12, 9, 6, 3]
    assert_same(jax_state(j), st.store_to_numpy(t))


# ---------------------------------------------------------------------------
# HailServer with a mesh
# ---------------------------------------------------------------------------

TRAFFIC = [(f"tenant{i % 4}", ("visitDate", lo, lo + 300 + 10 * i),
            ("visitDate", "sourceIP")) for i, lo in enumerate(LOS)]
TRAFFIC += [("tenant1", ("sourceIP", 0, 2**28), ("sourceIP",)),
            ("tenant2", ("duration", 100, 900), ("adRevenue",))]
FLUSH_FIELDS = ("n_queries", "n_batches", "n_splits", "batch_sizes",
                "blocks_indexed", "rescheduled_tasks", "batch_of_split",
                "queries_of_split", "split_scan_modes", "failed_queries",
                "blocks_quarantined", "corrupt_retries")


def _serve(pkg, store, mesh=None, **flush_kw):
    jsmod, qmod = (jjs, jq) if pkg == "jax" else (js, q)
    cfg = {"result_cache": False}
    if mesh is not None:
        cfg["mesh"] = mesh
    srv = jsmod.HailServer(store, jsmod.ServerConfig(max_batch=8, **cfg))
    tickets = [srv.submit(qmod.HailQuery(filter=f, projection=p), tenant=tn)
               for tn, f, p in TRAFFIC]
    stats = srv.flush(**flush_kw)
    answers = [(tk.ticket_id, tk.status, tk.result.n_rows,
                {c: np.asarray(v) for c, v in tk.result.rows.items()})
               for tk in tickets]
    return stats, answers


@pytest.mark.parametrize("case", ["cold_2", "cold_4", "failover_4"])
def test_server_flush_with_mesh(raw, case):
    kind, n_dev = case.split("_")
    kw = {"fail_node_at": 0.5} if kind == "failover" else {}
    (j, t), (_, u) = _eager(raw), _eager(raw)
    _no_lo_on_a_minimum(t, [q.HailQuery(filter=f, projection=p)
                            for _, f, p in TRAFFIC[:len(LOS)]])
    want = _serve("jax", j, **kw)
    base = _serve("torch", u, **kw)
    got = _serve("torch", t, mesh=_cpu_mesh(int(n_dev)), **kw)
    for ref in (want, base):
        for f in FLUSH_FIELDS:
            assert getattr(ref[0], f) == getattr(got[0], f), f
        for a, b in zip(ref[1], got[1]):
            assert a[:3] == b[:3]
            for c in a[3]:
                np.testing.assert_array_equal(a[3][c], b[3][c])


# ---------------------------------------------------------------------------
# spmd_aggregate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def agg_inputs(raw):
    """Keys, small integer values (every partial sum an integer below
    2^24, so float32 sums are exact) and the good-row mask of one
    replica."""
    _, t = _eager(raw)
    rep = t.replicas[0]
    bad = q._bad_mask(t, 0)
    return (rep.cols["countryCode"].numpy(),
            (rep.cols["adRevenue"] % 64).numpy(), (~bad).numpy())


@pytest.fixture(scope="module")
def jax_aggregate(agg_inputs):
    """The JAX package's aggregate on a (1,) mesh, as
    test_hail_core.py::test_spmd_groupby_oracle runs it."""
    sums, cnts = jmr.spmd_aggregate(jmesh.make_mesh((1,), ("data",)),
                                    *agg_inputs, n_buckets=256)
    return np.asarray(sums), np.asarray(cnts)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_spmd_aggregate_matches_reference(agg_inputs, jax_aggregate, n_dev):
    keys, vals, mask = agg_inputs
    jsums, jcnts = jax_aggregate
    sums, cnts = mr.spmd_aggregate(
        _cpu_mesh(n_dev), torch.from_numpy(keys), torch.from_numpy(vals),
        torch.from_numpy(mask), n_buckets=256)
    assert sums.dtype == cnts.dtype == torch.float32
    np.testing.assert_array_equal(jsums, sums.numpy())
    np.testing.assert_array_equal(jcnts, cnts.numpy())
    want = np.zeros(256)
    np.add.at(want, keys[mask] % 256, vals[mask])
    np.testing.assert_array_equal(want, sums.numpy())
    np.testing.assert_array_equal(np.bincount(keys[mask] % 256,
                                              minlength=256), cnts.numpy())


def test_spmd_aggregate_rejects_uneven_buckets(agg_inputs):
    keys, vals, mask = agg_inputs
    fake = types.SimpleNamespace(shape={"data": 2})
    with pytest.raises(ValueError, match="n_buckets=255"):
        jmr.spmd_aggregate(fake, keys, vals, mask, n_buckets=255)
    with pytest.raises(ValueError, match="n_buckets=255"):
        mr.spmd_aggregate(_cpu_mesh(2), torch.from_numpy(keys),
                          torch.from_numpy(vals), torch.from_numpy(mask),
                          n_buckets=255)
