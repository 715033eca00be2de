"""The serving layer of the PyTorch port against the JAX package, on the
conftest shape (4 blocks x 1024 rows, partition 128, 6 nodes): a
mixed-tenant ``HailServer`` flush (shared-scan batches, a full-scan
column, a filterless query) and its warm re-flush from the result cache,
admission quotas, a flush that loses a node and one that reads a corrupt
block (quarantine on read, repair at the flush boundary), and the
``ServerFrontend``'s batch decisions, simulated latencies and
``explain()`` records.

Tolerances: none, except that walls are not compared.  Per-ticket rows,
``FlushStats`` counts and per-split lists, cache statistics, reader
launch counts, admission errors, store states and every non-wall field of
``explain()`` are bit-exact; ``bytes_read`` is a float32 sum whose order
may differ (relative 1e-6).  The frontend's latencies come from measured
split walls, so for that test (only) both servers' ``flush`` is wrapped
to overwrite the walls with the same fixed durations, after which the
simulated latencies and the explain decompositions are exact as well.
Every ticket's row ids are also held to the rows the data itself selects
(the conftest oracle), and the query ranges start on no partition
minimum, where the JAX package's index scan and the port's differ
(test_torch_kernels.py pins that difference).

The port runs on the CPU, so through the kernels' plain versions; the JAX
package runs its Pallas kernels in interpret mode, once per module
(module-scoped fixtures)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import fault as jfault  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import schema as jsc  # noqa: E402
from repro.core import upload as jup  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.runtime import jobserver as jjs  # noqa: E402
from repro.runtime import scrubber as jscrub  # noqa: E402
from repro_torch.core import fault  # noqa: E402
from repro_torch.core import query as q  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.core import store as st  # noqa: E402
from repro_torch.core import upload as up  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import jobserver as js  # noqa: E402
from repro_torch.runtime import scrubber  # noqa: E402

from conftest import PART  # noqa: E402
from test_torch_slice import BYTES_RTOL, assert_same, jax_state  # noqa: E402

KEYS = ["visitDate", "sourceIP", "adRevenue"]
PKGS = {"jax": (jup, jsc, jq, jjs, jops, jfault, jscrub),
        "torch": (up, sc, q, js, ops, fault, scrubber)}
VISIT_PROJ = ("visitDate", "sourceIP")
# (tenant, filter, projection): three shared-scan groups, a full-scan
# column and a filterless query
TRAFFIC = [(f"tenant{i % 4}", ("visitDate", lo, lo + 155 + 10 * i),
            VISIT_PROJ)
           for i, lo in enumerate([7013, 7413, 8013, 9013, 10013, 10513])]
TRAFFIC += [("tenant2", ("sourceIP", 0, 2**28), ("sourceIP",)),
            ("tenant3", ("sourceIP", 2**30, 2**30 + 2**27), ("sourceIP",)),
            ("tenant0", ("duration", 100, 900), ("adRevenue",)),
            ("tenant1", None, ("countryCode",))]
COUNTS = ("n_queries", "n_batches", "n_splits", "batch_sizes",
          "blocks_indexed", "blocks_demoted", "rescheduled_tasks",
          "batch_of_split", "queries_of_split", "split_scan_modes",
          "failed_queries", "cache_hits", "cache_misses",
          "result_cache_hits", "result_cache_misses", "blocks_quarantined",
          "corrupt_retries")
READER = ("hail_read", "hail_read_batch", "index_scan_blocks",
          "full_scan_blocks", "verify_blocks", "verify_root")


def _upload(name, raw):
    pup, psc = PKGS[name][:2]
    kw = {"device": "cpu"} if name == "torch" else {}
    store, _ = pup.hail_upload(psc.USERVISITS, raw, KEYS,
                               partition_size=PART, n_nodes=6, **kw)
    return store


def _submit(name, server, traffic=TRAFFIC):
    pq = PKGS[name][2]
    return [server.submit(pq.HailQuery(filter=f, projection=p), tenant=t)
            for t, f, p in traffic]


def _flush(name, server, **kw):
    """-> (FlushStats, reader counters of the flush)."""
    with PKGS[name][4].stats_scope() as s:
        stats = server.flush(**kw)
    return stats, {k: s.dispatches[k] for k in READER}


def _answers(tickets):
    return [(t.ticket_id, t.tenant, t.status, t.result.n_rows,
             t.result.batch_size, t.result.n_splits, t.result.from_cache,
             {c: np.asarray(v) for c, v in t.result.rows.items()})
            for t in tickets]


def _same_answers(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[:7] == y[:7]
        assert set(x[7]) == set(y[7])
        for c in x[7]:
            assert x[7][c].dtype == y[7][c].dtype, c
            np.testing.assert_array_equal(x[7][c], y[7][c])


def _same_flush(a, b):
    (sa, da), (sb, db) = a, b
    for f in COUNTS:
        assert getattr(sa, f) == getattr(sb, f), f
    assert set(sa.query_done_s) == set(sb.query_done_s)
    np.testing.assert_allclose(sa.bytes_read, sb.bytes_read, rtol=BYTES_RTOL)
    assert da == db


@pytest.fixture(scope="module")
def raw(uservisits_raw):
    return uservisits_raw[1]


@pytest.fixture(scope="module")
def served(raw):
    """Both packages: the mixed flush, its warm re-flush, a flush that
    loses a node, and a flush over a corrupt block with a scrubber."""
    out = {}
    for name in PKGS:
        _, _, _, pjs, _, pfault, pscrub = PKGS[name]
        store = _upload(name, raw)
        server = pjs.HailServer(store, pjs.ServerConfig(max_batch=4))
        cold_t = _submit(name, server)
        cold = _flush(name, server)
        warm_t = _submit(name, server)
        warm = _flush(name, server)
        store.block_cache = store.result_cache = None
        server = pjs.HailServer(store, pjs.ServerConfig(max_batch=4))
        fail_t = _submit(name, server, TRAFFIC[:6])
        fail = _flush(name, server, fail_node_at=0.5)
        dead_after = set(store.namenode.dead)
        store.block_cache = store.result_cache = None
        pfault.FaultInjector(store, seed=3).corrupt_chunk(0, 2, "sourceIP")
        pscrub.Scrubber(store).attach()
        server = pjs.HailServer(store, pjs.ServerConfig(max_batch=4))
        bad_t = _submit(name, server, TRAFFIC[:6])
        bad = _flush(name, server)
        out[name] = dict(store=store, cold_t=_answers(cold_t), cold=cold,
                         warm_t=_answers(warm_t), warm=warm,
                         fail_t=_answers(fail_t), fail=fail,
                         dead_after=dead_after, bad_t=_answers(bad_t),
                         bad=bad, explain=[t.explain() for t in cold_t])
    return out


def test_mixed_flush_matches_jax(served):
    j, t = served["jax"], served["torch"]
    _same_answers(j["cold_t"], t["cold_t"])
    _same_flush(j["cold"], t["cold"])
    stats, reads = t["cold"]
    assert stats.batch_sizes == [4, 2, 2, 1, 1]
    # one fused launch per (split, batch) of the filtered batches; the
    # filterless ticket (the last) reads through the plain reader
    filtered = [qs for qs in stats.queries_of_split
                if len(TRAFFIC) - 1 not in qs]
    assert reads["hail_read"] == reads["hail_read_batch"] == len(filtered)
    assert len(filtered) < stats.n_splits


def test_answers_equal_the_data(served, oracle_rows):
    """Each filtered ticket's row ids are the rows the data selects."""
    cols, bad = oracle_rows
    for (tenant, flt, proj), ans in zip(TRAFFIC, served["torch"]["cold_t"]):
        rows = ans[7]
        if flt is None:
            want = np.nonzero(~bad)[0]
        else:
            col, lo, hi = flt
            v = np.asarray(cols[col])
            want = np.nonzero((v >= lo) & (v <= hi) & ~bad)[0]
        np.testing.assert_array_equal(np.sort(rows["__rowid__"]), want)


def test_ranges_start_on_no_partition_minimum(served):
    store = served["torch"]["store"]
    for _, flt, _ in TRAFFIC:
        if flt is None:
            continue
        rid = store.replica_for(flt[0])
        if rid is not None:
            assert not bool((store.replicas[rid].mins == flt[1]).any())


def test_warm_flush_is_served_by_the_result_cache(served):
    j, t = served["jax"], served["torch"]
    _same_answers(j["warm_t"], t["warm_t"])
    _same_flush(j["warm"], t["warm"])
    stats, reads = t["warm"]
    # every filtered query is a result-cache hit; only the filterless one
    # scans, through the plain per-query reader
    assert stats.result_cache_hits == len(TRAFFIC) - 1
    assert reads["hail_read"] == 0
    for cold, warm in zip(t["cold_t"], t["warm_t"]):
        for c in cold[7]:
            np.testing.assert_array_equal(np.sort(cold[7][c]),
                                          np.sort(warm[7][c]))


def test_failover_flush_matches_jax(served):
    j, t = served["jax"], served["torch"]
    _same_answers(j["fail_t"], t["fail_t"])
    _same_flush(j["fail"], t["fail"])
    assert t["fail"][0].rescheduled_tasks > 0
    assert j["dead_after"] == t["dead_after"] == set()
    for cold, fail in zip(t["cold_t"], t["fail_t"]):
        np.testing.assert_array_equal(np.sort(cold[7]["__rowid__"]),
                                      np.sort(fail[7]["__rowid__"]))


def test_corrupt_flush_quarantines_and_repairs_like_jax(served):
    j, t = served["jax"], served["torch"]
    _same_answers(j["bad_t"], t["bad_t"])
    _same_flush(j["bad"], t["bad"])
    assert t["bad"][0].blocks_quarantined == 1
    for cold, bad in zip(t["cold_t"], t["bad_t"]):
        np.testing.assert_array_equal(np.sort(cold[7]["__rowid__"]),
                                      np.sort(bad[7]["__rowid__"]))
    # the boundary scrub repaired the block: the whole store matches
    assert t["store"].namenode.quarantined == set()
    assert_same(jax_state(j["store"]), st.store_to_numpy(t["store"]))


def _explained(rec, walls: bool):
    d = dataclasses.asdict(rec)
    skip = {"done_wall_s"} | ({"completion_s", "sched_wait_s", "read_s",
                              "build_s", "rekey_s", "accounted_s",
                              "accounted_fraction", "latency_s",
                              "queue_wait_s"} if not walls else set())
    for k in skip:
        d.pop(k)
    d["flush"] = {k: v for k, v in d["flush"].items()
                  if k not in ("wall_s", "modeled_s")}
    if not walls:
        # the shares come in modeled start order, which the measured walls
        # decide; without walls compare them in task order
        d["splits"] = sorted(
            ({k: v for k, v in s.items()
              if k in ("task_id", "batch_width", "index_blocks",
                       "full_blocks")} for s in d["splits"]),
            key=lambda s: s["task_id"])
    return d


def test_explain_matches_jax_apart_from_walls(served):
    for a, b in zip(served["jax"]["explain"], served["torch"]["explain"]):
        assert _explained(a, walls=False) == _explained(b, walls=False)
    rec = served["torch"]["explain"][0]
    # the second visitDate batch re-read the first one's gathers
    assert rec.outcome == "mixed" and rec.trigger == "manual"
    assert rec.accounted_fraction == pytest.approx(1.0)


def test_admission_quotas_match_jax(raw):
    got = {}
    for name in PKGS:
        pjs = PKGS[name][3]
        server = pjs.HailServer(_upload(name, raw), pjs.ServerConfig(
            max_pending_per_tenant=2, max_pending_total=5))
        pq = PKGS[name][2]
        log = []
        for tenant in ["a", "a", "a", "b", "b", "c", "c", "b"]:
            try:
                server.submit(pq.HailQuery(filter=("visitDate", 7010, 7100),
                                           projection=VISIT_PROJ),
                              tenant=tenant)
                log.append("ok")
            except pjs.AdmissionError as e:
                log.append(str(e))
        got[name] = (log, server.pending_count(), server.pending_count("b"))
    assert got["jax"] == got["torch"]
    log = got["torch"][0]
    assert log[:3] == ["ok", "ok", "tenant 'a' over quota (2 pending)"]
    assert log[6] == "server queue full (5)"


def _fixed_walls(server):
    """Wrap ``server.flush`` so its split walls are fixed durations — the
    test's only change to the program: measured walls differ between the
    packages and between runs, and the frontend's latencies are built
    from them."""
    flush = server.flush

    def fixed(*args, **kwargs):
        stats = flush(*args, **kwargs)
        stats.split_s = [0.5 + 0.25 * (i % 3)
                         for i in range(len(stats.split_s))]
        stats.build_s = [0.0] * len(stats.split_s)
        stats.demote_s = [0.0] * len(stats.split_s)
        return stats

    server.flush = fixed


@pytest.fixture(scope="module")
def fronted(raw):
    out = {}
    for name in PKGS:
        pjs, pq = PKGS[name][3], PKGS[name][2]
        server = pjs.HailServer(_upload(name, raw),
                                pjs.ServerConfig(max_batch=4))
        _fixed_walls(server)
        fe = pjs.ServerFrontend(server, pjs.FlushPolicy(
            window_s=0.3, max_batches_per_flush=2,
            weights={"tenant0": 2.0}))
        for k, (tenant, flt, proj) in enumerate(TRAFFIC * 2):
            fe.offer(pq.HailQuery(filter=flt, projection=proj),
                     tenant=tenant, at=0.1 * k)
        fe.drain()
        out[name] = fe
    return out


def test_frontend_batches_and_latencies_match_jax(fronted):
    a, b = fronted["jax"], fronted["torch"]
    assert len(a.flushes) == len(b.flushes) > 1
    for x, y in zip(a.flushes, b.flushes):
        for f in COUNTS:
            assert getattr(x, f) == getattr(y, f), f
    assert a.latencies == b.latencies
    assert (a.percentile_latency(50), a.percentile_latency(99)) == \
        (b.percentile_latency(50), b.percentile_latency(99))
    assert a.busy_until == b.busy_until
    assert [t.ticket_id for t in a.failed] == [t.ticket_id for t in b.failed]


def test_frontend_explain_matches_jax(fronted):
    a, b = fronted["jax"], fronted["torch"]
    assert sorted(a.completed) == sorted(b.completed)
    triggers = set()
    for tid in sorted(b.completed):
        ra, rb = a.completed[tid].explain(), b.completed[tid].explain()
        assert _explained(ra, walls=True) == _explained(rb, walls=True)
        triggers.add(rb.trigger)
    assert "window" in triggers
