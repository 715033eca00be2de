"""The index governor and dynamic replication of the PyTorch port against
the JAX package, on the conftest shape (4 blocks x 1024 rows, partition
128, 6 nodes): budget demotions and their ``DemotionEvent``s, claim-time
hysteresis, ``add_replica`` / ``decommission_replica`` and the
``ReplicationController``'s events over a few job boundaries.

Tolerances: none.  Job counts, demotion and replication events, row-id
sets and whole store states (columns, root directories, checksums, index
flags, retired replicas, version) are bit-exact; ``bytes_read`` is a
float32 sum whose order may differ (relative 1e-6).  The port runs on the
CPU, so through the kernels' plain versions; the JAX package runs through
its plain references (``ops.use_kernels(False)``: its reader and block
sort in interpret mode are covered by test_torch_fault.py and
test_torch_server.py), once per module (module-scoped fixtures)."""
import pytest

torch = pytest.importorskip("torch")

import copy  # noqa: E402
import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import governor as jgv  # noqa: E402
from repro.core import mapreduce as jmr  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import schema as jsc  # noqa: E402
from repro.core import upload as jup  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.core import governor as gv  # noqa: E402
from repro_torch.core import mapreduce as mr  # noqa: E402
from repro_torch.core import query as q  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.core import store as st  # noqa: E402
from repro_torch.core import upload as up  # noqa: E402
from repro_torch.obs import metrics  # noqa: E402

from conftest import PART  # noqa: E402
from test_torch_slice import BYTES_RTOL, assert_same, jax_state  # noqa: E402

KEYS = ["visitDate", "sourceIP", "adRevenue"]
CPU = "cpu"
VISIT = ("visitDate", 7305, 7670)
DURATION = ("duration", 100, 900)
REVENUE = ("adRevenue", 1000, 9000)
PKGS = {"jax": (jup, jsc, jq, jmr, jgv), "torch": (up, sc, q, mr, gv)}


@pytest.fixture(scope="module", autouse=True)
def jax_plain_references():
    jops.use_kernels(False)
    yield
    jops.use_kernels(True)


def _state(name, store):
    """A snapshot of either package's store state (the JAX store's index
    flags are live numpy arrays, so its snapshot is a deep copy)."""
    return (copy.deepcopy(jax_state(store)) if name == "jax"
            else st.store_to_numpy(store))


def _upload(name, raw, lazy=False):
    pup, psc = PKGS[name][:2]
    kw = {"device": CPU} if name == "torch" else {}
    store, _ = pup.hail_upload(psc.USERVISITS, raw, () if lazy else KEYS,
                               partition_size=PART, n_nodes=6, **kw)
    return store


def _job(name, store, flt, adaptive=None):
    """run_job through the fused reader -> (JobStats, sorted row ids)."""
    _, _, pq, pmr, _ = PKGS[name]
    parts = []
    stats = pmr.run_job(
        store, pq.HailQuery(filter=flt, projection=("sourceIP",)),
        reader="kernels",
        adaptive=(None if adaptive is None
                  else pmr.AdaptiveConfig(offer_rate=adaptive)),
        on_split_complete=lambda _k, res, _w: parts.append(
            pq.collect(res)["__rowid__"]))
    return stats, np.sort(np.concatenate(parts))


def _same_jobs(a, b):
    assert len(a) == len(b)
    for (ja, ids_a), (jb, ids_b) in zip(a, b):
        for f in ("n_tasks", "full_scan_blocks", "blocks_indexed",
                  "blocks_demoted", "rescheduled_tasks"):
            assert getattr(ja, f) == getattr(jb, f), f
        assert ja.results["n_rows"] == jb.results["n_rows"]
        np.testing.assert_array_equal(ids_a, ids_b)
        np.testing.assert_allclose(ja.bytes_read, jb.bytes_read,
                                   rtol=BYTES_RTOL)


def _events(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.fixture(scope="module")
def raw(uservisits_raw):
    return uservisits_raw[1]


@pytest.fixture(scope="module")
def governed(raw):
    """Both packages: (budget) a lazy store under a 2-block budget, two
    adaptive visitDate jobs then two adRevenue jobs; (hysteresis) an eager
    store, every replica claimed, three adaptive duration jobs."""
    out = {}
    for name in PKGS:
        gvn = PKGS[name][4]
        lazy = _upload(name, raw, lazy=True)
        budget = gvn.govern(lazy, max_indexed_blocks=2)
        jobs = [_job(name, lazy, VISIT, adaptive=0.25) for _ in range(2)]
        trace = [lazy.total_indexed_blocks()]
        for _ in range(2):
            jobs.append(_job(name, lazy, REVENUE, adaptive=0.25))
            trace.append(lazy.total_indexed_blocks())
        eager = _upload(name, raw)
        hyst = gvn.govern(eager, claim_miss_jobs=2)
        claims = []
        for _ in range(3):
            claims.append(_job(name, eager, DURATION, adaptive=0.25))
        out[name] = dict(lazy=lazy, budget=budget, jobs=jobs, trace=trace,
                         eager=eager, hyst=hyst, claims=claims)
    return out


def _task_shape(pkg_mr, job):
    """``job_tasks``'s scheduler tasks without their measured walls."""
    return [(task.task_id, task.preferred_nodes, task.index_build_s > 0,
             task.rekey_s > 0) for task in pkg_mr.job_tasks(job)]


def test_budget_demotions_match_jax(governed):
    j, t = governed["jax"], governed["torch"]
    _same_jobs(j["jobs"], t["jobs"])
    for (ja, _), (ta, _) in zip(j["jobs"], t["jobs"]):
        assert _task_shape(jmr, ja) == _task_shape(mr, ta)
    assert any(task.rekey_s > 0 for job, _ in t["jobs"]
               for task in mr.job_tasks(job))
    assert _events(j["budget"].events) == _events(t["budget"].events)
    assert j["trace"] == t["trace"]
    # the budget holds and the adRevenue jobs paid for room with demotions
    assert max(t["trace"]) <= 2
    assert t["budget"].events and sum(
        job.blocks_demoted for job, _ in t["jobs"][2:]) > 0


def test_budget_store_state_matches_jax(governed):
    assert_same(jax_state(governed["jax"]["lazy"]),
                st.store_to_numpy(governed["torch"]["lazy"]))


def test_claim_hysteresis_matches_jax(governed):
    j, t = governed["jax"], governed["torch"]
    _same_jobs(j["claims"], t["claims"])
    assert _events(j["hyst"].events) == _events(t["hyst"].events)
    # the first duration job is a probe: nothing demoted; the second
    # re-claims the LRU replica and starts building on it
    demoted = [job.blocks_demoted for job, _ in t["claims"]]
    assert demoted[0] == 0 and demoted[1] == 4
    assert [e.blocks_dropped for e in t["hyst"].events] == [4]
    assert t["eager"].replica_for("duration") is not None
    assert_same(jax_state(j["eager"]), st.store_to_numpy(t["eager"]))


def test_access_log_matches_jax(governed):
    for store in ("lazy", "eager"):
        a = governed["jax"][store].access_log
        b = governed["torch"][store].access_log
        assert (a.clock, a.job_clock) == (b.clock, b.job_clock)
        assert {k: dataclasses.astuple(v) for k, v in a.counts.items()} == \
            {k: dataclasses.astuple(v) for k, v in b.counts.items()}
        assert a.miss_jobs == b.miss_jobs


@pytest.fixture(scope="module")
def replicated(raw):
    """Both packages, on an eager store: add a replica, read through it,
    decommission it; and a refused decommission."""
    out = {}
    for name in PKGS:
        store = _upload(name, raw)
        rid = store.add_replica(n_nodes=6)
        added = _state(name, store)
        job = _job(name, store, DURATION, adaptive=0.5)
        dropped = store.decommission_replica(rid)
        retired = _state(name, store)
        store.quarantine_block(0, 1)
        store.quarantine_block(1, 1)
        with pytest.raises(ValueError, match="last healthy copy"):
            store.decommission_replica(2)
        out[name] = dict(store=store, rid=rid, added=added, job=job,
                         dropped=dropped, retired=retired)
    return out


def test_add_replica_matches_jax(replicated):
    j, t = replicated["jax"], replicated["torch"]
    assert j["rid"] == t["rid"] == 3
    assert_same(j["added"], t["added"])
    new = t["added"]["replicas"][3]
    assert new["sort_key"] is None and not new["indexed"].any()
    assert not new["mins"].any()


def test_added_replica_is_claimed_and_decommissioned_like_jax(replicated):
    j, t = replicated["jax"], replicated["torch"]
    _same_jobs([j["job"]], [t["job"]])
    assert t["job"][0].blocks_indexed == 2
    assert j["dropped"] == t["dropped"] == 2
    assert_same(j["retired"], t["retired"])
    rep = t["store"].replicas[3]
    assert rep.retired and rep.cols == {} and rep.mins is None
    assert t["store"].live_replica_ids() == [0, 1, 2]


def test_add_replica_unsorts_every_donor(raw):
    """A replica added while the first choice of a block is quarantined
    clones that block from the next healthy replica: one sort per donor,
    and the same upload order whichever replica donates."""
    store = _upload("torch", raw)
    store.quarantine_block(0, 2)
    from repro_torch.kernels import ops
    with ops.stats_scope() as s:
        rid = store.add_replica()
    fresh = _upload("torch", raw, lazy=True).replicas[0]
    for c, v in fresh.cols.items():
        assert torch.equal(store.replicas[rid].cols[c], v), c
        assert torch.equal(store.replicas[rid].checksums[c],
                           fresh.checksums[c]), c
    assert s.dispatches["replicas_added"] == 1


@pytest.fixture(scope="module")
def controlled(raw):
    """Both packages: a ReplicationController on an eager store, ticked by
    four jobs — a duration job that misses (adds a replica), then
    visitDate jobs that leave the other replicas cold."""
    out = {}
    for name in PKGS:
        gvn = PKGS[name][4]
        store = _upload(name, raw)
        # a registry of its own, isolated from other tests' collectors
        reg = (jmetrics if name == "jax" else metrics).MetricsRegistry()
        ctl = gvn.replicate(store, max_replication=4, hot_misses=1,
                            cold_ticks=2, n_nodes=6, registry=reg)
        jobs = [_job(name, store, DURATION)]
        live = [list(store.live_replica_ids())]
        for _ in range(3):
            jobs.append(_job(name, store, VISIT))
            live.append(list(store.live_replica_ids()))
        ctl.detach()
        out[name] = dict(store=store, ctl=ctl, jobs=jobs, live=live)
    return out


def test_replication_events_match_jax(controlled):
    j, t = controlled["jax"], controlled["torch"]
    assert _events(j["ctl"].events) == _events(t["ctl"].events)
    assert j["live"] == t["live"]
    kinds = [e.kind for e in t["ctl"].events]
    assert kinds[0] == "add" and "decommission" in kinds
    assert t["ctl"].ticks == 4
    _same_jobs(j["jobs"], t["jobs"])


def test_replicated_store_matches_jax(controlled):
    assert_same(jax_state(controlled["jax"]["store"]),
                st.store_to_numpy(controlled["torch"]["store"]))
