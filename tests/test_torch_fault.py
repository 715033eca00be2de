"""Corruption resilience of the PyTorch port against the JAX package, on
the conftest shape (4 blocks x 1024 rows, partition 128, 6 nodes): the
seeded ``FaultInjector``'s events and the stores they leave, detection and
quarantine on the read path, the scrubber's verification and
index-preserving repair, an unrecoverable block, and copy on write on a
lazy store whose replicas share their tensors.

Tolerances: none.  Events, store states (columns, root directories,
checksums, index flags, quarantine set, version), row-id sets, job and
scrubber counts are bit-exact; ``bytes_read`` is a float32 sum whose order
may differ (relative 1e-6).  The port runs on the CPU, so through the
kernels' plain versions; the JAX package runs its Pallas kernels in
interpret mode, once per module (module-scoped fixtures)."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from repro.core import fault as jfault  # noqa: E402
from repro.core import mapreduce as jmr  # noqa: E402
from repro.core import query as jq  # noqa: E402
from repro.core import schema as jsc  # noqa: E402
from repro.core import upload as jup  # noqa: E402
from repro.runtime import scrubber as jscrub  # noqa: E402
from repro_torch.core import fault  # noqa: E402
from repro_torch.core import mapreduce as mr  # noqa: E402
from repro_torch.core import query as q  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.core import store as st  # noqa: E402
from repro_torch.core import upload as up  # noqa: E402
from repro_torch.runtime import scrubber  # noqa: E402

from conftest import PART  # noqa: E402
from test_torch_slice import BYTES_RTOL, assert_same, jax_state  # noqa: E402

KEYS = ["visitDate", "sourceIP", "adRevenue"]
CPU = "cpu"
SEED = 5
FLT = ("visitDate", 7305, 7670)


def _pair(raw, lazy=False):
    keys = () if lazy else KEYS
    j, _ = jup.hail_upload(jsc.USERVISITS, raw, keys, partition_size=PART,
                           n_nodes=6)
    t, _ = up.hail_upload(sc.USERVISITS, raw, keys, partition_size=PART,
                          n_nodes=6, device=CPU)
    return j, t


def _queries(flt=FLT):
    return (jq.HailQuery(filter=flt, projection=("sourceIP",)),
            q.HailQuery(filter=flt, projection=("sourceIP",)))


def _faults(inj):
    """Every fault kind once, with and without a named column."""
    return [inj.corrupt_chunk(0, 1, "visitDate"), inj.corrupt_root(1, 2),
            inj.truncate_checksums(2, 3), inj.corrupt_column(1, 0),
            inj.corrupt_chunk(2, 2), *inj.corrupt_replicas(3, 2),
            inj.kill_node(4)]


def _events(events):
    return [dataclasses.astuple(e) for e in events]


def _run(pkg_mr, pkg_q, store, query):
    """run_job through the fused reader -> (JobStats, sorted row ids)."""
    parts = []
    stats = pkg_mr.run_job(
        store, query, reader="kernels",
        on_split_complete=lambda _k, res, _w: parts.append(
            pkg_q.collect(res)["__rowid__"]))
    return stats, np.sort(np.concatenate(parts))


def _job(a, b):
    (a, ids_a), (b, ids_b) = a, b
    for f in ("n_tasks", "blocks_quarantined", "corrupt_retries",
              "full_scan_blocks", "rescheduled_tasks"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.results["n_rows"] == b.results["n_rows"]
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(a.bytes_read, b.bytes_read, rtol=BYTES_RTOL)


@pytest.fixture(scope="module")
def raw(uservisits_raw):
    return uservisits_raw[1]


@pytest.fixture(scope="module")
def repair_run(raw):
    """Both packages: three blocks corrupted on three replicas, one query
    that finds the visitDate replica's fault on its read path, then one
    scrubber tick that finds the other two and repairs all three."""
    out = {}
    (j, t), (jqq, tq) = _pair(raw), _queries()
    for name, pkg_fault, pkg_mr, pkg_q, pkg_scrub, store, query in (
            ("jax", jfault, jmr, jq, jscrub, j, jqq),
            ("torch", fault, mr, q, scrubber, t, tq)):
        inj = pkg_fault.FaultInjector(store, seed=SEED)
        events = [inj.corrupt_chunk(0, 1, "visitDate"), inj.corrupt_root(1, 2),
                  inj.truncate_checksums(2, 3)]
        verified = [[store.verify_block(r, b) for b in range(4)]
                    for r in range(3)]
        job = _run(pkg_mr, pkg_q, store, query)
        after_read = sorted(store.namenode.quarantined)
        scrub = pkg_scrub.Scrubber(
            store, pkg_scrub.ScrubConfig(blocks_per_tick=12)).attach()
        stats = dataclasses.replace(scrub.tick(), wall_s=0.0)
        again = _run(pkg_mr, pkg_q, store, query)
        out[name] = dict(store=store, events=_events(events),
                         verified=verified, job=job, after_read=after_read,
                         scrub=stats, again=again)
    return out


def test_injector_events_and_verification_match_jax(repair_run):
    j, t = repair_run["jax"], repair_run["torch"]
    assert j["events"] == t["events"]
    assert j["verified"] == t["verified"]
    # exactly the three corrupted (replica, block) pairs fail verification
    bad = {(r, b) for r in range(3) for b in range(4)
           if not t["verified"][r][b]}
    assert bad == {(0, 1), (1, 2), (2, 3)}


def test_read_path_quarantine_matches_jax(repair_run):
    j, t = repair_run["jax"], repair_run["torch"]
    _job(j["job"], t["job"])
    assert t["job"][0].blocks_quarantined == 1
    node = int(t["store"].replicas[0].nodes[1])
    assert j["after_read"] == t["after_read"] == [(1, node)]


def test_scrubber_stats_match_jax(repair_run):
    j, t = repair_run["jax"], repair_run["torch"]
    assert dataclasses.asdict(j["scrub"]) == dataclasses.asdict(t["scrub"])
    assert (t["scrub"].blocks_verified, t["scrub"].blocks_quarantined,
            t["scrub"].blocks_repaired) == (11, 2, 3)


def test_repaired_store_matches_jax_and_fresh_upload(repair_run, raw):
    j, t = repair_run["jax"]["store"], repair_run["torch"]["store"]
    got = st.store_to_numpy(t)
    assert_same(jax_state(j), got)
    assert got["quarantined"] == []
    fresh = st.store_to_numpy(_pair(raw)[1])
    for r_got, r_fresh in zip(got["replicas"], fresh["replicas"]):
        for part in ("cols", "checksums"):
            assert_same(r_fresh[part], r_got[part])
        np.testing.assert_array_equal(r_fresh["mins"], r_got["mins"])


def test_repaired_store_answers_like_before(repair_run):
    j, t = repair_run["jax"], repair_run["torch"]
    _job(j["again"], t["again"])
    assert t["again"][0].blocks_quarantined == 0
    # the faulty read failed over to the same rows the repaired store gives
    np.testing.assert_array_equal(t["job"][1], t["again"][1])


def test_unrecoverable_block_raises_in_both(raw):
    """All three replicas of block 0 corrupt: a typed failure in both
    packages, never rows; repair then counts it unrepairable."""
    stores = _pair(raw)
    states = []
    for pkg_fault, pkg_mr, store, query in zip(
            (jfault, fault), (jmr, mr), stores, _queries()):
        inj = pkg_fault.FaultInjector(store, seed=SEED)
        events = _events(inj.corrupt_replicas(0, 3, "visitDate"))
        with pytest.raises(pkg_fault.UnrecoverableDataError):
            pkg_mr.run_job(store, query, reader="kernels")
        rs = store.repair_blocks()
        states.append((events, sorted(store.namenode.quarantined),
                       rs.blocks_repaired, rs.unrepairable, store.version))
    assert states[0] == states[1]
    assert len(states[1][1]) == 3 and states[1][3] == 3


@pytest.mark.parametrize("lazy", [False, True])
def test_every_fault_kind_leaves_the_same_store(raw, lazy):
    j, t = _pair(raw, lazy)
    ej = _faults(jfault.FaultInjector(j, seed=SEED))
    et = _faults(fault.FaultInjector(t, seed=SEED))
    assert _events(ej) == _events(et)
    assert_same(jax_state(j), st.store_to_numpy(t))


def test_lazy_fault_copies_on_write(raw):
    """Lazy replicas share their column and root tensors: a fault on one
    replica leaves the others (and every tensor handed out before) as
    they were."""
    _, t = _pair(raw, lazy=True)
    shared = t.replicas[0].cols["visitDate"]
    assert t.replicas[1].cols["visitDate"] is shared
    before = shared.clone()
    mins_before = t.replicas[0].mins.clone()
    inj = fault.FaultInjector(t, seed=SEED)
    inj.corrupt_chunk(1, 2, "visitDate")
    inj.corrupt_root(1, 0)
    inj.truncate_checksums(1, 3, "visitDate")
    assert torch.equal(shared, before)
    for rid in (0, 2):
        rep = t.replicas[rid]
        assert rep.cols["visitDate"] is shared
        assert torch.equal(rep.mins, mins_before)
        assert t.verify_block(rid, 2) and t.verify_block(rid, 3)
    assert not torch.equal(t.replicas[1].cols["visitDate"], before)
    assert not t.verify_block(1, 2) and not t.verify_block(1, 3)


def test_lazy_repair_matches_jax(raw):
    """An unindexed block is repaired in upload order (one sort, by
    __rowid__) and the rest of the lazy store keeps its sharing."""
    j, t = _pair(raw, lazy=True)
    jq_, tq = _queries()
    for pkg_fault, pkg_mr, store, query in ((jfault, jmr, j, jq_),
                                            (fault, mr, t, tq)):
        pkg_fault.FaultInjector(store, seed=SEED).corrupt_chunk(
            0, 2, "sourceIP")
        pkg_mr.run_job(store, query, reader="kernels")
        assert store.repair_blocks().blocks_repaired == 1
    assert_same(jax_state(j), st.store_to_numpy(t))
    fresh = _pair(raw, lazy=True)[1]
    for c, v in fresh.replicas[0].cols.items():
        assert torch.equal(t.replicas[0].cols[c], v)
    assert t.replicas[1].cols["sourceIP"] is t.replicas[2].cols["sourceIP"]
