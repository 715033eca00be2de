"""The two cache tiers of the PyTorch port against the JAX package: one
seeded access trace given to both packages' ``BlockCache`` (SLRU with
TinyLFU admission, block-granular invalidation) and ``ResultCache``
(exact and subsumed hits, LRU eviction, store-version keys) must give the
same hits, misses, evictions, admission rejects, promotions,
invalidations, partial invalidations, subsumed hits, resident bytes and
resident keys after every step; plus the two read-only contracts on a real
server: a block-cache hit's tensors are bit-equal before and after a flush
that reuses them, and writing to an answer the result cache served
raises.

Tolerances: none — every count, byte total, key and row is exact.  No
kernel runs here; the traces are host-side cache traffic over arrays made
from a seed with numpy."""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import types  # noqa: E402
import zlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import cache as jcache  # noqa: E402
from repro.core import governor as jgv  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core import governor as gv  # noqa: E402
from repro_torch.core import query as q  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.core import upload as up  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime.jobserver import HailServer, ServerConfig  # noqa: E402

from conftest import PART  # noqa: E402

ROWS = 64
COLS = ("visitDate", "sourceIP")
CACHE_COUNTERS = ("cache_hits", "cache_misses", "cache_admission_rejects",
                  "result_cache_hits", "result_cache_misses")


def _block_trace(seed: int, n: int = 400):
    """(op, key, n_blocks) steps over 3 replicas x 8 blocks: gets (a miss
    is followed by a put, as the gather does), hot keys reused, scans of
    one-touch keys, block- and replica-granular invalidations."""
    r = np.random.default_rng(seed)
    hot = [(int(r.integers(3)), tuple(sorted(r.choice(8, int(r.integers(1, 4)),
                                                      replace=False).tolist())),
            COLS[int(r.integers(2))], COLS) for _ in range(6)]
    steps = []
    for i in range(n):
        u = r.random()
        if u < 0.55:
            key = hot[int(r.integers(len(hot)))]
        elif u < 0.9:                      # a one-touch scan key
            key = (int(r.integers(3)), (int(r.integers(8)), 8 + i), COLS[0],
                   COLS)
        elif u < 0.97:
            steps.append(("invalidate_blocks", int(r.integers(3)),
                          (int(r.integers(8)),)))
            continue
        else:
            steps.append(("invalidate_replica", int(r.integers(3)), ()))
            continue
        steps.append(("get", key, ()))
    return steps


def _value(key, lib):
    """A gather-shaped value for ``key``: (keys, stacked projection, bad
    mask, root directories), rows made from the key with numpy."""
    nb = len(key[1])
    r = np.random.default_rng(zlib.crc32(repr(key).encode()))
    parts = (r.integers(0, 1 << 30, (nb, ROWS)).astype(np.int32),
             r.integers(0, 1 << 30, (nb, ROWS, len(key[3]))).astype(np.int32),
             r.random((nb, ROWS)) < 0.1,
             r.integers(0, 1 << 30, (nb, ROWS // 16)).astype(np.int32))
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return tuple(conv(p) for p in parts)


def _heat_log(pkg_gv):
    log = pkg_gv.AccessLog()
    for rid, col, hits, misses in [(0, "visitDate", 30, 2), (1, "sourceIP",
                                                             5, 9),
                                   (2, "visitDate", 0, 1)]:
        log.record(rid, col, hits, misses)
    return log


def _snapshot(c):
    return (dataclasses.astuple(c.stats), list(c._probation),
            list(c._protected), c.recount())


def _drive_block(pkg_cache, pkg_gv, pkg_ops, lib, capacity, resistant,
                 steps):
    store = types.SimpleNamespace(access_log=_heat_log(pkg_gv),
                                  block_cache=None)
    c = pkg_cache.BlockCache(capacity, scan_resistant=resistant).attach(store)
    snaps, hits = [], []
    with pkg_ops.stats_scope() as s:
        for op, a, b in steps:
            if op == "get":
                got = c.get(a)
                if got is None:
                    c.put(a, _value(a, lib))
                else:
                    hits.append([np.asarray(v) for v in got])
            elif op == "invalidate_blocks":
                c.invalidate_blocks(a, b)
            else:
                c.invalidate_replica(a)
            snaps.append(_snapshot(c))
    return snaps, hits, {k: s.dispatches[k] for k in CACHE_COUNTERS}


@pytest.mark.parametrize("resistant", [True, False])
@pytest.mark.parametrize("capacity", [None, 6_000, 20_000])
def test_block_cache_trace_matches_jax(capacity, resistant):
    steps = _block_trace(seed=capacity or 1)
    js, jh, jd = _drive_block(jcache, jgv, jops, "jax", capacity, resistant,
                              steps)
    ts, th, td = _drive_block(cache, gv, ops, "torch", capacity, resistant,
                              steps)
    assert js == ts                       # stats, keys, bytes at every step
    assert jd == td
    assert len(jh) == len(th)
    for a, b in zip(jh, th):              # every hit serves the same arrays
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    stats = ts[-1][0]
    if capacity is not None:              # the trace exercises the policy
        assert stats[2] > 0 and stats[5] > 0   # evictions, partial re-keys
        assert (stats[3] > 0) == resistant     # admission rejects


def test_block_cache_bytes_count_tensors_and_arrays():
    val = _value((0, (1, 2), COLS[0], COLS), "torch")
    want = sum(v.numel() * v.element_size() for v in val)
    assert cache._nbytes(val) == want == jcache._nbytes(
        _value((0, (1, 2), COLS[0], COLS), "jax"))
    assert cache._nbytes({"a": np.zeros(5, np.int64)}) == 40


def _result_trace(seed: int, n: int = 200):
    r = np.random.default_rng(seed)
    steps = []
    for i in range(n):
        u = r.random()
        proj = (("visitDate", "sourceIP") if r.random() < 0.8
                else ("sourceIP",))
        lo = int(r.integers(7000, 11500))
        hi = lo + int(r.integers(0, 400))
        if u < 0.05:
            steps.append(("invalidate", None))
        elif u < 0.12:
            steps.append(("bump", None))
        else:
            steps.append(("lookup", ("visitDate", lo, hi, proj)))
    return steps


def _rows(col_range, proj, seed):
    r = np.random.default_rng(seed)
    lo, hi = col_range
    n = int(r.integers(0, 60))
    rows = {c: r.integers(0, 1 << 30, n).astype(np.int32) for c in proj}
    if "visitDate" in proj:
        rows["visitDate"] = np.sort(r.integers(lo, hi + 1, n)).astype(
            np.int32)
    rows["__rowid__"] = np.sort(r.choice(1 << 20, n, replace=False)).astype(
        np.int32)
    return rows


def _drive_result(pkg_cache, pkg_ops, capacity, steps):
    c = pkg_cache.ResultCache(capacity)
    version, out = 0, []
    with pkg_ops.stats_scope() as s:
        for k, (op, arg) in enumerate(steps):
            if op == "invalidate":
                c.invalidate_store()
            elif op == "bump":
                version += 1
            else:
                col, lo, hi, proj = arg
                ent = c.lookup(col, lo, hi, proj, version)
                if ent is None:
                    c.put(col, lo, hi, proj, version,
                          _rows((lo, hi), proj, k), ((0, 3, 1), (2, 0, 1)))
                    out.append(None)
                else:
                    out.append((ent.n_rows, ent.attribution,
                                {c_: v.copy() for c_, v in ent.rows.items()}))
            out.append((dataclasses.astuple(c.stats), c.keys()))
    return out, {k: s.dispatches[k] for k in CACHE_COUNTERS}


@pytest.mark.parametrize("capacity", [None, 3_000])
def test_result_cache_trace_matches_jax(capacity):
    steps = _result_trace(seed=capacity or 2)
    (jo, jd), (to, td) = (_drive_result(jcache, jops, capacity, steps),
                          _drive_result(cache, ops, capacity, steps))
    assert jd == td
    assert len(jo) == len(to)
    for a, b in zip(jo, to):
        if isinstance(a, tuple) and len(a) == 3:
            assert a[:2] == b[:2]
            assert set(a[2]) == set(b[2])
            for c in a[2]:
                np.testing.assert_array_equal(a[2][c], b[2][c])
        else:
            assert a == b
    stats = to[-1][0]
    assert stats[0] > 0 and stats[2] > 0           # hits, subsumed hits
    if capacity is not None:
        assert stats[3] > 0                        # evictions


@pytest.fixture(scope="module")
def served(uservisits_raw):
    store, _ = up.hail_upload(sc.USERVISITS, uservisits_raw[1],
                              ["visitDate", "sourceIP", "adRevenue"],
                              partition_size=PART, n_nodes=6, device="cpu")
    return store


def _submit(server, ranges):
    return [server.submit(q.HailQuery(filter=("visitDate", lo, hi),
                                      projection=("visitDate", "sourceIP")),
                          tenant=f"tenant{i % 4}")
            for i, (lo, hi) in enumerate(ranges)]


def test_block_cache_hits_stay_bit_equal_through_a_flush(served):
    """Tier 1 holds the tensors the gather made; a warm flush reads them
    through the fused reader and leaves them as they were."""
    served.block_cache = served.result_cache = None
    server = HailServer(served, ServerConfig(max_batch=4, result_cache=False))
    ranges = [(7300, 7700), (8000, 8400), (9000, 9050), (11000, 11990)]
    _submit(server, ranges)
    server.flush()
    held = {k: tuple(v.clone() for v in ent[0])
            for seg in (server.cache._probation, server.cache._protected)
            for k, ent in seg.items()}
    assert held
    _submit(server, ranges)
    stats = server.flush()
    assert stats.cache_hits == len(held) and stats.cache_misses == 0
    for seg in (server.cache._probation, server.cache._protected):
        for k, ent in seg.items():
            for before, now in zip(held[k], ent[0]):
                assert torch.equal(before, now)


def test_result_cache_answers_are_read_only(served):
    """Tier 2 freezes the host answers it holds: writing to a served
    answer raises, exact or subsumed, and the next hit is unchanged."""
    served.block_cache = served.result_cache = None
    server = HailServer(served, ServerConfig(max_batch=4))
    first = _submit(server, [(7300, 7700)])[0]
    server.flush()
    hit, sub = _submit(server, [(7300, 7700), (7400, 7500)])
    stats = server.flush()
    assert stats.result_cache_hits == 2 and stats.n_splits == 0
    assert server.result_cache.stats.subsumed_hits == 1
    for t in (first, hit, sub):
        for v in t.result.rows.values():
            with pytest.raises(ValueError, match="read-only"):
                v[:1] = 0
    again = _submit(server, [(7300, 7700)])[0]
    server.flush()
    for c, v in first.result.rows.items():
        np.testing.assert_array_equal(again.result.rows[c], v)
