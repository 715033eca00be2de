"""The PyTorch port's kernel layer against the JAX package: the plain
versions of the fused reader and the bitonic sort, bit for bit, the
device routing and counters of ``repro_torch.kernels.ops``, and the port's
import isolation.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these same plain versions); the
reader's indexing (one range count per block and query, tiles, 16-byte
groups with scalar heads and tails, the mask's windows and thread grid)
is modelled in numpy here and held to the plain version bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.block_sort import bitonic_sort as jax_bitonic_sort  # noqa: E402
from repro.kernels.hail_reader import hail_read_batch as jax_read_batch  # noqa: E402
from repro_torch.kernels import _build, block_sort, hail_reader, ops, ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# range edge cases: below the minimum, above the maximum, lo > hi, a range
# that matches nothing between keys, a point, everything
LOHI = np.array([[100, 400], [-50, -1], [5000, 9000], [300, 100],
                 [1001, 1001], [0, 4095], [-2**31, 2**31 - 1]], np.int32)


def _reader_inputs(seed, b=3, rows=512, parts=4, c=2):
    """Block 0 indexed (sorted, its root directory), block 1 unindexed with
    a zeroed directory, block 2 unindexed in upload order."""
    r = np.random.default_rng(seed)
    keys = np.sort(r.integers(0, 1000, (b, rows)), axis=1).astype(np.int32)
    mins = keys[:, ::rows // parts].copy()
    mins[1:] = 0
    keys[2] = r.permutation(keys[2])
    proj = r.integers(-2**31, 2**31 - 1, (b, rows, c)).astype(np.int32)
    bad = r.random((b, rows)) < 0.05
    use_index = np.array([1, 0, 0][:b], np.int32)  # mixed index / full scan
    return mins, keys, proj, bad, use_index


@pytest.mark.parametrize("queries", [[0], [1], [2], [3], [4], [6], [0, 3, 5]])
def test_reader_plain_matches_jax(queries):
    mins, keys, proj, bad, uidx = _reader_inputs(seed=len(queries) * 7
                                                 + queries[0])
    lohi = LOHI[queries]
    rows = keys.shape[1]
    ps = rows // mins.shape[1]
    want = jax_read_batch(jnp.asarray(mins), jnp.asarray(keys),
                          jnp.asarray(proj), jnp.asarray(bad),
                          jnp.asarray(uidx), jnp.asarray(lohi),
                          partition_size=ps, interpret=True)
    got = hail_reader.hail_read_batch(
        *(torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx, lohi)),
        partition_size=ps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        assert np.asarray(w).dtype == g.numpy().dtype


def test_reader_finds_rows_equal_to_lo_before_a_partition_starting_at_lo():
    """Fault in the JAX package (ROADMAP §3): it starts an index scan at the
    LAST partition whose minimum is <= lo, so rows equal to lo at the end
    of the partition before one that starts with lo are missed.  The port
    starts one partition earlier and finds them, as a full scan does."""
    keys = np.repeat(np.arange(8, dtype=np.int32), 16)[None]  # 128 rows
    keys = np.concatenate([keys[:, :40], np.full((1, 88), 5, np.int32)], 1)
    keys = np.sort(keys, axis=1)
    mins = keys[:, ::32].copy()                    # 4 partitions of 32
    assert mins[0, 2] == 5 and keys[0, 63] == 5    # a run of 5s straddles
    proj = np.arange(128, dtype=np.int32).reshape(1, 128, 1)
    bad = np.zeros((1, 128), bool)
    uidx = np.ones(1, np.int32)
    lohi = np.array([[5, 5]], np.int32)
    want = (keys >= 5) & (keys <= 5)
    mask, _, frac = hail_reader.hail_read_batch(
        *(torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx, lohi)),
        partition_size=32)
    np.testing.assert_array_equal(mask[..., 0].numpy(), want)
    jmask, _, _ = jax_read_batch(*(jnp.asarray(a) for a in (
        mins, keys, proj, bad, uidx, lohi)), partition_size=32,
        interpret=True)
    assert np.asarray(jmask)[..., 0].sum() < want.sum()   # the fault
    assert frac.item() == 0.75                     # starts at partition 1


@pytest.mark.parametrize("blocks,n", [(2, 256), (2, 1024)])
def test_sort_plain_matches_jax(blocks, n):
    r = np.random.default_rng(n)
    keys = r.integers(-3, 4, (blocks, n)).astype(np.int32)   # heavy ties
    keys[:, r.random(n) < 0.1] = 2**31 - 1                  # bad-row sentinels
    want_k, want_p = jax_bitonic_sort(jnp.asarray(keys), interpret=True)
    got_k, got_p = block_sort.bitonic_sort(torch.from_numpy(keys))
    np.testing.assert_array_equal(np.asarray(want_k), got_k.numpy())
    np.testing.assert_array_equal(np.asarray(want_p), got_p.numpy())
    # the network is a stable argsort: the library sort agrees
    lib_k, lib_p = ref.sort_by_key(torch.from_numpy(keys))
    np.testing.assert_array_equal(lib_k.numpy(), got_k.numpy())
    np.testing.assert_array_equal(lib_p.numpy(), got_p.numpy())


def test_cpu_tensors_take_the_plain_versions():
    mins, keys, proj, bad, uidx = _reader_inputs(seed=3)
    t = [torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx)]
    before = dict(_build.KERNEL_LAUNCHES)
    with ops.stats_scope() as s:
        ops.hail_read(*t, 100, 400, partition_size=128)
        ops.hail_read_batch(*t, LOHI[:3], partition_size=128)
        ops.sort_block(t[1], {"p": t[1]})
    assert dict(_build.KERNEL_LAUNCHES) == before
    assert s.dispatches["hail_read"] == 2
    assert s.dispatches["hail_read_batch"] == 1
    assert s.traces["hail_read"] == 0          # nothing was built


def test_other_devices_raise():
    keys = torch.zeros((1, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        block_sort.bitonic_sort(keys)
    t = [torch.zeros(s, dtype=d, device="meta") for s, d in (
        ((1, 2), torch.int32), ((1, 8), torch.int32), ((1, 8, 1), torch.int32),
        ((1, 8), torch.bool), ((1,), torch.int32), ((1, 2), torch.int32))]
    with pytest.raises(ValueError, match="no kernel"):
        hail_reader.hail_read_batch(*t, partition_size=4)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    mins, keys, proj, bad, uidx = _reader_inputs(seed=5)
    t = [torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx,
                                       LOHI[:2])]
    hail_reader._check(*t)
    with pytest.raises(ValueError, match="proj must be 3-d torch.int32"):
        hail_reader._check(t[0], t[1], t[2].long(), *t[3:])
    with pytest.raises(ValueError, match="contiguous"):
        hail_reader._check(t[0], t[1].t().contiguous().t(), *t[2:])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        hail_reader._check(t[0], t[1], t[2][:, :8].contiguous(), *t[3:])
    with pytest.raises(ValueError, match="power of two"):
        block_sort.bitonic_sort(torch.zeros((1, 12), dtype=torch.int32))


def test_sort_block_shape_rule():
    """Rows that are not a power of two take the plain stable sort; the
    gathered columns follow the permutation either way."""
    r = np.random.default_rng(11)
    for n in (64, 48):
        keys = torch.from_numpy(r.integers(0, 5, (2, n)).astype(np.int32))
        rowid = torch.arange(2 * n, dtype=torch.int32).reshape(2, n)
        sk, out, perm = ops.sort_block(keys, {"rowid": rowid})
        lib_k, lib_p = ref.sort_by_key(keys)
        assert torch.equal(sk, lib_k) and torch.equal(perm, lib_p)
        assert torch.equal(out["rowid"], torch.gather(rowid, 1, lib_p.long()))


def test_port_imports_no_jax_and_nothing_of_repro():
    """Every module of the port, and chip_smoke, import without jax and
    without the JAX package."""
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(modules) >= 18


# ---------------------------------------------------------------------------
# the reader at more queries, an unsorted directory, and a numpy model of the
# CUDA kernel's indexing
# ---------------------------------------------------------------------------


def _ranges(rng, n_q, mins):
    """LOHI's edge ranges, then random ones; no lower bound equals a minimum
    of the directory (there the port starts a partition earlier than the
    JAX package, by design)."""
    taken = set(mins.ravel().tolist())
    out = [tuple(r) for r in LOHI[:n_q]]
    while len(out) < n_q:
        lo, hi = sorted(rng.integers(-50, 1050, 2).tolist())  # keys 0..999
        if lo not in taken:
            out.append((lo, hi))
    return np.array(out, np.int32)


@pytest.mark.parametrize("n_q", [9, 33])
def test_reader_plain_matches_jax_at_more_queries(n_q):
    """Batches wider than 8 (the server's default): the mask rows are not a
    multiple of 16 bytes, and Q = 33 spans three 16-byte groups a row."""
    mins, keys, proj, bad, uidx = _reader_inputs(seed=n_q)
    lohi = _ranges(np.random.default_rng(n_q), n_q, mins)
    ps = keys.shape[1] // mins.shape[1]
    want = jax_read_batch(*(jnp.asarray(a) for a in (
        mins, keys, proj, bad, uidx, lohi)), partition_size=ps,
        interpret=True)
    got = hail_reader.hail_read_batch(
        *(torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx, lohi)),
        partition_size=ps)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
        assert np.asarray(w).dtype == g.numpy().dtype


def _shifted_directory(seed, b=2, rows=512, parts=8):
    """Indexed blocks of keys near INT32_MAX whose directories are shifted
    by an int32 add that wraps, as ``FaultInjector.corrupt_root`` does: the
    later minima wrap to negative, so the directory is out of order."""
    r = np.random.default_rng(seed)
    top = 2**31 - 1
    keys = np.sort(r.integers(top - 2**16, top, (b, rows)), 1).astype(np.int32)
    mins = keys[:, ::rows // parts].astype(np.int64)
    shift = int(r.integers(2**15, 2**16))
    mins = ((mins + shift + 2**31) % 2**32 - 2**31).astype(np.int32)
    assert (np.diff(mins.astype(np.int64), axis=1) < 0).any()  # unsorted
    proj = r.integers(-2**31, 2**31 - 1, (b, rows, 2)).astype(np.int32)
    bad = r.random((b, rows)) < 0.05
    uidx = np.ones(b, np.int32)
    lohi = np.array([[top - 2**15, top - 2**14], [top - 2**16, top],
                     [-2**31, -2**31 + 2**15], [-2**31, 2**31 - 1],
                     [top - 100, top - 200]], np.int32)
    return mins, keys, proj, bad, uidx, lohi


def test_reader_counts_an_unsorted_root_directory():
    """A corrupted directory is read by counting, as the reference counts:
    the rows read are [max(#(mins < lo) - 1, 0), max(#(mins <= hi) - 1, 0)]
    partitions, whatever the order of the minima."""
    mins, keys, proj, bad, uidx, lohi = _shifted_directory(seed=4)
    b, rows = keys.shape
    ps = rows // mins.shape[1]
    mask, out, frac = hail_reader.hail_read_batch(
        *(torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx, lohi)),
        partition_size=ps)
    want_mask = np.zeros((b, rows, len(lohi)), bool)
    for i in range(b):
        for q, (lo, hi) in enumerate(lohi):
            r0 = max(int((mins[i] < lo).sum()) - 1, 0) * ps
            r1 = min((max(int((mins[i] <= hi).sum()) - 1, 0) + 1) * ps, rows)
            assert frac[i, q].item() == np.float32(r1 - r0) / np.float32(rows)
            r = np.arange(rows)
            want_mask[i, :, q] = ((keys[i] >= lo) & (keys[i] <= hi) & ~bad[i]
                                  & (r >= r0) & (r < r1))
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(
        out.numpy(), np.where(want_mask.any(-1)[..., None], proj, 0))
    # the shifted directory hides rows that a full scan finds
    full = (keys[..., None] >= lohi[:, 0]) & (keys[..., None] <= lohi[:, 1])
    full &= ~bad[..., None]
    assert 0 < want_mask.sum() < full.sum()


def test_check_takes_any_number_of_queries():
    mins, keys, proj, bad, uidx = _reader_inputs(seed=6)
    t = [torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx)]
    lohi = _ranges(np.random.default_rng(6), 1500, mins)
    hail_reader._check(*t, torch.from_numpy(lohi))
    with pytest.raises(ValueError, match="at least one query, got 0"):
        hail_reader._check(*t, torch.zeros((0, 2), dtype=torch.int32))
    assert not hasattr(hail_reader, "MAX_QUERIES")


_CU = (_build.CSRC / "hail_reader.cu").read_text()


def _cu_const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def _split16(addr, n, size):
    """(head, groups, tail) of n elements of ``size`` bytes at ``addr``:
    the kernel's ``split16``."""
    per = 16 // size
    head = min((16 - addr % 16) % 16 // size, n)
    groups = (n - head) // per
    return head, groups, n - head - groups * per


def _walk(head, groups, width, n_per_row, threads):
    """The kernel's walk of whole groups of ``width`` elements over a
    tile's (rows x n_per_row) range: thread t takes groups t, t + threads,
    ...; each group's first (row, column) comes from one division for the
    thread's first group, then steps by (drow, dcol).  Yields, per step of
    the loop, the active threads' groups and their (row, column)."""
    t = np.arange(threads)
    f0 = head + width * t
    row, col = f0 // n_per_row, f0 % n_per_row
    drow, dcol = divmod(width * threads, n_per_row)
    g = t.copy()
    while (g < groups).any():
        act = g < groups
        assert np.array_equal((row * n_per_row + col)[act],
                              head + width * g[act])  # stepping == division
        yield g[act], row[act].copy(), col[act].copy()
        col = col + dcol
        row = row + drow + (col >= n_per_row)
        col = np.where(col >= n_per_row, col - n_per_row, col)
        g = g + threads


def _kernel_model(mins, keys, proj, bad, uidx, lohi, ps, *, tile, threads,
                  window, addr):
    """``csrc/hail_reader.cu`` in numpy.  ``addr`` gives each array's start
    address modulo 16 (views at an offset start elsewhere than the
    allocator's 16-byte boundary).  Every output element and every staged
    row must be written exactly once."""
    b, rows = keys.shape
    n_cols, n_q = proj.shape[2], lohi.shape[0]
    # reader_kernel_ranges: one count per (block, query)
    qtab = np.empty((b, n_q, 4), np.int64)
    frac = np.empty((b, n_q), np.float32)
    for i in range(b):
        for q, (lo, hi) in enumerate(lohi.astype(np.int64)):
            r0, r1 = 0, rows
            if uidx[i] > 0:
                r0 = max(int((mins[i] < lo).sum()) - 1, 0) * ps
                r1 = min((max(int((mins[i] <= hi).sum()) - 1, 0) + 1) * ps,
                         rows)
            qtab[i, q] = lo, hi, r0, r1
            frac[i, q] = np.float32(r1 - r0) / np.float32(rows)
    mask = np.zeros(b * rows * n_q, np.uint8)
    out = np.zeros(b * rows * n_cols, np.int64)
    m_hits = np.zeros(mask.size, np.int64)
    o_hits = np.zeros(out.size, np.int64)
    flat_keys, flat_bad, flat_proj = keys.ravel(), bad.ravel(), proj.ravel()

    def stage(base, addr0, n, size, src):
        h, g, tl = _split16(addr0 + base * size, n, size)
        per = 16 // size
        assert g <= threads and h < 16 and tl < 16   # one load a thread
        idx = np.concatenate([np.arange(h), h + np.arange(g * per),
                              np.arange(n - tl, n)])
        assert np.array_equal(np.sort(idx), np.arange(n))
        return src[base + np.arange(n)]

    # reader_kernel_scan: one CTA a tile; a full-scan block's entries are
    # (lo, hi, 0, rows) from the query tensor, equal to the table's, and
    # the staged entries equal the table's
    for i in range(b):
        ranges = qtab[i]
        for tile_lo in range(0, rows, tile):
            n = min(tile, rows - tile_lo)
            row0 = i * rows + tile_lo
            live = uidx[i] <= 0 or bool(((ranges[:, 2] < tile_lo + n)
                                         & (ranges[:, 3] > tile_lo)).any())
            m0, o0 = row0 * n_q, row0 * n_cols
            if not live:
                m_hits[m0:m0 + n * n_q] += 1
                o_hits[o0:o0 + n * n_cols] += 1
                continue
            s_key = stage(row0, addr["keys"], n, 4, flat_keys)
            s_good = ~stage(row0, addr["bad"], n, 1, flat_bad)
            s_any = np.zeros(n, bool)
            # the mask, a window at a time: rows [ra, rb) x queries [qa, qb),
            # a (rows x queries) grid of threads, each on one query at a
            # time and its rows in steps of tr_n; staged at the output's
            # offset within 16 bytes and copied out 16 at a time
            tq_n = min(n_q, threads)
            tr_n = threads // tq_n
            win_rows, win_q = max(1, window // n_q), min(n_q, window)
            for ra in range(0, n, win_rows):
                for qa in range(0, n_q, win_q):
                    rb, qb = min(n, ra + win_rows), min(n_q, qa + win_q)
                    f0 = m0 + ra * n_q + qa
                    w = (rb - ra) * (qb - qa)
                    assert w <= window
                    shift = (addr["mask"] + f0) % 16
                    s_mask = np.full(window + 16, 255, np.int64)
                    # thread (tr, tq) writes queries qa + tq + k tq_n of
                    # rows ra + tr + j tr_n: each pair once
                    q = np.arange(qa, qb)[None, :]
                    r = np.arange(ra, rb)[:, None]
                    thread = ((r - ra) % tr_n) * tq_n + (q - qa) % tq_n
                    assert thread.max() < threads
                    lo, hi, r0, r1 = (ranges[q, j] for j in range(4))
                    k = s_key[r]
                    m = (s_good[r] & (k >= lo) & (k <= hi)
                         & (tile_lo + r >= r0) & (tile_lo + r < r1))
                    at = shift + (r - ra) * (qb - qa) + (q - qa)
                    assert len(np.unique(at)) == at.size
                    s_mask[at] = m
                    s_any[ra:rb] |= m.any(1)
                    h, groups, tl = _split16(addr["mask"] + f0, w, 1)
                    assert groups == 0 or (shift + h) % 16 == 0   # aligned
                    assert (s_mask[shift:shift + w] != 255).all()
                    mask[f0:f0 + w] = s_mask[shift:shift + w]
                    m_hits[f0:f0 + w] += 1
            n_ints = n * n_cols
            h, groups, tl = _split16(addr["out"] + 4 * o0, n_ints, 4)
            for f in [*range(h), *range(n_ints - tl, n_ints)]:
                out[o0 + f] = flat_proj[o0 + f] if s_any[f // n_cols] else 0
                o_hits[o0 + f] += 1
            for g, r, c in _walk(h, groups, 4, n_cols, threads):
                for k in range(4):
                    f = o0 + h + 4 * g + k
                    out[f] = np.where(s_any[r], flat_proj[f], 0)
                    o_hits[f] += 1
                    c = c + 1
                    r = r + (c == n_cols)
                    c = np.where(c == n_cols, 0, c)
    assert (m_hits == 1).all() and (o_hits == 1).all()
    return (mask.reshape(b, rows, n_q).astype(bool),
            out.reshape(b, rows, n_cols).astype(np.int32), frac)


ALIGNED = {"keys": 0, "bad": 0, "mask": 0, "out": 0}


# phase 3's edge cases of chip_smoke.py at the CPU's sizes: (blocks, rows,
# partitions, queries, columns, directory), at the kernel's own tile,
# thread and window sizes, or at smaller ones that give many tiles, steps
# and windows
@pytest.mark.parametrize("shape,sizes,addr", [
    ((3, 2048, 16, 3, 2, "mixed"), None, ALIGNED),        # odd Q
    ((3, 256, 4, 1500, 3, "mixed"), None, ALIGNED),       # Q > kStageQ
    ((3, 2048, 16, 8, 1, "mixed"), None, ALIGNED),        # C = 1
    ((3, 1000, 8, 5, 3, "mixed"), None, ALIGNED),         # R % 16 != 0
    ((2, 512, 8, 5, 2, "shifted"), None, ALIGNED),        # unsorted directory
    ((3, 2048, 16, 8, 3, "mixed"), None, ALIGNED),        # the server's width
    ((3, 1000, 8, 9, 3, "mixed"), (64, 32, 96), ALIGNED),
    ((3, 1000, 8, 1, 2, "full"), (48, 16, 32), {"keys": 4, "bad": 3,
                                                "mask": 0, "out": 0}),
    ((3, 517, 11, 33, 1, "mixed"), (64, 32, 160), {"keys": 12, "bad": 7,
                                                   "mask": 0, "out": 0}),
    ((3, 256, 4, 1500, 3, "mixed"), (64, 32, 1024), ALIGNED),  # Q > window
])
def test_kernel_model_matches_plain(shape, sizes, addr):
    b, rows, parts, n_q, n_cols, kind = shape
    if kind == "shifted":
        mins, keys, proj, bad, uidx, lohi = _shifted_directory(
            seed=9, b=b, rows=rows, parts=parts)
        lohi = np.concatenate([lohi] * 2)[:n_q]
    else:
        mins, keys, proj, bad, uidx = _reader_inputs(seed=rows + n_q, b=b,
                                                     rows=rows, parts=parts,
                                                     c=n_cols)
        if kind == "full":
            uidx[:] = 0
        lohi = _ranges(np.random.default_rng(n_q), n_q, mins)
    ps = -(-rows // parts)
    tile, threads, window = sizes or (_cu_const("kTileRows"),
                                      _cu_const("kThreads"),
                                      _cu_const("kWindow"))
    got = _kernel_model(mins, keys, proj, bad, uidx, lohi, ps, tile=tile,
                        threads=threads, window=window, addr=addr)
    want = hail_reader.hail_read_batch_plain(
        *(torch.from_numpy(a) for a in (mins, keys, proj, bad, uidx, lohi)),
        partition_size=ps)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
