"""Plain models of the arithmetic of two CUDA kernels of the PyTorch port,
held against the JAX package on the CPU.

``csrc/block_sort.cu`` sorts by a stable LSD radix sort in the one-sweep
style; ``_radix_model`` repeats its passes in numpy: the histogram of all
four digits, tiles ranked warp by warp in position order, per-(tile,
digit) counts published as flag + count words and summed by decoupled
look-back (earlier tiles seen as aggregate or inclusive at random), the
scatter through a tile-sized staging buffer.  It must equal the JAX bitonic
kernel (interpret mode) and the stable argsort bit for bit.

``csrc/selective_scan.cu`` splits each channel's N states over L lanes,
takes exp2 of the prescaled A, sums each lane's h * C in state order and
the L lanes' partial sums in the shuffle butterfly's order, and runs
zero-filled steps past T and channels past D; ``_scan_model`` repeats that
in float32 numpy.  It is held to the JAX Pallas scan at the scan's
tolerance, 1e-4 (``tests/test_kernels.py``): the same float32 recurrence,
with another exponential and another summation order.

The kernels themselves run only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import re  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.block_sort import bitonic_sort as jax_bitonic_sort  # noqa: E402
from repro.kernels.selective_scan import selective_scan as jax_scan  # noqa: E402
from repro_torch.kernels import _build, block_sort, ref  # noqa: E402

SCAN_TOL = 1e-4     # tests/test_kernels.py, selective scan
INT32_MAX = 2**31 - 1
AGGREGATE, INCLUSIVE, COUNT_BITS = 1, 2, 30

# ---------------------------------------------------------------------------
# the radix sort
# ---------------------------------------------------------------------------


def _digits(keys, p):
    return ((keys.view(np.uint32) ^ np.uint32(0x80000000)) >> (8 * p)) & 255


def _rank_tile(d, warps, lanes, items):
    """Stable ranks of one tile's digits d (position order), as the kernel
    computes them: warp w owns positions [w * lanes * items, ...), step j the
    lanes * j + lane; a lane's rank is its warp's count of the digit before
    the step plus the earlier lanes of the step with the same digit.
    Returns (slot of every position in the tile, the tile's digit counts)."""
    seg = lanes * items
    counts = np.zeros((warps, 256), np.int64)
    rank = np.empty(d.size, np.int64)
    for w in range(warps):
        for j in range(items):
            idx = w * seg + j * lanes + np.arange(lanes)
            dd = d[idx]
            same = dd[:, None] == dd[None, :]
            earlier = np.tril(same, -1).sum(1)      # match_any & lanemask_lt
            rank[idx] = counts[w, dd] + earlier
            np.add.at(counts[w], dd, 1)             # the leaders' updates
    warp_before = np.cumsum(counts, 0) - counts     # prefix over the warps
    total = counts.sum(0)
    tile_start = np.cumsum(total) - total           # prefix over the digits
    warp_of = np.arange(d.size) // seg
    slot = tile_start[d] + warp_before[warp_of, d] + rank
    return slot, total, tile_start


def _look_back(agg, inc, tile, rng):
    """Every digit's count over the tiles before ``tile``, walked back as
    the kernel does: each earlier tile's word shows its aggregate or (at
    random) its inclusive prefix, tile 0 only ever the inclusive one; a
    digit's walk stops at the first inclusive word."""
    got = np.zeros(256, np.int64)
    walking = np.ones(256, bool)
    for p in range(tile - 1, -1, -1):
        shows_inc = np.full(256, True) if p == 0 else rng.random(256) < 0.5
        word = np.where(shows_inc, inc[p], agg[p])
        flag, count = word >> COUNT_BITS, word & ((1 << COUNT_BITS) - 1)
        assert np.isin(flag, (AGGREGATE, INCLUSIVE)).all()
        got[walking] += count[walking]
        walking &= flag != INCLUSIVE
        if not walking.any():
            break
    return got


def _radix_model(keys, warps=8, lanes=32, items=16, seed=0):
    """keys (blocks, n) int32 -> (sorted, int32 perm) the way
    ``csrc/block_sort.cu`` computes them, at any tile geometry."""
    rng = np.random.default_rng(seed)
    b, n = keys.shape
    tile = warps * lanes * items
    tiles = max(1, n // tile)
    hist = np.stack([[np.bincount(_digits(keys[i], p), minlength=256)
                      for p in range(4)] for i in range(b)])
    src_k = keys.copy()
    src_v = np.broadcast_to(np.arange(n, dtype=np.int32), (b, n)).copy()
    for p in range(4):
        dst_k, dst_v = np.empty_like(src_k), np.empty_like(src_v)
        for i in range(b):
            global_start = np.cumsum(hist[i, p]) - hist[i, p]
            agg, inc, counts = [], [], np.zeros(256, np.int64)
            for t in range(tiles):
                pos = t * tile + np.arange(tile)
                valid = pos < n                        # pads: INT32_MAX
                k = np.where(valid, src_k[i, np.minimum(pos, n - 1)],
                             INT32_MAX).astype(np.int32)
                v = np.where(valid, src_v[i, np.minimum(pos, n - 1)], pos)
                d = _digits(k, p)
                slot, total, tile_start = _rank_tile(d, warps, lanes, items)
                assert np.array_equal(np.sort(slot), np.arange(tile))
                before = _look_back(agg, inc, t, rng)
                assert np.array_equal(before, counts)
                assert (before + total).max() < 1 << COUNT_BITS
                agg.append((AGGREGATE << COUNT_BITS) | total)
                inc.append((INCLUSIVE << COUNT_BITS) | (before + total))
                counts += total
                stage_k = np.empty(tile, np.int32)
                stage_v = np.empty(tile, np.int64)
                stage_k[slot], stage_v[slot] = k, v
                n_valid = min(tile, n - t * tile)      # pads sit last
                assert (stage_k[n_valid:] == INT32_MAX).all()
                sd = _digits(stage_k[:n_valid], p)
                dst = (global_start[sd] + before[sd] - tile_start[sd]
                       + np.arange(n_valid))
                dst_k[i, dst] = stage_k[:n_valid]
                dst_v[i, dst] = stage_v[:n_valid]
        src_k, src_v = dst_k, dst_v
    return src_k, src_v.astype(np.int32)


def _sort_keys(case, b, n, seed):
    r = np.random.default_rng(seed)
    if case == "ties":
        keys = r.integers(-3, 4, (b, n))
    elif case == "sentinels":
        keys = r.integers(7000, 7050, (b, n))
        keys[r.random((b, n)) < 0.1] = INT32_MAX
    elif case == "negative":
        keys = r.integers(-2**31, 2**31, (b, n))
        keys[:, :2] = [-2**31, -1]
    elif case == "equal":
        keys = np.full((b, n), -7)
    elif case == "one_value":
        keys = np.full((b, n), 10155)
        keys[r.random((b, n)) < 0.3] = INT32_MAX
    return keys.astype(np.int32)


CASES = ["ties", "sentinels", "negative", "equal", "one_value"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,n", [(1, 2), (2, 4), (1, 8), (3, 32), (1, 256),
                                 (3, 1024), (2, 2048), (2, 4096)])
def test_radix_model_matches_jax_sort(case, b, n):
    """Two tile geometries against one JAX sort: tiles of 16 keys (2 warps
    x 4 lanes x 2 steps), so from n = 32 a block has many tiles and the
    look-back and the scatter's bases carry the order; and the kernel's own
    (8 warps x 32 lanes x 16 steps = 4096 keys), which pads one tile below
    n = 4096.  n = 2, 4 and 8 pad even the small tile."""
    keys = _sort_keys(case, b, n, seed=n + b)
    want_k, want_p = jax_bitonic_sort(jnp.asarray(keys), interpret=True)
    lib_k, lib_p = ref.sort_by_key(torch.from_numpy(keys))
    for geometry in ({"warps": 2, "lanes": 4, "items": 2}, {}):
        got_k, got_p = _radix_model(keys, seed=n, **geometry)
        np.testing.assert_array_equal(np.asarray(want_k), got_k)
        np.testing.assert_array_equal(np.asarray(want_p), got_p)
        np.testing.assert_array_equal(lib_k.numpy(), got_k)
        np.testing.assert_array_equal(lib_p.numpy(), got_p)


def test_radix_model_many_kernel_tiles_is_the_stable_argsort():
    """Four tiles of the kernel's size a block, three blocks (the JAX
    network in interpret mode is too slow at this size; the sort_by_key
    comparison is the same bit-for-bit claim)."""
    keys = _sort_keys("sentinels", 3, 1 << 14, seed=14)
    got_k, got_p = _radix_model(keys, seed=14)
    lib_k, lib_p = ref.sort_by_key(torch.from_numpy(keys))
    np.testing.assert_array_equal(lib_k.numpy(), got_k)
    np.testing.assert_array_equal(lib_p.numpy(), got_p)


def test_sort_constants_match_the_kernel():
    """The wrapper sizes the scratch by the kernel's tile (nothing compiles
    here, so read the source)."""
    src = (_build.CSRC / "block_sort.cu").read_text()
    const = {m[0]: m[1] for m in re.findall(
        r"constexpr int (k\w+) = ([^;]+);", src)}
    assert const["kThreads"] == "256" and const["kItems"] == "16"
    assert const["kTile"].startswith("kThreads * kItems")
    assert block_sort.TILE == 256 * 16
    assert const["kPasses"] == str(block_sort.DIGITS)
    assert const["kRadix"] == str(block_sort.RADIX)


# ---------------------------------------------------------------------------
# the selective scan
# ---------------------------------------------------------------------------

LOG2E = np.float32(1.4426950408889634)


def _lanes_for(n):
    """Lanes a channel's states are split over (csrc ``lanes_for``)."""
    return 4 if n >= 10 else 2 if n >= 5 else 1


def _scan_model(delta, x, bm, cm, a, steps=16, channels=64):
    """What ``selective_scan_lanes`` computes, in float32 numpy: time padded
    with zeros to whole chunks of ``steps``, channels to whole CTAs of
    ``channels``; lane l of a channel keeps states l*S .. l*S + S - 1 (a
    state past N has a = B = C = 0); h = exp2(dt * a') h + (dt x) B with
    a' = a * log2(e); each lane's partial sum over its states in order;
    y = the butterfly over the L lanes: p0 at L = 1, p0 + p1 at L = 2,
    (p0 + p2) + (p1 + p3) at L = 4."""
    f32 = np.float32
    bs, t, d = delta.shape
    n = a.shape[1]
    lanes = _lanes_for(n)
    s_per = -(-n // lanes)
    tp, dp = -(-t // steps) * steps, -(-d // channels) * channels

    def pad(v, shape):
        out = np.zeros(shape, f32)
        out[tuple(slice(0, k) for k in v.shape)] = v
        return out

    dl, xl = pad(delta, (bs, tp, dp)), pad(x, (bs, tp, dp))
    # states laid out (lane, state of the lane), padded past N
    bl = pad(bm, (bs, tp, lanes * s_per)).reshape(bs, tp, lanes, s_per)
    cl = pad(cm, (bs, tp, lanes * s_per)).reshape(bs, tp, lanes, s_per)
    a2 = (pad(a, (dp, lanes * s_per)) * LOG2E).astype(f32).reshape(
        dp, lanes, s_per)
    h = np.zeros((bs, dp, lanes, s_per), f32)
    y = np.zeros((bs, tp, dp), f32)
    for ti in range(tp):
        dt = dl[:, ti, :, None, None]
        dx = (dl[:, ti] * xl[:, ti])[:, :, None, None]
        e = np.exp2((dt * a2).astype(f32)).astype(f32)
        h = (e * h + dx * bl[:, ti, None]).astype(f32)
        hc = (h * cl[:, ti, None]).astype(f32)
        p = hc[..., 0]
        for s in range(1, s_per):
            p = (p + hc[..., s]).astype(f32)
        if lanes == 4:
            yt = (p[..., 0] + p[..., 2]) + (p[..., 1] + p[..., 3])
        elif lanes == 2:
            yt = p[..., 0] + p[..., 1]
        else:
            yt = p[..., 0]
        y[:, ti] = yt
    h_final = h.reshape(bs, dp, lanes * s_per)[:, :d, :n]
    # the padded steps left h as it was, the padded channels at 0
    assert not h.reshape(bs, dp, -1)[:, d:].any()
    return y[:, :t, :d], h_final


def _scan_inputs(seed, b, t, d, n):
    r = np.random.default_rng(seed)
    delta = np.log1p(np.exp(r.normal(size=(b, t, d)))).astype(np.float32)
    x = r.normal(size=(b, t, d)).astype(np.float32)
    bm = r.normal(size=(b, t, n)).astype(np.float32)
    cm = r.normal(size=(b, t, n)).astype(np.float32)
    a = (-np.exp(r.normal(size=(d, n)) * 0.3)).astype(np.float32)
    return delta, x, bm, cm, a


@pytest.mark.parametrize("t,d,n,chunk,dblk", [(32, 16, 8, 8, 8),
                                              (64, 32, 4, 16, 16),
                                              (48, 8, 8, 16, 8),
                                              (40, 24, 5, 8, 8),
                                              (48, 16, 16, 16, 16)])
@pytest.mark.parametrize("channels", [64, 8])
def test_scan_model_matches_jax_scan(t, d, n, chunk, dblk, channels):
    """The shapes of test_torch_lm_kernels' JAX comparison, and N = 5
    (2 lanes of 3 states, one padded) and N = 16 (4 lanes of 4); T = 40 pads
    the last chunk, and CTAs of 8 channels split D (24 pads none, 64 pads
    every shape)."""
    arrays = _scan_inputs(t + d + n, 2, t, d, n)
    wy, wh = jax_scan(*map(jnp.asarray, arrays), chunk=chunk, d_block=dblk)
    y, h = _scan_model(*arrays, channels=channels)
    np.testing.assert_allclose(y, np.asarray(wy), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h, np.asarray(wh), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


@pytest.mark.parametrize("n", range(1, 17))
def test_scan_model_every_state_size_matches_the_plain_scan(n):
    """Every N the kernel takes (1 to 16, with 1, 2 or 4 lanes, padded or
    not), against the port's plain scan at the same tolerance; T = 37 and
    D = 70 leave ragged chunks and CTAs."""
    arrays = _scan_inputs(n, 2, 37, 70, n)
    want_y, want_h = ref.selective_scan(*map(torch.from_numpy, arrays))
    y, h = _scan_model(*arrays)
    lanes = _lanes_for(n)
    assert (lanes - 1) * -(-n // lanes) < n     # every lane keeps a state
    np.testing.assert_allclose(y, want_y.numpy(), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h, want_h.numpy(), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


def test_scan_model_is_not_the_float64_recurrence():
    """exp2 of the prescaled A is a real change of arithmetic: the model
    differs from the recurrence in float64, by far less than the
    tolerance."""
    arrays = _scan_inputs(9, 2, 64, 32, 16)
    y, _ = _scan_model(*arrays)
    delta, x, bm, cm, a = (v.astype(np.float64) for v in arrays)
    h = np.zeros((2, 32, 16))
    want = np.zeros((2, 64, 32))
    for ti in range(64):
        dt = delta[:, ti, :, None]
        h = np.exp(dt * a) * h + (dt * x[:, ti, :, None]) * bm[:, ti, None]
        want[:, ti] = (h * cm[:, ti, None]).sum(-1)
    err = np.abs(y - want).max() / max(1.0, np.abs(want).max())
    assert 0 < err < SCAN_TOL / 10


def test_scan_constants_match_the_kernel():
    """The model's chunk, CTA width and lane rule are the kernel's (read
    from the source: nothing compiles here)."""
    src = (_build.CSRC / "selective_scan.cu").read_text()
    assert re.search(r"constexpr int kChannels = 64;", src)
    assert re.search(r"constexpr int kSteps = 16;", src)
    rule = re.search(r"lanes_for\(int n\) \{\s*return ([^;]+);", src).group(1)
    assert rule == "n >= 10 ? 4 : (n >= 5 ? 2 : 1)"
