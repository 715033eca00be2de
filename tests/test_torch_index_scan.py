"""The PyTorch port's root-directory lookup and single-block range scan
against the JAX package, and a plain model of the tensor-core flash
kernel's arithmetic.

``index_search`` and ``pax_scan`` are held against the JAX package's Pallas
kernels run in interpret mode and against ``repro.kernels.ref``, on the
grids of ``tests/test_kernels.py``: masks and projections bit for bit,
per-tile counts equal (and their sum equal to the reference's total), and
``[p_first, p_last]`` equal wherever no minimum equals ``lo`` — where one
does, the port starts earlier, by its lower-bound rule (ROADMAP §3).  The
CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these same plain versions)."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402
import re  # noqa: E402
import types  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.index_search import index_search as jax_search  # noqa: E402
from repro.kernels.pax_scan import pax_scan as jax_scan  # noqa: E402
from repro_torch.kernels import (_build, index_search, ops, pax_scan,  # noqa: E402
                                 ref)

BF16_TOL = 2e-2     # tests/test_kernels.py, flash attention in bfloat16
LO, HI = 500, 7000


def _mins(seed, blocks, parts, top=10_000):
    r = np.random.default_rng(seed)
    return np.sort(r.integers(0, top, (blocks, parts)), 1).astype(np.int32)


def _jax_search(mins, lo, hi):
    """The JAX package's Pallas kernel (interpret mode) and its oracle."""
    got = np.asarray(jax_search(jnp.asarray(mins), lo, hi))
    np.testing.assert_array_equal(
        got, np.asarray(jax_ref.index_search(jnp.asarray(mins), lo, hi)))
    return got


def _assert_search_matches_jax(mins, lo, hi, got):
    """Equal rows wherever no minimum equals lo; elsewhere the port starts
    no later and ends where JAX ends."""
    want = _jax_search(mins, lo, hi)
    tie = (mins == lo).any(axis=1)
    np.testing.assert_array_equal(got[~tie], want[~tie])
    assert (got[tie, 0] <= want[tie, 0]).all()
    np.testing.assert_array_equal(got[tie, 1], want[tie, 1])


@pytest.mark.parametrize("blocks,parts", [(3, 8), (16, 32), (5, 64)])
def test_index_search_matches_jax(blocks, parts):
    mins = _mins(blocks * parts, blocks, parts)
    t = torch.from_numpy(mins)
    for got in (index_search.index_search(t, LO, HI),
                ops.index_search(t, LO, HI), ref.index_search(t, LO, HI)):
        assert got.dtype == torch.int32 and got.shape == (blocks, 2)
        _assert_search_matches_jax(mins, LO, HI, got.numpy())


def _covering_keys(seed, blocks, parts, ps):
    """Sorted key blocks with long runs of equal keys (so runs cross
    partition boundaries) and their root directories."""
    r = np.random.default_rng(seed)
    keys = np.sort(r.integers(0, 3 * parts, (blocks, parts * ps)),
                   1).astype(np.int32)
    return keys, np.ascontiguousarray(keys[:, ::ps])


def _rows_covered(keys, pr, lo, hi, ps):
    """Every row with lo <= key <= hi lies in [p_first*ps, (p_last+1)*ps)."""
    for b in range(keys.shape[0]):
        rows = np.nonzero((keys[b] >= lo) & (keys[b] <= hi))[0]
        if rows.size and not (pr[b, 0] * ps <= rows.min()
                              and rows.max() < (pr[b, 1] + 1) * ps):
            return False
    return True


def test_index_search_lo_equal_to_a_minimum():
    """Where a run of keys equal to lo crosses a partition boundary, JAX
    starts at the last partition whose minimum is lo and misses the run's
    head; the port starts one partition earlier and covers every row equal
    to lo."""
    ps = 8
    keys = np.repeat(np.arange(8, dtype=np.int32), 6)[None]          # 48
    keys = np.sort(np.concatenate([keys, np.full((1, 16), 5, np.int32)],
                                  axis=1), axis=1)                   # 64
    mins = np.ascontiguousarray(keys[:, ::ps])
    lo = hi = 5
    assert (mins[0] == lo).sum() >= 2
    got = index_search.index_search(torch.from_numpy(mins), lo, hi).numpy()
    want = _jax_search(mins, lo, hi)
    assert got[0, 0] < want[0, 0]
    assert _rows_covered(keys, got, lo, hi, ps)
    assert not _rows_covered(keys, want, lo, hi, ps)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 60), st.integers(0, 60), st.integers(0, 2**31 - 1))
def test_index_search_property(lo, hi, seed):
    """As ``tests/test_kernels.py``'s property, with the port's rule: equal
    to JAX where no minimum equals lo, and the range it returns covers
    every qualifying row (lo <= hi)."""
    lo, hi = min(lo, hi), max(lo, hi)
    keys, mins = _covering_keys(seed, 4, 16, 4)
    got = index_search.index_search(torch.from_numpy(mins), lo, hi).numpy()
    _assert_search_matches_jax(mins, lo, hi, got)
    assert (got[:, 0] <= got[:, 1]).all()
    assert _rows_covered(keys, got, lo, hi, 4)


def _scan_inputs(seed, rows, cols, dtype):
    r = np.random.default_rng(seed)
    keys = r.integers(0, 1000, rows).astype(np.int32)
    proj = r.integers(0, 99, (rows, cols)).astype(dtype)
    return keys, proj


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("rows,cols,tile", [(512, 1, 128), (1024, 4, 256),
                                            (2048, 3, 1024)])
def test_pax_scan_matches_jax(rows, cols, tile, dtype):
    keys, proj = _scan_inputs(rows + cols, rows, cols, dtype)
    wm, wo, wc = (np.asarray(a) for a in jax_scan(
        jnp.asarray(keys), jnp.asarray(proj), 200, 700, row_tile=tile))
    rm, ro, rc = (np.asarray(a) for a in jax_ref.pax_scan(
        jnp.asarray(keys), jnp.asarray(proj), 200, 700))
    kt, pt = torch.from_numpy(keys), torch.from_numpy(proj)
    mask, out, counts = pax_scan.pax_scan(kt, pt, 200, 700, row_tile=tile)
    np.testing.assert_array_equal(mask.numpy(), wm)
    np.testing.assert_array_equal(mask.numpy(), rm)
    assert out.dtype == pt.dtype
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  wo.view(np.int32))
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ro.view(np.int32))
    assert counts.dtype == torch.int32 and counts.shape == wc.shape
    np.testing.assert_array_equal(counts.numpy(), wc)
    assert int(counts.sum()) == int(rc)
    # the reference's contract: one 0-d total
    _, _, total = ref.pax_scan(kt, pt, 200, 700)
    assert total.dim() == 0 and int(total) == int(rc)


@pytest.mark.parametrize("rows,want_tile", [(1000, 1000), (1031, 1),
                                            (3072, 1024), (1536, 768)])
def test_pax_scan_tile_follows_the_tpu_rule(rows, want_tile):
    """``min(row_tile, rows)`` lowered until it divides the rows, as
    ``src/repro/kernels/pax_scan.py`` computes it: the counts have the TPU
    kernel's shape and values."""
    assert pax_scan.row_tile_for(rows) == want_tile
    keys, proj = _scan_inputs(rows, rows, 2, np.int32)
    wc = np.asarray(jax_scan(jnp.asarray(keys), jnp.asarray(proj), 100,
                             600)[2])
    got = pax_scan.pax_scan(torch.from_numpy(keys), torch.from_numpy(proj),
                            100, 600)[2]
    np.testing.assert_array_equal(got.numpy(), wc)


def test_pax_scan_keeps_float_bits():
    """The kernel moves 32-bit words; the plain version keeps the bits of
    every kept value (negative zero, NaN payloads) and writes +0 elsewhere,
    as the JAX kernel does."""
    words = np.array([0x80000000, 0x7FC00001, 0x3F800000, 0xFF800000],
                     np.uint32).view(np.int32)
    proj = np.stack([words, words[::-1]], axis=1).view(np.float32)
    keys = np.array([1, 5, 9, 5], np.int32)
    wm, wo, _ = jax_scan(jnp.asarray(keys), jnp.asarray(proj), 5, 9)
    mask, out, counts = pax_scan.pax_scan(torch.from_numpy(keys),
                                          torch.from_numpy(proj), 5, 9)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  np.asarray(wo).view(np.int32))
    assert out.numpy().view(np.int32)[0].tolist() == [0, 0]
    assert counts.tolist() == [3]


def test_ops_counts_dispatches_and_the_plain_contract():
    """One dispatch a call on either route; no kernel launch and no variant
    on the CPU; under ``use_kernels(False)`` ``pax_scan`` returns the JAX
    package's total count and ``index_search`` the plain lookup."""
    mins = torch.from_numpy(_mins(1, 4, 16))
    keys, proj = (torch.from_numpy(a)
                  for a in _scan_inputs(2, 256, 2, np.int32))
    launches = dict(_build.KERNEL_LAUNCHES)
    with ops.stats_scope() as s:
        pr = ops.index_search(mins, LO, HI)
        m, o, counts = ops.pax_scan(keys, proj, 100, 600)
        ops.use_kernels(False)
        try:
            pr_plain = ops.index_search(mins, LO, HI)
            m_plain, o_plain, total = ops.pax_scan(keys, proj, 100, 600)
        finally:
            ops.use_kernels(True)
    assert s.dispatches["index_search"] == 2
    assert s.dispatches["pax_scan"] == 2
    assert s.dispatches["hail_read"] == 0
    assert not s.traces
    assert dict(_build.KERNEL_LAUNCHES) == launches
    assert torch.equal(pr, pr_plain)
    assert torch.equal(m, m_plain) and torch.equal(o, o_plain)
    assert counts.shape == (1,) and total.dim() == 0
    wt = jax_ref.pax_scan(jnp.asarray(keys.numpy()),
                          jnp.asarray(proj.numpy()), 100, 600)[2]
    assert int(total) == int(counts.sum()) == int(wt)


def test_ops_new_ranges_add_no_variant(monkeypatch):
    """On the card's route each primitive is one kernel variant: the range
    travels as a device tensor, so new ranges and shapes never add one.
    (The CUDA wrappers are stubbed: only the accounting runs here.)"""
    monkeypatch.setattr(_build, "_VARIANTS", set())
    monkeypatch.setattr(ops._search, "index_search", lambda m, lo, hi: lo)
    monkeypatch.setattr(ops._pax, "pax_scan", lambda k, p, lo, hi: hi)
    card = types.SimpleNamespace(is_cuda=True)
    with ops.stats_scope() as s:
        for lo, hi in [(0, 10), (5, 5), (-3, 2**31 - 1), (9, 1)]:
            assert ops.index_search(card, lo, hi) == lo
            assert ops.pax_scan(card, None, lo, hi) == hi
    assert s.dispatches["index_search"] == s.dispatches["pax_scan"] == 4
    assert s.traces["index_search"] == s.traces["pax_scan"] == 1


def test_cpu_tensor_takes_the_plain_version():
    mins = torch.from_numpy(_mins(3, 5, 8))
    keys, proj = (torch.from_numpy(a)
                  for a in _scan_inputs(4, 300, 3, np.float32))
    launches = dict(_build.KERNEL_LAUNCHES)
    assert torch.equal(index_search.index_search(mins, LO, HI),
                       index_search.index_search_plain(mins, LO, HI))
    for g, w in zip(pax_scan.pax_scan(keys, proj, 100, 600, row_tile=64),
                    pax_scan.pax_scan_plain(keys, proj, 100, 600,
                                            row_tile=64)):
        assert torch.equal(g, w)
    # the bounds may be 0-d tensors, as a caller keeping them on the card
    lo, hi = torch.tensor(LO), torch.tensor(HI)
    assert torch.equal(index_search.index_search(mins, lo, hi),
                       index_search.index_search_plain(mins, LO, HI))
    assert dict(_build.KERNEL_LAUNCHES) == launches


def test_lohi_pair_is_one_int32_pair():
    for lo, hi in [(3, 9), (torch.tensor(3), torch.tensor(9)),
                   (np.int32(3), torch.tensor(9, dtype=torch.int64))]:
        pair = index_search.lohi_pair(lo, hi, torch.device("cpu"))
        assert pair.dtype == torch.int32 and pair.tolist() == [3, 9]


@pytest.mark.parametrize("bad,match", [
    ("dtype", "2-d int32"),
    ("ndim", "2-d int32"),
    ("layout", "contiguous"),
    ("device", "no kernel for device"),
])
def test_index_search_wrapper_rejects_what_the_kernel_does_not_take(bad,
                                                                     match):
    mins = torch.zeros((4, 8), dtype=torch.int32)
    if bad == "dtype":
        mins = mins.long()
    elif bad == "ndim":
        mins = mins.flatten()
    elif bad == "layout":
        mins = torch.zeros((8, 4), dtype=torch.int32).t()
    else:
        mins = mins.to("meta")
    with pytest.raises(ValueError, match=match):
        index_search.index_search(mins, 0, 1)


@pytest.mark.parametrize("bad,match", [
    ("key_dtype", "key_col must be 1-d int32"),
    ("proj_dtype", "int32 or float32"),
    ("proj_bf16", "int32 or float32"),
    ("proj_ndim", "proj must be 2-d"),
    ("shape", "inconsistent shapes"),
    ("layout", "contiguous"),
    ("row_tile", "row_tile"),
    ("device", "no kernel for device"),
])
def test_pax_scan_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    keys = torch.zeros(16, dtype=torch.int32)
    proj = torch.zeros((16, 2), dtype=torch.int32)
    row_tile = 1024
    if bad == "key_dtype":
        keys = keys.long()
    elif bad == "proj_dtype":
        proj = proj.long()
    elif bad == "proj_bf16":
        proj = proj.to(torch.bfloat16)
    elif bad == "proj_ndim":
        proj = proj.flatten()
    elif bad == "shape":
        proj = torch.zeros((15, 2), dtype=torch.int32)
    elif bad == "layout":
        proj = torch.zeros((2, 16), dtype=torch.int32).t()
    elif bad == "row_tile":
        row_tile = 0
    else:
        keys, proj = keys.to("meta"), proj.to("meta")
    with pytest.raises(ValueError, match=match):
        pax_scan.pax_scan(keys, proj, 0, 1, row_tile=row_tile)


# ---------------------------------------------------------------------------
# the tensor-core flash kernel's arithmetic, modelled on the CPU
# ---------------------------------------------------------------------------


def _flash_fwd_tiles(d):
    """(q rows, keys) of the bf16 kernel's tiles at head dim ``d``, read
    from ``csrc/flash_fwd.cuh`` (``kTQ``; ``kTK``: one size up to a head
    dim, another past it)."""
    src = (_build.CSRC / "flash_fwd.cuh").read_text()
    q_tile = int(re.search(r"constexpr int kTQ = (\d+);", src)[1])
    lim, small, large = map(int, re.search(
        r"constexpr int kTK = D <= (\d+) \? (\d+) : (\d+);", src).groups())
    return q_tile, small if d <= lim else large


def _flash_bf16_model(q, k, v, *, causal, window):
    """What ``flash_bf16_kernel`` computes, in plain PyTorch: the kernel's
    q tiles and K/V tiles over the same band (tiles outside it skipped only
    when every row of the q tile keeps a key), S = Q K^T from bf16 values in
    float32, scaled by 1/sqrt(D) log2(e), masked scores -1e30 and keys past
    S -inf, a base-2 online softmax in float32, and P ROUNDED TO bf16 before
    P V."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    q_tile, tile = _flash_fwd_tiles(d)
    qf = q.float().permute(0, 2, 1, 3)                          # (B,H,T,D)
    kf, vf = (x.float().repeat_interleave(h // kvh, dim=2)
              .permute(0, 2, 1, 3) for x in (k, v))             # (B,H,S,D)
    sl2 = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) \
        * torch.tensor(1.4426950408889634, dtype=torch.float32)
    out = torch.empty((b, h, t, d))
    for q0 in range(0, t, q_tile):
        q_hi = min(q0 + q_tile, t) - 1
        rows = torch.arange(q0, q_hi + 1)[:, None]
        k_max = min(q_hi, s - 1) if causal else s - 1
        k_min = max(q_hi - window + 1, 0) if window else 0
        k_begin, k_end = 0, s
        if k_max >= k_min:
            if causal:
                k_end = min(s, q_hi + 1)
            if window:
                k_begin = max(q0 - window + 1, 0) // tile * tile
        m = torch.full((b, h, len(rows)), -1e30)
        l = torch.zeros((b, h, len(rows)))
        acc = torch.zeros((b, h, len(rows), d))
        for k0 in range(k_begin, k_end, tile):
            kp = torch.arange(k0, k0 + tile)[None, :]
            kt = torch.zeros((b, h, tile, d))
            vt = torch.zeros((b, h, tile, d))
            n = min(tile, s - k0)
            kt[:, :, :n], vt[:, :, :n] = kf[:, :, k0:k0 + n], vf[:, :, k0:k0 + n]
            sc = (qf[:, :, q0:q_hi + 1] @ kt.transpose(-1, -2)) * sl2
            keep = (kp >= 0) & (rows >= 0)                     # (rows, keys)
            if causal:
                keep = keep & (kp <= rows)
            if window:
                keep = keep & (kp > rows - window)
            sc = torch.where(kp >= s, -math.inf, torch.where(keep, sc, -1e30))
            mx = torch.maximum(m, sc.amax(-1))
            alpha = torch.exp2(m - mx)
            p = torch.exp2(sc - mx[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p.bfloat16().float() @ vt
            m = mx
        out[:, :, q0:q_hi + 1] = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


@pytest.mark.parametrize("t,s,h,kv,d,causal,window", [
    (128, 128, 8, 2, 64, True, None),     # llama's GQA and head dim, cut
    (100, 100, 4, 2, 16, True, None),     # the reduced llama, ragged T
    (100, 77, 4, 2, 32, False, 24),       # ragged S, non-causal window
    (200, 50, 2, 1, 64, True, 16),        # rows with no key in the band
])
def test_flash_bf16_design_is_inside_the_bf16_tolerance(t, s, h, kv, d,
                                                        causal, window):
    """The only rounding the tensor-core kernel adds to the reference's
    float32 arithmetic is P to bf16 (2^-9 relative a weight); with it the
    output stays within ``FLASH_TOL[bfloat16]`` of ``ref.attention`` and of
    the JAX package's flash kernel (interpret mode) on the same bf16
    inputs."""
    r = np.random.default_rng(t + s + d)
    arrays = [r.normal(size=shape).astype(np.float32)
              for shape in ((2, t, h, d), (2, s, kv, d), (2, s, kv, d))]
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = _flash_bf16_model(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = ref.attention(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=BF16_TOL)
    jin = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    # the JAX kernel's blocks must divide T and S
    jax_out = np.asarray(jax_flash(
        *jin, causal=causal, window=window,
        block_q=64 if t % 64 == 0 else t, block_k=64 if s % 64 == 0 else s),
        np.float32)
    np.testing.assert_allclose(got.float().numpy(), jax_out, atol=BF16_TOL)
    # the rounding is real: the model is not the float32 reference itself
    exact = ref.attention(q.float(), k.float(), v.float(), causal=causal,
                          window=window)
    assert float((got.float() - exact).abs().max()) > 0
