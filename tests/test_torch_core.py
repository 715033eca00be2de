"""The PyTorch port's leaf modules against the JAX package, bit for bit:
parsing, chunk checksums and their verification, the clustered-index
helpers, and the numpy state both packages can start a store from."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import checksum as jck  # noqa: E402
from repro.core import index as jidx  # noqa: E402
from repro.core import parse as jps  # noqa: E402
from repro.core import schema as jsc  # noqa: E402
from repro_torch.core import checksum as ck  # noqa: E402
from repro_torch.core import index as idx  # noqa: E402
from repro_torch.core import parse as ps  # noqa: E402
from repro_torch.core import schema as sc  # noqa: E402
from repro_torch.core import store as st  # noqa: E402


def _raw(n=600, seed=3, bad_fraction=0.05):
    cols = sc.gen_uservisits(n, seed=seed)
    return ps.format_rows(sc.USERVISITS, cols, bad_fraction=bad_fraction,
                          seed=seed)


def test_generators_and_encoder_match_jax():
    for a, b in zip(sc.gen_uservisits(300, 5).values(),
                    jsc.gen_uservisits(300, 5).values()):
        np.testing.assert_array_equal(a, b)
    cols = sc.gen_uservisits(300, 5)
    np.testing.assert_array_equal(
        ps.format_rows(sc.USERVISITS, cols, bad_fraction=0.1),
        jps.format_rows(jsc.USERVISITS, cols, bad_fraction=0.1))
    assert sc.USERVISITS.row_ascii_width == jsc.USERVISITS.row_ascii_width


@pytest.mark.parametrize("bad_fraction", [0.0, 0.05, 0.5])
def test_parse_block_matches_jax(bad_fraction):
    raw = _raw(bad_fraction=bad_fraction)
    want_cols, want_bad = jps.parse_block(jsc.USERVISITS, jnp.asarray(raw))
    got_cols, got_bad = ps.parse_block(sc.USERVISITS, torch.from_numpy(raw))
    np.testing.assert_array_equal(np.asarray(want_bad), got_bad.numpy())
    assert set(want_cols) == set(got_cols)
    for c in want_cols:
        np.testing.assert_array_equal(np.asarray(want_cols[c]),
                                      got_cols[c].numpy())
        assert got_cols[c].dtype == torch.int32
    # blocks batch on leading dims: the same rows as two blocks of 300
    two, bad2 = ps.parse_block(sc.USERVISITS,
                               torch.from_numpy(raw.reshape(2, 300, -1)))
    np.testing.assert_array_equal(bad2.reshape(-1).numpy(), got_bad.numpy())


@pytest.mark.parametrize("dtype,n", [(np.int32, 1024), (np.int32, 1000),
                                     (np.uint8, 3000), (np.int32, 7)])
def test_chunk_checksums_match_jax(dtype, n):
    r = np.random.default_rng(n)
    data = r.integers(0, 2**31 - 1 if dtype == np.int32 else 255, n
                      ).astype(dtype)
    want = np.asarray(jck.chunk_checksums(jnp.asarray(data)))
    got = ck.chunk_checksums(torch.from_numpy(data))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(want.astype(np.int64), got.numpy())
    block = data[: (n // 4) * 4].reshape(4, -1)
    batched = ck.batched_chunk_checksums(torch.from_numpy(block))
    for i in range(4):
        np.testing.assert_array_equal(
            np.asarray(jck.chunk_checksums(jnp.asarray(block[i]))),
            batched[i].numpy())


def test_verify_blocks_and_root_match_jax():
    r = np.random.default_rng(9)
    data = r.integers(0, 1 << 30, (3, 4, 1024)).astype(np.int32)
    sums = np.stack([np.stack([np.asarray(jck.chunk_checksums(
        jnp.asarray(data[c, b]))) for b in range(4)]) for c in range(3)])
    data[1, 2, 77] ^= 1 << 5          # one flipped bit in (col 1, block 2)
    want = np.asarray(jck.verify_blocks(jnp.asarray(data), jnp.asarray(sums)))
    got = ck.verify_blocks(torch.from_numpy(data),
                           torch.from_numpy(sums.astype(np.int64)))
    np.testing.assert_array_equal(want, got.numpy())
    assert not got[1, 2] and got.sum() == 11

    keys = np.sort(r.integers(0, 500, (3, 1024)), axis=1).astype(np.int32)
    mins = keys[:, ::128].copy()
    mins[2, 3] += 1                   # a stale root directory
    want = np.asarray(jck.verify_root(jnp.asarray(mins), jnp.asarray(keys),
                                      128))
    got = ck.verify_root(torch.from_numpy(mins), torch.from_numpy(keys), 128)
    np.testing.assert_array_equal(want, got.numpy())
    assert got.tolist() == [True, True, False]


def test_sort_permutation_and_roots_match_jax():
    r = np.random.default_rng(4)
    keys = r.integers(0, 40, (3, 1024)).astype(np.int32)
    bad = r.random((3, 1024)) < 0.02
    for b in range(3):
        want = np.asarray(jidx.sort_permutation(jnp.asarray(keys[b]),
                                                jnp.asarray(bad[b])))
        got = idx.sort_permutation(torch.from_numpy(keys[b]),
                                   torch.from_numpy(bad[b]))
        np.testing.assert_array_equal(want, got.numpy())
    perm = idx.sort_permutation(torch.from_numpy(keys), torch.from_numpy(bad))
    sorted_keys = torch.gather(torch.from_numpy(keys), 1, perm)
    for b in range(3):
        np.testing.assert_array_equal(
            np.asarray(jidx.build_root(jnp.asarray(sorted_keys[b].numpy()),
                                       128)),
            idx.build_root(sorted_keys[b], 128).numpy())
    np.testing.assert_array_equal(
        np.asarray(jidx.build_block_roots(jnp.asarray(sorted_keys.numpy()),
                                          256)),
        idx.build_block_roots(sorted_keys, 256).numpy())
    mins = idx.build_block_roots(sorted_keys, 256)
    merged = idx.merge_block_roots(mins, [2, 0], mins[:2] + 1)
    np.testing.assert_array_equal(
        np.asarray(jidx.merge_block_roots(jnp.asarray(mins.numpy()),
                                          [2, 0],
                                          jnp.asarray(mins[:2].numpy() + 1))),
        merged.numpy())
    assert torch.equal(mins, idx.build_block_roots(sorted_keys, 256))


@pytest.mark.parametrize("lo,hi", [(10, 20), (-5, -1), (0, 0), (39, 39),
                                   (25, 12), (50, 90), (-10, 100)])
def test_search_range_matches_jax(lo, hi):
    """The index scan finds every row the full scan finds.  The upper end
    always equals the JAX package's; the lower end too, unless a partition
    minimum equals lo — there the JAX package starts at the last such
    partition and misses the rows equal to lo before it (ROADMAP §3), and
    the port starts at the partition before the first one."""
    r = np.random.default_rng(abs(lo * 101 + hi))
    keys = np.sort(r.integers(0, 40, (2, 1024)), axis=1).astype(np.int32)
    tk = torch.from_numpy(keys)
    mins = idx.build_block_roots(tk, 128)
    start, end = idx.search_range(mins, lo, hi, 128, 1024)
    frac = idx.rows_read_fraction(mins, lo, hi, 128, 1024)
    mask = idx.index_scan_mask(tk, mins, lo, hi, 128)
    for b in range(2):
        m = mins[b].numpy()
        jm = jnp.asarray(m)
        ws, we = jidx.search_range(jm, lo, hi, 128, 1024)
        assert int(end[b]) == int(we)
        assert int(start[b]) == max(int((m < lo).sum()) - 1, 0) * 128
        if lo not in m[1:]:
            assert int(start[b]) == int(ws)
            assert np.float32(jidx.rows_read_fraction(jm, lo, hi, 128,
                                                      1024)) == frac[b].numpy()
            np.testing.assert_array_equal(
                np.asarray(jidx.index_scan_mask(jnp.asarray(keys[b]), jm, lo,
                                                hi, 128)), mask[b].numpy())
        np.testing.assert_array_equal(
            mask[b].numpy(), (keys[b] >= lo) & (keys[b] <= hi))
        assert frac[b].numpy() == np.float32((int(end[b]) - int(start[b]))
                                             / 1024)
    np.testing.assert_array_equal(
        np.asarray(jidx.full_scan_mask(jnp.asarray(keys), lo, hi)),
        idx.full_scan_mask(tk, lo, hi).numpy())


def test_assign_nodes_and_numpy_state_roundtrip():
    from repro.core import store as jst
    np.testing.assert_array_equal(st.assign_nodes(7, 3, 5),
                                  jst.assign_nodes(7, 3, 5))
    with pytest.raises(ValueError, match="exceeds cluster size"):
        st.assign_nodes(4, 4, 3)
    cols = {"visitDate": np.arange(8, dtype=np.int32).reshape(2, 4)}
    state = {
        "schema": "UserVisits", "n_blocks": 2, "rows_per_block": 4,
        "partition_size": 2, "layout": "pax",
        "bad_counts": np.array([0, 1], np.int32),
        "bad_original": np.array([[0, 0, 0, 0], [0, 1, 0, 0]], bool),
        "replicas": [{"sort_key": None, "cols": cols,
                      "mins": np.zeros((2, 2), np.int32),
                      "checksums": {"visitDate": np.array(
                          [[4000000000], [7]], np.uint32)},
                      "nodes": np.array([r, r + 1]),
                      "indexed": np.zeros(2, bool)} for r in range(2)],
        "namenode": [(b, b + r, None, 2, 4, "pax", 16)
                     for r in range(2) for b in range(2)],
    }
    store = st.store_from_numpy(state, device="cpu")
    assert store.device == torch.device("cpu")
    # replicas that shared an array share the tensor, like a lazy upload
    assert (store.replicas[0].cols["visitDate"]
            is store.replicas[1].cols["visitDate"])
    assert store.replicas[0].checksums["visitDate"].dtype == torch.int64
    assert store.namenode.locate(1) == [1, 2]
    back = st.store_to_numpy(store)
    assert back["namenode"] == state["namenode"]
    np.testing.assert_array_equal(
        back["replicas"][1]["checksums"]["visitDate"],
        state["replicas"][1]["checksums"]["visitDate"])
    assert back["replicas"][1]["cols"]["visitDate"].tolist() == \
        cols["visitDate"].tolist()
