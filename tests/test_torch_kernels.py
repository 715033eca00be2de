"""The PyTorch port's kernel layer against the JAX package: the plain
versions of the fused reader and the bitonic sort, bit for bit, the
device routing and counters of ``repro_torch.kernels.ops``, and the port's
import isolation.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these same plain versions)."""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
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
