"""The training path's kernels on the CPU: the plain backward versions
(``ref.attention_bwd``, ``ref.selective_scan_bwd``) against
``torch.autograd`` through the plain forwards and against ``jax.vjp`` of
the JAX package's oracles (``repro.kernels.ref``), the two
``autograd.Function``s of ``kernels/ops.py`` by ``gradcheck``, the routing
of ``ops.attention`` / ``ops.selective_scan`` with and without grad, the
wrappers' input checks, and the C signatures of the new entry points.  The
CUDA kernels run only on the card; ``chip_smoke.py`` holds them to these
plain versions there.

Tolerances, with their reasons:

* float32, port against autograd or jax.vjp: 1e-5 of each gradient's
  largest magnitude (atol) and rtol 1e-5 — the same float32 arithmetic
  summed in another order (the attention oracles keep float32 scores;
  the scan's gradients sum over the 512 or fewer steps and the channels).
* gradcheck: float64 at tiny shapes with its default tolerances (eps 1e-6,
  atol 1e-5, rtol 1e-3), which checks the formula, not the rounding.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import AttnCfg as JAttnCfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import (_build, flash_attention, ops, ref,  # noqa: E402
                                 selective_scan)

TOL = 1e-5

ATTN_CASES = [
    # b, t, s, h, kv, d, causal, window
    (2, 48, 48, 4, 4, 16, True, None),        # causal
    (1, 64, 64, 4, 2, 16, True, 12),          # windowed
    (2, 40, 40, 2, 2, 32, False, None),       # non-causal
    (1, 33, 33, 8, 2, 16, True, None),        # GQA 4:1, ragged T
    (1, 24, 40, 4, 1, 16, False, 9),          # T != S, windowed, 4:1
    (1, 50, 20, 2, 1, 16, True, 8),           # T > S: rows with no key
]


def _close(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _attn_arrays(seed, b, t, s, h, kv, d):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d),
                          (b, t, h, d))]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_matches_autograd_and_jax_vjp(case):
    b, t, s, h, kv, d, causal, window = case
    qa, ka, va, doa = _attn_arrays(sum(case[:6]), b, t, s, h, kv, d)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qa, ka, va))
    do = torch.from_numpy(doa)
    out = ref.attention(q, k, v, causal=causal, window=window)
    auto = torch.autograd.grad(out, (q, k, v), do)
    o, lse, _ = ref.attention_lse(q.detach(), k.detach(), v.detach(),
                                  causal=causal, window=window)
    assert torch.equal(o, out.detach())
    got = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do,
                            causal=causal, window=window)
    _, vjp = jax.vjp(lambda q_, k_, v_: jref.attention(
        q_, k_, v_, causal=causal, window=window),
        *map(jnp.asarray, (qa, ka, va)))
    want = vjp(jnp.asarray(doa))
    for g, a, w in zip(got, auto, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), a.numpy())
        _close(g.numpy(), np.asarray(w))


SOFTCAP = 2.0     # small enough that tanh bends the scores of N(0, 1) data


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_bwd_with_softcap_matches_autograd_and_jax_vjp(case):
    """gemma3's softcap: scores capped at c tanh(s/c) before the mask.  The
    plain backward (dS times 1 - tanh^2) against autograd through the
    capped plain attention and against ``jax.vjp`` of the JAX package's
    ``_sdpa_full`` with the same cap, positions the indices."""
    b, t, s, h, kv, d, causal, window = case
    qa, ka, va, doa = _attn_arrays(sum(case[:6]) + 1, b, t, s, h, kv, d)
    qa *= 2.0                   # scores up to ~6: the cap bends them
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qa, ka, va))
    do = torch.from_numpy(doa)
    out = ref.attention(q, k, v, causal=causal, window=window,
                        softcap=SOFTCAP)
    auto = torch.autograd.grad(out, (q, k, v), do)
    o, lse, _ = ref.attention_lse(q.detach(), k.detach(), v.detach(),
                                  causal=causal, window=window,
                                  softcap=SOFTCAP)
    assert torch.equal(o, out.detach())
    got = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do,
                            causal=causal, window=window, softcap=SOFTCAP)
    cfg = JAttnCfg(n_heads=h, n_kv=kv, head_dim=d, window=window,
                   causal=causal, softcap=SOFTCAP)
    qpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
    kpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    _, vjp = jax.vjp(lambda q_, k_, v_: jattn._sdpa_full(
        q_, k_, v_, qpos, kpos, cfg), *map(jnp.asarray, (qa, ka, va)))
    want = vjp(jnp.asarray(doa))
    uncapped = ref.attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                                 do, causal=causal, window=window)
    for g, a, w, u in zip(got, auto, want, uncapped):
        _close(g.numpy(), a.numpy())
        _close(g.numpy(), np.asarray(w))
    # the cap's derivative is live: without it dq moves past the tolerance
    assert float((got[0] - uncapped[0]).abs().max()) > \
        100 * TOL * float(got[0].abs().max())


def test_attention_lse_marks_rows_without_keys():
    """T > S with a causal window: rows past S + window - 1 keep no key; the
    forward averages v there and the lse is the mask value, which the
    backward reads as 'every key weighs 1/S'."""
    qa, ka, va, _ = _attn_arrays(0, 1, 50, 20, 2, 1, 16)
    q, k, v = map(torch.from_numpy, (qa, ka, va))
    o, lse, _ = ref.attention_lse(q, k, v, causal=True, window=8)
    empty = lse[0, 0] <= ref.NEG_INF / 2
    assert empty[27:].all() and not empty[:27].any()
    np.testing.assert_allclose(o[0, 30, 0].numpy(),
                               v[0, :, 0].mean(0).numpy(), rtol=1e-6,
                               atol=1e-6)


def _scan_arrays(seed, b, t, d, n):
    r = np.random.default_rng(seed)
    delta = np.log1p(np.exp(r.normal(size=(b, t, d)))).astype(np.float32)
    return (delta,
            r.normal(size=(b, t, d)).astype(np.float32),
            r.normal(size=(b, t, n)).astype(np.float32),
            r.normal(size=(b, t, n)).astype(np.float32),
            (-np.exp(0.3 * r.normal(size=(d, n)))).astype(np.float32),
            r.normal(size=(b, t, d)).astype(np.float32),
            r.normal(size=(b, d, n)).astype(np.float32))


@pytest.mark.parametrize("n", [1, 8, 16])
@pytest.mark.parametrize("with_dh", [True, False])
def test_scan_bwd_matches_autograd_and_jax_vjp(n, with_dh):
    arrays = _scan_arrays(n, 2, 37, 24, n)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:5]]
    dy = torch.from_numpy(arrays[5])
    dh = torch.from_numpy(arrays[6]) if with_dh else None
    y, h = ref.selective_scan(*ins)
    auto = torch.autograd.grad((y, h), ins,
                               (dy, dh if with_dh else torch.zeros_like(h)))
    got = ref.selective_scan_bwd(*(x.detach() for x in ins), dy, dh)
    _, vjp = jax.vjp(jref.selective_scan, *map(jnp.asarray, arrays[:5]))
    want = vjp((jnp.asarray(arrays[5]),
                jnp.asarray(arrays[6]) if with_dh
                else jnp.zeros(arrays[6].shape, jnp.float32)))
    for g, a, w in zip(got, auto, want):
        _close(g.numpy(), a.numpy())
        _close(g.numpy(), np.asarray(w))


def _f64(*shapes, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g, dtype=torch.float64,
                        requires_grad=True) for s in shapes]


@pytest.mark.parametrize("case", [(2, 5, 5, 4, 2, 4, True, None),
                                  (1, 6, 4, 2, 1, 4, True, 2),
                                  (1, 4, 6, 2, 2, 4, False, 3)])
def test_attention_function_gradcheck(case):
    b, t, s, h, kv, d, causal, window = case
    q, k, v = _f64((b, t, h, d), (b, s, kv, d), (b, s, kv, d))
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: ops.AttentionFn.apply(q_, k_, v_, causal, window),
        (q, k, v))
    # with a softcap (q scaled up so that the cap bends the scores)
    q = (3 * q).detach().requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: ops.AttentionFn.apply(q_, k_, v_, causal, window,
                                                 SOFTCAP), (q, k, v))


@pytest.mark.parametrize("n", [1, 3])
def test_scan_function_gradcheck(n):
    x, b, c = _f64((2, 5, 3), (2, 5, n), (2, 5, n), seed=n)
    g = torch.Generator().manual_seed(7)
    delta = torch.nn.functional.softplus(torch.randn(
        (2, 5, 3), generator=g, dtype=torch.float64)).requires_grad_(True)
    a = (-torch.exp(0.3 * torch.randn((3, n), generator=g,
                                      dtype=torch.float64))).requires_grad_()
    inputs = (delta, x, b, c, a)
    assert torch.autograd.gradcheck(
        lambda *z: ops.SelectiveScanFn.apply(*z), inputs)
    # the gradient of y alone: h_final's comes back as None, read as zeros
    assert torch.autograd.gradcheck(
        lambda *z: ops.SelectiveScanFn.apply(*z)[0], inputs)


def test_ops_route_through_the_functions_only_with_grad():
    qa, ka, va, _ = _attn_arrays(1, 1, 16, 16, 2, 1, 16)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (qa, ka, va))
    with ops.stats_scope() as st:
        out = ops.attention(q, k, v)
        assert type(out.grad_fn).__name__ == "AttentionFnBackward"
        with torch.no_grad():
            assert ops.attention(q, k, v).grad_fn is None
        ops.use_kernels(False)
        try:
            plain = ops.attention(q, k, v)
        finally:
            ops.use_kernels(True)
        assert type(plain.grad_fn).__name__ != "AttentionFnBackward"
        torch.testing.assert_close(out, plain, rtol=0, atol=0)
    assert st.dispatches["attention"] == 3
    arrays = _scan_arrays(2, 1, 8, 4, 2)
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays[:5]]
    y, h = ops.selective_scan(*ins)
    assert type(y.grad_fn).__name__ == "SelectiveScanFnBackward"
    with torch.no_grad():
        assert ops.selective_scan(*ins)[0].grad_fn is None
    assert not _build.KERNEL_LAUNCHES["flash_attention_bwd"]
    assert not _build.KERNEL_LAUNCHES["selective_scan_bwd"]


def test_backward_wrappers_reject_what_the_kernels_do_not_take():
    qa, ka, va, doa = _attn_arrays(3, 1, 8, 8, 2, 1, 16)
    q, k, v, do = map(torch.from_numpy, (qa, ka, va, doa))
    o, lse, _ = ref.attention_lse(q, k, v)
    flash_attention._check_bwd(q, k, v, o, lse, do, None)
    for args, match in [((q, k, v, o, lse[:, :1], do), "lse"),
                        ((q, k, v, o, lse, do.double()), "do"),
                        ((q, k, v, o[:, :4], lse, do), "o")]:
        with pytest.raises(ValueError, match=match):
            flash_attention._check_bwd(*args, None)
    arrays = [torch.from_numpy(a) for a in _scan_arrays(4, 1, 8, 4, 2)]
    selective_scan._check_bwd(*arrays[:6], arrays[6])
    selective_scan._check_bwd(*arrays[:6], None)
    with pytest.raises(ValueError, match="dh_final"):
        selective_scan._check_bwd(*arrays[:6], arrays[6][:, :2])
    with pytest.raises(ValueError, match="dy"):
        selective_scan._check_bwd(*arrays[:5], arrays[5].double(), None)


def _tiles_visited(t, s, causal, window, kv_tile=64, q_step=64):
    """The dK/dV kernels' q-tile walk, as flash_bwd.cuh writes it (64-key
    tiles and 64-row q steps in bf16, 32-row at D = 256; 32-row steps in
    float32, 16 at D = 256): a (q tile, key tile) pair is visited when
    some (row, key) in it is kept or its last row keeps no key."""
    def empty(r):
        k_max = min(r, s - 1) if causal else s - 1
        k_min = max(r - window + 1, 0) if window else 0
        return k_max < k_min
    out = set()
    for k0 in range(0, s, kv_tile):
        k_hi = min(k0 + kv_tile, s) - 1
        for q0 in range(0, t, q_step):
            q_hi = min(q0 + q_step, t) - 1
            pairs = (not causal or k0 <= q_hi) and \
                (not window or k_hi > q0 - window)
            if pairs or empty(q_hi):
                out.add((q0 // q_step, k0 // kv_tile))
    return out


@pytest.mark.parametrize("t,s,causal,window", [
    (512, 512, True, None), (300, 300, True, 128), (100, 77, False, 24),
    (200, 50, True, 16), (70, 130, False, None), (257, 129, True, 1)])
def test_dkdv_tile_walk_covers_every_weighted_pair(t, s, causal, window):
    """Every (q tile, key tile) holding a pair with nonzero P (a kept pair,
    or any key of a row with no key in its band) is visited."""
    import re
    band = ref._band(t, s, causal, window, "cpu").numpy()
    weighted = band | ~band.any(1, keepdims=True)
    src = (_build.CSRC / "flash_bwd.cuh").read_text()
    keys = int(re.search(r"constexpr int kBwdM = (\d+);", src)[1])
    lim, small, large = map(int, re.search(
        r"constexpr int kBwdN = D <= (\d+) \? (\d+) : (\d+);", src).groups())
    assert (keys, lim, small, large) == (64, 128, 64, 32)
    # the bf16 kernel up to D = 128 and at 256, the float32 kernel, the
    # float32 kernel at D = 256
    for kv_tile, q_step in ((keys, small), (keys, large), (64, 32),
                            (16, 16)):
        need = {(i // q_step, j // kv_tile)
                for i, j in zip(*np.nonzero(weighted))}
        assert need <= _tiles_visited(t, s, causal, window, kv_tile, q_step)


@pytest.mark.parametrize("module,src,entry,argtypes", [
    (flash_attention, "flash_attention.cu", "flash_attention_launch",
     "_ARGTYPES"),
    (flash_attention, "flash_attention.cu", "flash_attention_lse_launch",
     "_LSE_ARGTYPES"),
    (flash_attention, "flash_attention_bwd.cu", "flash_attention_bwd_launch",
     "_BWD_ARGTYPES"),
    (selective_scan, "selective_scan_bwd.cu", "selective_scan_bwd_launch",
     "_BWD_ARGTYPES"),
    (selective_scan, "selective_scan.cu", "selective_scan_ckpt_launch",
     "_CKPT_ARGTYPES"),
])
def test_ctypes_signature_matches_the_new_c_entry_points(module, src, entry,
                                                         argtypes):
    """``ctypes`` passes exactly the arguments the training entry points
    declare, pointer for pointer, int for int, float for float (nothing
    compiles here, so read the source)."""
    import ctypes
    import re
    text = (_build.CSRC / src).read_text()
    decl = re.search(rf'extern "C" int {entry}\((.*?)\)', text,
                     re.S).group(1)
    kinds = []
    for param in decl.split(","):
        param = param.strip()
        kinds.append(ctypes.c_void_p if "*" in param else
                     ctypes.c_float if param.startswith("float") else
                     ctypes.c_int)
    assert getattr(module, argtypes) == kinds
