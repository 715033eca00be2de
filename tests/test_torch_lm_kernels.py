"""The PyTorch port's LM kernels against the JAX package: the plain
versions of flash attention and the Mamba1 selective scan, and the
``ops`` wrappers that route to them on the CPU, held against the JAX
package's Pallas kernels run in interpret mode, on the grids of
``tests/test_kernels.py`` and at its tolerances (2e-5 in float32, 2e-2 in
bfloat16 for attention; 1e-4 for the scan): the same float32 arithmetic,
summed in another order.  The CUDA kernels themselves run only on the card
(``chip_smoke.py`` holds them against these same plain versions)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.kernels.selective_scan import selective_scan as jax_scan  # noqa: E402
from repro.models import mamba as jax_mamba  # noqa: E402
from repro_torch.kernels import (_build, block_sort, flash_attention,  # noqa: E402
                                 hail_reader, index_search, ops, pax_scan,
                                 ref, selective_scan)

F32_TOL = 2e-5      # tests/test_kernels.py, flash attention in float32
BF16_TOL = 2e-2     # tests/test_kernels.py, flash attention in bfloat16
SCAN_TOL = 1e-4     # tests/test_kernels.py, selective scan


def _attn_inputs(seed, b, t, s, h, kv, d):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d))]


def _port_attention(arrays, dtype=torch.float32, **kw):
    """The port's plain version and its ``ops`` wrapper on CPU tensors."""
    q, k, v = (torch.from_numpy(a).to(dtype) for a in arrays)
    return ref.attention(q, k, v, **kw), ops.attention(q, k, v, **kw)


@pytest.mark.parametrize("t,s,h,kv,d", [(128, 128, 4, 4, 32),
                                        (256, 256, 4, 2, 64),
                                        (128, 256, 8, 2, 32)])
def test_attention_shapes_match_jax_flash(t, s, h, kv, d):
    arrays = _attn_inputs(t + h, 2, t, s, h, kv, d)
    want = np.asarray(jax_flash(*map(jnp.asarray, arrays), causal=False,
                                block_q=64, block_k=64))
    for got in _port_attention(arrays, causal=False):
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)


@pytest.mark.parametrize("window", [None, 32, 128])
def test_attention_masks_match_jax_flash(window):
    arrays = _attn_inputs(3, 1, 256, 256, 2, 2, 32)
    want = np.asarray(jax_flash(*map(jnp.asarray, arrays), causal=True,
                                window=window, block_q=64, block_k=64))
    for got in _port_attention(arrays, causal=True, window=window):
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL,
                                   rtol=F32_TOL)


def test_attention_bf16_matches_jax_flash():
    """bfloat16 in, bfloat16 out: both sides compute in float32 and round
    the output once."""
    arrays = _attn_inputs(5, 1, 128, 128, 4, 2, 64)
    jin = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    want = np.asarray(jax_flash(*jin, block_q=64, block_k=64), np.float32)
    for got in _port_attention(arrays, dtype=torch.bfloat16):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL)


def test_attention_gqa_maps_q_head_to_kv_head_h_div_rep():
    """q head h reads kv head h // rep (not h % KV): with the kv heads made
    distinct, each q head's output equals single-head attention on its own
    kv head."""
    arrays = _attn_inputs(9, 1, 64, 64, 4, 2, 16)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    out = ops.attention(q, k, v, causal=True)
    for h in range(4):
        g = h // 2
        one = ref.attention(q[:, :, h:h + 1], k[:, :, g:g + 1],
                            v[:, :, g:g + 1], causal=True)
        torch.testing.assert_close(out[:, :, h:h + 1], one, rtol=0, atol=0)


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
                                              (48, 8, 8, 16, 8)])
def test_selective_scan_matches_jax_kernel(t, d, n, chunk, dblk):
    arrays = _scan_inputs(t + d, 2, t, d, n)
    wy, wh = jax_scan(*map(jnp.asarray, arrays), chunk=chunk, d_block=dblk)
    tensors = [torch.from_numpy(a) for a in arrays]
    for fn in (ref.selective_scan, ops.selective_scan):
        y, h = fn(*tensors)
        assert y.dtype == torch.float32 and h.shape == (2, d, n)
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SCAN_TOL,
                                   rtol=SCAN_TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=SCAN_TOL,
                                   rtol=SCAN_TOL)


def test_selective_scan_matches_mamba1_layer_math():
    """The port's scan computes the recurrence the JAX mamba1 layer runs
    (its chunk scan from a zero state, then y = sum_N h C)."""
    delta, x, bm, cm, _ = _scan_inputs(1, 1, 16, 8, 4)
    a = -np.exp(np.zeros((8, 4), np.float32))
    aa = jnp.exp(jnp.asarray(delta)[..., None] * a)
    bb = jnp.asarray(delta * x)[..., None] * jnp.asarray(bm)[:, :, None, :]
    h_all = jax_mamba._m1_scan_chunk(jnp.zeros((1, 8, 4)), aa, bb)
    want = np.asarray(jnp.einsum("btdn,btn->btd", h_all, cm))
    got, h = ops.selective_scan(*(torch.from_numpy(v)
                                  for v in (delta, x, bm, cm, a)))
    np.testing.assert_allclose(got.numpy(), want, atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_all[:, -1]),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


def test_cpu_route_counts_dispatches_not_launches():
    """On the CPU each wrapper call is one dispatch and no kernel launch;
    ``use_kernels(False)`` takes the plain versions with the same counts."""
    q = torch.zeros((1, 8, 2, 16))
    k = v = torch.zeros((1, 8, 1, 16))
    scan_in = [torch.from_numpy(a) for a in _scan_inputs(0, 1, 8, 4, 2)]
    launches = dict(_build.KERNEL_LAUNCHES)
    with ops.stats_scope() as s:
        ops.attention(q, k, v)
        ops.selective_scan(*scan_in)
        ops.use_kernels(False)
        try:
            ops.attention(q, k, v, causal=False, window=4)
            ops.selective_scan(*scan_in)
        finally:
            ops.use_kernels(True)
    assert s.dispatches["attention"] == 2
    assert s.dispatches["selective_scan"] == 2
    assert not s.traces      # no kernel variant was selected on the CPU
    assert dict(_build.KERNEL_LAUNCHES) == launches


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32 or all bfloat16"),
    ("head_dim", "head dim"),
    ("gqa", "inconsistent shapes"),
    ("layout", "contiguous"),
    ("window", "window"),
    ("align", "16-byte boundaries"),
    ("softcap", "softcap"),
])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    """The checks run before any launch, so they hold on the CPU too."""
    q = torch.zeros((1, 8, 4, 16))
    k = torch.zeros((1, 8, 2, 16))
    v = torch.zeros((1, 8, 2, 16))
    window = softcap = None
    if bad == "dtype":
        k = k.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v = (t.new_zeros(t.shape[:3] + (24,)) for t in (q, k, v))
    elif bad == "gqa":
        k = v = torch.zeros((1, 8, 3, 16))
    elif bad == "layout":
        q = torch.zeros((1, 4, 8, 16)).transpose(1, 2)
    elif bad == "align":     # a contiguous bf16 view 2 bytes into its buffer
        q, k, v = (torch.zeros(t.numel() + 1, dtype=torch.bfloat16)[1:]
                   .view(t.shape) for t in (q, k, v))
    elif bad == "softcap":
        softcap = -1.0
    else:
        window = 0
    with pytest.raises(ValueError, match=match):
        flash_attention._check(q, k, v, window, softcap)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32"),
    ("state", "state size"),
    ("shape", "inconsistent shapes"),
])
def test_scan_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    delta, x, bm, cm, a = (torch.from_numpy(v)
                           for v in _scan_inputs(0, 1, 8, 4, 2))
    if bad == "dtype":
        x = x.double()
    elif bad == "state":
        bm = cm = torch.zeros((1, 8, 17))
        a = torch.zeros((4, 17))
    else:
        a = torch.zeros((5, 2))
    with pytest.raises(ValueError, match=match):
        selective_scan._check(delta, x, bm, cm, a)



@pytest.mark.parametrize("module,entry", [
    (flash_attention, "flash_attention_launch"),
    (selective_scan, "selective_scan_launch"),
    (hail_reader, "hail_read_launch"),
    (block_sort, "bitonic_sort_launch"),
    (index_search, "index_search_launch"),
    (pax_scan, "pax_scan_launch"),
])
def test_ctypes_signature_matches_the_c_entry_point(module, entry):
    """``ctypes`` passes exactly the arguments the C entry point declares,
    pointer for pointer, int for int, float for float (nothing compiles
    here, so read the source)."""
    import ctypes
    import re
    src = (_build.CSRC / f"{module.__name__.rsplit('.', 1)[1]}.cu").read_text()
    decl = re.search(rf'extern "C" int {entry}\((.*?)\)', src, re.S).group(1)
    kinds = []
    for param in decl.split(","):
        param = param.strip()
        kinds.append(ctypes.c_void_p if "*" in param else
                     ctypes.c_float if param.startswith("float") else
                     ctypes.c_int)
    assert module._ARGTYPES == kinds
