"""A plain model of the bf16 flash backward of the PyTorch port (``wgmma``
fed by TMA, warp-specialised: ``csrc/flash_bwd.cuh``), held against the JAX
package on the CPU.

``tests/_torch_flash_bwd_model.py`` repeats the two kernels' tile walks
(64-key dK/dV CTAs whose two consumers take every other q tile of the walk
and sum their partials in a fixed order; 128-row dQ CTAs of two 64-row
consumers over the band's key tiles), their masks and their two-term bf16
operands for P and dS.  The model must stay within 2^-8 of each gradient's
scale (``FLASH_BWD_RTOL[bfloat16]`` in ``chip_smoke.py``, which holds the
kernels to ``ref.attention_bwd`` on the card) of ``ref.attention_bwd`` and
of a jitted ``jax.vjp`` of the JAX package's plain attention, on the same
bf16 inputs, at reduced shapes: GQA, windows with rows that keep no key,
T and S off the tiles, T < S under a causal mask, a softcap, and head dims
16, 64, 80, 128 and 256.  The walks must cover every weighted pair, the
split's fixed-order sum must give the same bits whatever the timing, and
the tiles are read from the sources.

The kernels themselves run only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import random  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_flash_bwd_model as model  # noqa: E402
from repro.configs.base import AttnCfg as JAttnCfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402

FLASH_BWD_RTOL = 2 ** -8    # chip_smoke.py, bf16 gradients
SMEM_LIMIT = 232448         # bytes of shared memory a CTA may take (H100)


def _share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(b, t, s, h, kv, d, seed):
    r = np.random.default_rng(seed)
    arrays = [r.normal(size=shape).astype(np.float32)
              for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d),
                            (b, t, h, d))]
    return arrays, [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _jax_grads(q, k, v, do, *, causal, window, softcap):
    """``jax.vjp`` of the JAX package's plain attention (with the cap,
    ``_sdpa_full``, under a softcap), jitted, on the same bf16 values in
    float32: the exact gradient of the kernel's inputs (a vjp in bf16 adds
    roundings of its own, up to 0.005 of dQ's scale at these shapes)."""
    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if softcap:
        cfg = JAttnCfg(n_heads=h, n_kv=kv, head_dim=d, window=window,
                       causal=causal, softcap=softcap)
        qpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (b, t))
        kpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))

        def plain(a, b_, c):
            return jattn._sdpa_full(a, b_, c, qpos, kpos, cfg)
    else:
        def plain(a, b_, c):
            return jref.attention(a, b_, c, causal=causal, window=window)
    jin = [jnp.asarray(x.float().numpy()) for x in (q, k, v, do)]

    @jax.jit
    def grads(q_, k_, v_, do_):
        _, vjp = jax.vjp(plain, q_, k_, v_)
        return vjp(do_)
    return [np.asarray(g, np.float32) for g in grads(*jin)]


@pytest.mark.parametrize("b,t,s,h,kv,d,causal,window,softcap", [
    (2, 100, 100, 4, 2, 16, True, None, None),     # D = 16, ragged T
    (1, 150, 40, 2, 1, 16, False, 8, None),        # T > S, window < S
    (2, 128, 128, 8, 2, 64, True, None, None),     # llama's GQA, cut
    (1, 200, 50, 2, 1, 64, True, 16, None),        # rows with no key
    (1, 97, 161, 4, 1, 64, True, None, None),      # T < S, causal
    (1, 200, 200, 4, 1, 80, True, 72, None),       # h2o's D, window < T
    (2, 100, 77, 4, 2, 80, False, 24, None),       # S off the tiles
    (1, 130, 130, 8, 1, 128, True, None, None),    # qwen2-vl's D, 8:1
    (1, 150, 90, 2, 1, 128, False, 40, None),      # T != S, windowed
    (1, 130, 130, 4, 2, 256, True, None, None),    # gemma3's D, 32-row steps
    (1, 150, 150, 2, 1, 256, True, 40, 2.0),       # D = 256, window, softcap
    (1, 100, 100, 4, 2, 64, True, None, 2.0),      # softcap at D = 64
])
def test_wgmma_bwd_model_is_inside_the_bf16_tolerance(b, t, s, h, kv, d,
                                                      causal, window,
                                                      softcap):
    """The kernels' walks, masks and roundings (P and dS as two bf16 terms,
    the gradients at the store) keep every gradient within 2^-8 of its
    scale of ``ref.attention_bwd`` and of ``jax.vjp`` of the JAX package's
    plain attention, on the same bf16 inputs."""
    _, (q, k, v, do) = _inputs(b, t, s, h, kv, d, t + s + d)
    mask = dict(causal=causal, window=window, softcap=softcap)
    o32, lse, _ = ref.attention_lse(q.float(), k.float(), v.float(), **mask)
    got = model.flash_bwd_bf16_model(q, k, v, o32, lse, do, **mask)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = ref.attention_bwd(q.float(), k.float(), v.float(), o32, lse,
                             do.float(), **mask)
    for g, w in zip(got, want):
        assert _share(g.float(), w) <= FLASH_BWD_RTOL
    for g, j in zip(got, _jax_grads(q, k, v, do, **mask)):
        assert _share(g.float(), j) <= FLASH_BWD_RTOL
    # the rounding is real: the model is not the float32 reference itself
    assert max(float((g.float() - w).abs().max())
               for g, w in zip(got, want)) > 0


WALK_CASES = [
    (512, 512, True, None), (300, 300, True, 128), (100, 77, False, 24),
    (200, 50, True, 16), (70, 130, False, None), (257, 129, True, 1),
    (97, 161, True, None), (1000, 1000, True, 300)]


@pytest.mark.parametrize("t,s,causal,window", WALK_CASES)
def test_wgmma_bwd_walks_cover_every_weighted_pair(t, s, causal, window):
    """At every head dim's step: the dK/dV walk visits every (q tile, key
    tile) holding a pair of nonzero P (a kept pair, or any key of a row
    with no key in its band), and the dQ consumers every (64-row half, key
    tile) holding a kept pair, so a skipped tile adds exactly 0."""
    band = ref._band(t, s, causal, window, "cpu").numpy()
    weighted = band | ~band.any(1, keepdims=True)
    for d in HEAD_DIMS:
        n = model.step(d)
        dkdv, dq = model.visited_pairs(t, s, causal, window, d)
        rows, keys = np.nonzero(weighted)
        need = {(i // n * n, j // model.KEYS * model.KEYS)
                for i, j in zip(rows, keys)}
        assert need <= dkdv, d
        rows, keys = np.nonzero(band)
        need = {(i // model.HALF * model.HALF, j // n * n)
                for i, j in zip(rows, keys)}
        assert need <= dq, d
        if causal and t == s and t > 2 * model.Q_TILE:
            # the diagonal's upper half is skipped by the dQ consumers
            full = {(qw0, kb) for qw0 in range(0, t, model.HALF)
                    for kb in range(0, s, n) if kb <= qw0 + model.HALF}
            assert not full <= dq


@pytest.mark.parametrize("t,s,h,kv,d,causal,window", [
    (200, 200, 4, 2, 64, True, None), (150, 90, 2, 1, 256, False, 40)])
def test_wgmma_bwd_split_sum_is_the_same_in_any_interleaving(t, s, h, kv, d,
                                                             causal, window):
    """The two dK/dV consumers' partial sums, each over its own tiles in
    walk order and added in a fixed order at the end, give the same bits
    whatever the interleaving of their turns: the backward stays
    deterministic."""
    _, (q, k, v, do) = _inputs(1, t, s, h, kv, d, 7)
    mask = dict(causal=causal, window=window)
    o32, lse, _ = ref.attention_lse(q.float(), k.float(), v.float(), **mask)
    first = model.flash_bwd_bf16_model(q, k, v, o32, lse, do, **mask)
    for seed in range(3):
        again = model.flash_bwd_bf16_model(q, k, v, o32, lse, do, **mask,
                                           interleave=random.Random(seed))
        for x, y in zip(first, again):
            assert torch.equal(x, y)


def test_wgmma_bwd_tiles_match_the_kernels():
    """The model's tiles are the kernels' (read from the sources): 64-key
    dK/dV CTAs and 128-row dQ CTAs over two 64-row consumers, steps of 64
    rows or keys (32 at D = 256), every head dim in its own translation
    unit and its shared memory within an H100's; the bf16 backward is
    `wgmma` fed by TMA, with no `mma.sync` left, and runs as a dV pass and
    a dK pass past D = 128."""
    src = model.BWD_SRC
    assert model.KEYS == 64 and model.Q_TILE == 128 and model.HALF == 64
    assert HEAD_DIMS == (16, 32, 64, 80, 128, 256)
    assert {d: model.step(d) for d in HEAD_DIMS} == {
        16: 64, 32: 64, 64: 64, 80: 64, 128: 64, 256: 32}
    entries = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    kv_stages, q_stages = model.const("kDkdvStages"), model.const("kDqStages")

    def smem(n_bytes):              # the stage aligned to 1,024, and 1,024
        return -(-n_bytes // 1024) * 1024 + 1024
    for d in HEAD_DIMS:
        assert f"case {d}:" in entries
        tu = (_build.CSRC / f"flash_bwd_d{d}.cu").read_text()
        assert f"return bwd_launch<{d}>(a);" in tu
        n = model.step(d)
        # dK/dV: the Q/dO ring, K and V, each consumer's two buffers of lse
        # and D, the barriers; dQ: Q,
        # dO, the K/V ring, the barriers
        dkdv = (kv_stages * 2 * n * d * 2 + 2 * model.KEYS * d * 2
                + model.CONSUMERS * 2 * 2 * n * 4
                + 8 * (1 + model.CONSUMERS + 2 * kv_stages))
        dq = (2 * model.Q_TILE * d * 2 + q_stages * 2 * n * d * 2
              + 8 * (1 + 2 * q_stages))
        assert max(smem(dkdv), smem(dq)) <= SMEM_LIMIT, d
        # consumer 1's partial sums fit the consumed Q/dO ring
        accs = 1 if d > 128 else 2
        assert 128 * accs * d // 2 * 4 <= kv_stages * 2 * n * d * 2
    assert re.search(r"if constexpr \(D <= 128\) \{\s*err = launch_dkdv_bf16"
                     r"<D, kDkdvBoth, kCap>", src)
    assert "launch_dkdv_bf16<D, kDkdvOnlyDv, kCap>" in src
    assert "launch_dkdv_bf16<D, kDkdvOnlyDk, kCap>" in src
    for text in (src, entries):
        assert "mma.sync" not in text and "mma_bf16(" not in text
    assert "Wgmma<N>::ss" in src and "issue_pv_step<D, N>" in src
    assert src.count("load_tile<D,") >= 6          # TMA loads, both kernels
