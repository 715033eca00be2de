"""A plain model of the bf16 flash forward of the PyTorch port, held against
the JAX package on the CPU.

``csrc/flash_fwd.cuh``'s ``flash_bf16_kernel`` runs one CTA a (batch x
head, 128-row q tile) as two consumer warpgroups of 64 rows, each walking
the tile's band of keys in tiles of 128 keys (80 at head dim 256) through
`wgmma`: S = Q K^T from bf16 values in float32, scaled to base 2 (capped
first under a softcap), masked element by element only where the band's
edge or S crosses a key tile of the warpgroup's rows, a base-2 online
softmax in float32, P ROUNDED TO bf16 before O += P V; lse and the float32
O at the end.  ``_wgmma_model`` repeats that walk in torch.  It must stay
within ``FLASH_TOL[bfloat16]`` (``chip_smoke.py``, which holds the kernel
to the plain version on the card) of ``ref.attention`` /
``ref.attention_lse`` and of the JAX package's flash kernel in interpret
mode (its plain attention with the cap, ``_sdpa_full``, under a softcap)
on the same bf16 inputs.  The tiles are read from the source.

The kernel itself runs only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402
import re  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import AttnCfg as JAttnCfg  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import HEAD_DIMS  # noqa: E402

BF16_TOL = 2e-2     # FLASH_TOL[bfloat16] in chip_smoke.py
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30         # the mask value
FWD_SRC = (_build.CSRC / "flash_fwd.cuh").read_text()
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may take on an H100


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", FWD_SRC)[1])


def _rule(name, d):
    """The source's ``constexpr int <name> = D <= L ? A : B;`` at ``d``."""
    lim, small, large = map(int, re.search(
        rf"constexpr int {name} = D <= (\d+) \? (\d+) : (\d+);",
        FWD_SRC).groups())
    return small if d <= lim else large


Q_TILE = _const("kTQ")
CONSUMERS = _const("kConsumers")


def _key_tile(d):
    return _rule("kTK", d)


def _band(q0, q_hi, s, causal, window, tile):
    """Keys [k_begin, k_end) the q tile [q0, q_hi] visits (``band()``):
    the band's, k_begin aligned down to the key tile, when the tile's
    last row keeps a key; else every key."""
    k_max = min(q_hi, s - 1) if causal else s - 1
    k_min = max(q_hi - window + 1, 0) if window else 0
    if k_max < k_min:
        return 0, s
    k_begin = max(q0 - window + 1, 0) // tile * tile if window else 0
    return k_begin, (min(s, q_hi + 1) if causal else s)


def _wgmma_model(q, k, v, *, causal, window, softcap=None):
    """What ``flash_bf16_kernel`` computes -> (out in bf16, lse (B,H,T),
    the float32 O), in plain PyTorch."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    tk, half = _key_tile(d), Q_TILE // CONSUMERS
    qf = q.float().permute(0, 2, 1, 3)                          # (B,H,T,D)
    kf, vf = (x.float().repeat_interleave(h // kvh, dim=2)
              .permute(0, 2, 1, 3) for x in (k, v))             # (B,H,S,D)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    o32 = torch.empty((b, h, t, d))
    lse = torch.empty((b, h, t))
    for q0 in range(0, t, Q_TILE):
        q_hi = min(q0 + Q_TILE, t) - 1
        k_begin, k_end = _band(q0, q_hi, s, causal, window, tk)
        for r0 in range(q0, q_hi + 1, half):        # one warpgroup's rows
            w_hi = min(r0 + half, t) - 1
            rows = torch.arange(r0, w_hi + 1)[:, None]
            m = torch.full((b, h, len(rows)), NEG)
            l = torch.zeros((b, h, len(rows)))
            acc = torch.zeros((b, h, len(rows), d))
            for k0 in range(k_begin, k_end, tk):
                kp = torch.arange(k0, k0 + tk)[None, :]
                kt = torch.zeros((b, h, tk, d))
                vt = torch.zeros((b, h, tk, d))
                n = min(tk, s - k0)
                kt[:, :, :n], vt[:, :, :n] = (kf[:, :, k0:k0 + n],
                                              vf[:, :, k0:k0 + n])
                sc = qf[:, :, r0:w_hi + 1] @ kt.transpose(-1, -2)
                if softcap:
                    x = (softcap * LOG2E) * torch.tanh(sc * (scale / softcap))
                else:
                    x = sc * sl2
                inside = (k0 + tk <= s and (not causal or k0 + tk - 1 <= r0)
                          and (not window or k0 > w_hi - window))
                if not inside:
                    keep = torch.ones((len(rows), tk), dtype=torch.bool)
                    if causal:
                        keep = keep & (kp <= rows)
                    if window:
                        keep = keep & (kp > rows - window)
                    x = torch.where(kp >= s, -math.inf,
                                    torch.where(keep, x, NEG))
                mx = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - mx)
                p = torch.exp2(x - mx[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p.bfloat16().float() @ vt
                m = mx
            o32[:, :, r0:w_hi + 1] = acc / l.clamp_min(1e-30)[..., None]
            lse[:, :, r0:w_hi + 1] = torch.where(
                m <= NEG, NEG, (m + torch.log2(l)) * LN2)
    o32 = o32.permute(0, 2, 1, 3)
    return o32.to(q.dtype), lse, o32


def _inputs(t, s, h, kv, d, seed):
    r = np.random.default_rng(seed)
    arrays = [r.normal(size=shape).astype(np.float32)
              for shape in ((2, t, h, d), (2, s, kv, d), (2, s, kv, d))]
    return arrays, [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]


def _jax_out(arrays, q, k, v, *, causal, window, softcap):
    """The JAX package on the same bf16 inputs: its flash kernel in
    interpret mode (blocks of 64 where they divide T and S), or its plain
    attention with the cap under a softcap."""
    t, s = q.shape[1], k.shape[1]
    if not softcap:
        jin = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
        return np.asarray(jax_flash(
            *jin, causal=causal, window=window,
            block_q=64 if t % 64 == 0 else t,
            block_k=64 if s % 64 == 0 else s), np.float32)
    h, kv, d = q.shape[2], k.shape[2], q.shape[3]
    cfg = JAttnCfg(n_heads=h, n_kv=kv, head_dim=d, window=window,
                   causal=causal, softcap=softcap)
    qpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (2, t))
    kpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s))
    jin = [jnp.asarray(x.float().numpy()) for x in (q, k, v)]
    return np.asarray(jattn._sdpa_full(*jin, qpos, kpos, cfg), np.float32)


@pytest.mark.parametrize("t,s,h,kv,d,causal,window,softcap", [
    (256, 256, 4, 1, 64, True, None, None),     # two q tiles, GQA 4:1
    (300, 300, 4, 1, 64, True, 128, None),      # window shorter than T
    (128, 200, 2, 2, 64, False, None, None),    # T != S, non-causal
    (200, 77, 4, 2, 80, False, 24, None),       # D = 80 (64 + 16), ragged S
    (300, 300, 4, 1, 80, True, 128, None),      # h2o's head dim, windowed
    (200, 50, 2, 1, 80, True, 16, None),        # rows with no key
    (97, 161, 4, 1, 128, True, None, None),     # ragged T < S, causal
    (300, 300, 2, 1, 128, True, 100, None),     # window off the key tiles
    (200, 200, 2, 1, 256, True, None, None),    # 64-key tiles at D = 256
    (130, 70, 2, 1, 256, False, 24, None),      # T > S, non-causal window
    (200, 50, 2, 1, 256, True, 16, None),       # rows with no key, D = 256
    (100, 100, 4, 2, 64, True, None, 2.0),      # softcap at D = 64
    (300, 300, 4, 2, 256, True, 128, 2.0),      # softcap at D = 256
    (100, 77, 4, 2, 16, False, 24, None),       # the small head dims: a
    (256, 256, 2, 2, 32, True, 32, None),       # 16- or 32-column tail
])
def test_wgmma_model_is_inside_the_bf16_tolerance(t, s, h, kv, d, causal,
                                                  window, softcap):
    """The kernel's walk (128-row q tiles in two 64-row halves, the key
    tile of its head dim, the band aligned to it, masks only where needed,
    P rounded to bf16) gives the output, lse and float32 O within
    ``FLASH_TOL[bfloat16]`` of ``ref.attention_lse`` and the output within
    it of the JAX package, on the same bf16 inputs."""
    arrays, (q, k, v) = _inputs(t, s, h, kv, d, t + s + d)
    mask = dict(causal=causal, window=window, softcap=softcap)
    got, lse, o32 = _wgmma_model(q, k, v, **mask)
    assert got.dtype == torch.bfloat16
    want, want_lse, want_o32 = ref.attention_lse(q, k, v, **mask)
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=BF16_TOL)
    np.testing.assert_allclose(o32.numpy(), want_o32.numpy(), atol=BF16_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=BF16_TOL)
    # a row with no key in its band: lse exactly the mask value
    np.testing.assert_array_equal(lse.numpy() <= NEG,
                                  want_lse.numpy() <= NEG)
    np.testing.assert_allclose(
        got.float().numpy(), _jax_out(arrays, q, k, v, **mask),
        atol=BF16_TOL)
    # the rounding is real: the model is not the float32 reference itself
    exact = ref.attention(q.float(), k.float(), v.float(), **mask)
    assert float((o32 - exact).abs().max()) > 0


def _tiles_visited(t, s, causal, window, tk):
    """(q tile, key tile) pairs the kernel's walk visits."""
    out = set()
    for q0 in range(0, t, Q_TILE):
        k_begin, k_end = _band(q0, min(q0 + Q_TILE, t) - 1, s, causal,
                               window, tk)
        out |= {(q0 // Q_TILE, k0 // tk)
                for k0 in range(k_begin, k_end, tk)}
    return out


@pytest.mark.parametrize("t,s,causal,window", [
    (512, 512, True, None), (300, 300, True, 128), (100, 77, False, 24),
    (200, 50, True, 16), (70, 130, False, None), (257, 129, True, 1),
    (1000, 1000, True, 300), (640, 384, True, 64)])
def test_wgmma_walk_skips_only_zero_weights(t, s, causal, window):
    """Every (q tile, key tile) holding a pair of nonzero weight (a kept
    pair, or any key of a row with no key in its band) is visited, at each
    head dim's key tile; a q tile with such a row visits every key."""
    band = ref._band(t, s, causal, window, "cpu").numpy()
    empty = ~band.any(1)
    weighted = band | empty[:, None]
    for tk in sorted({_key_tile(d) for d in HEAD_DIMS}):
        need = {(i // Q_TILE, j // tk) for i, j in zip(*np.nonzero(weighted))}
        seen = _tiles_visited(t, s, causal, window, tk)
        assert need <= seen
        for q0 in range(0, t, Q_TILE):
            if empty[q0:q0 + Q_TILE].any():
                assert {(q0 // Q_TILE, j) for j in range(-(-s // tk))} <= seen


def test_flash_fwd_tiles_match_the_kernel():
    """The model's tiles are the kernel's (read from the source): 128-row
    q tiles over two 64-row consumer warpgroups, 128-key tiles up to
    D = 128 and 80 at 256; every head dim the wrapper takes is built in
    64-column chunks and a 16- or 32-column tail (D = 80 is 64 + 16), and
    its stage fits an H100's shared memory."""
    assert Q_TILE == 128 and CONSUMERS == 2 and Q_TILE // CONSUMERS == 64
    assert HEAD_DIMS == (16, 32, 64, 80, 128, 256)
    assert {d: _key_tile(d) for d in HEAD_DIMS} == {
        16: 128, 32: 128, 64: 128, 80: 128, 128: 128, 256: 80}
    assert "constexpr int kWide = D / 64;" in FWD_SRC
    assert "constexpr int kTail = D % 64;" in FWD_SRC
    chunks = {d: [64] * (d // 64) + ([d % 64] if d % 64 else [])
              for d in HEAD_DIMS}
    assert chunks[80] == [64, 16] and chunks[256] == [64] * 4
    assert all(c in (16, 32, 64) for cs in chunks.values() for c in cs)
    entries = (_build.CSRC / "flash_attention.cu").read_text()
    for d in HEAD_DIMS:
        assert f"case {d}:" in entries
        tu = (_build.CSRC / f"flash_fwd_d{d}.cu").read_text()
        assert f"return launch<{d}>(a);" in tu
        stages = _rule("kStages", d)
        smem = 2 * d * (Q_TILE + 2 * stages * _key_tile(d)) + 2 * 1024
        assert smem <= SMEM_LIMIT, (d, smem)
    # the consumer warpgroups and a producer, registers moved over
    threads = 128 * (CONSUMERS + 1)
    assert threads * 168 >= 128 * _const("kProducerRegs") \
        + CONSUMERS * 128 * _const("kConsumerRegs")
