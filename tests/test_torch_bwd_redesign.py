"""Plain models of the arithmetic of the two training backward kernels of
the PyTorch port, held against the JAX package on the CPU.

``csrc/flash_bwd.cuh`` runs bfloat16 on the tensor cores (``wgmma`` fed
by TMA, warp-specialised): a dK/dV kernel over 64-key tiles whose two
consumer warpgroups take every other q tile of the walk (the group's q
heads, the band's tiles of 64 rows, 32 at D = 256; at D = 256 as two
launches, a dV pass and a dK pass, each accumulating one of the two with
the same arithmetic) and add their partial sums in a fixed order, and a
dQ kernel over 128-row q tiles of two 64-row consumers that walk the
band's key tiles, at head dims 16 to 256 (h2o-danube's 80, qwen2-vl's
128, gemma3's 256), under windows shorter than T and under gemma3's
softcap c (S capped at c tanh(s/c), dS times 1 - tanh^2).
``tests/_torch_flash_bwd_model.py`` repeats that in torch: products of
bf16 values accumulated in float32, P = 2^(S scale log2(e) - lse
log2(e)), P and dS ROUNDED TO TWO bf16 TERMS each before their products
(hi = bf16(x), lo = bf16(x - hi), one product each), the scale applied to
dK and dQ in float32 at the store.  It must stay within 2^-8 of each
gradient's scale of ``ref.attention_bwd`` and of ``jax.vjp`` of the JAX
package's plain attention on the same bf16 inputs
(``FLASH_BWD_RTOL[bfloat16]`` in ``chip_smoke.py``, which holds the
kernel to ``ref.attention_bwd`` on the card).  One bf16 term alone does
not: ``terms=1`` puts dV or dQ past 2^-8 of its scale at these shapes.

``csrc/selective_scan_bwd.cu`` splits each channel's N states over L lanes
(two channels a lane, 128 channels a CTA), starts every 8-step interval
from the training forward's checkpoint (``csrc/selective_scan.cu`` writes
h there with the forward's own arithmetic), recomputes the interval's
states and factors with exp2 of the prescaled A once, and sums over N and
over channels by transposing shuffle butterflies, then over warps and CTAs
in order, walking the intervals once from the last.  ``_scan_train_model``
repeats the training forward's checkpoints and ``_scan_bwd_model`` the
backward's order in float32 numpy; they are held to
``ref.selective_scan_states`` within 1e-5 of the states' scale and to
``ref.selective_scan_bwd`` at the backward's tolerance, 1e-4 of each
gradient's scale (``SCAN_BWD_RTOL``), at the interval as built and at
16 steps (the variant with two 8-step parts an interval).

The kernels themselves run only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_flash_bwd_model as model  # noqa: E402
from repro.configs.base import AttnCfg as JAttnCfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import _build, ref, selective_scan  # noqa: E402

FLASH_BWD_RTOL = 2 ** -8    # chip_smoke.py, bf16 gradients
SCAN_BWD_RTOL = 1e-4        # chip_smoke.py, the scan's gradients
LOG2E = 1.4426950408889634


def _share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# flash attention's backward in bf16 on the tensor cores
# ---------------------------------------------------------------------------

_flash_bwd_bf16_model = model.flash_bwd_bf16_model


@pytest.mark.parametrize("t,s,h,kv,d,causal,window,softcap", [
    (128, 128, 8, 2, 64, True, None, None),   # llama's GQA and head dim, cut
    (100, 100, 4, 2, 16, True, None, None),   # the reduced llama, ragged T
    (100, 77, 4, 2, 32, False, 24, None),     # ragged S, non-causal window
    (200, 50, 2, 1, 64, True, 16, None),      # rows with no key in the band
    (200, 200, 4, 1, 80, True, 72, None),     # h2o-danube's head dim, a
                                              # window shorter than T, 4:1
    (130, 130, 8, 1, 128, True, None, None),  # qwen2-vl's head dim, 8:1
    (150, 90, 2, 1, 128, False, 40, None),    # T != S, windowed, D = 128
    (130, 130, 4, 2, 256, True, None, None),  # gemma3's head dim, GQA 2:1
    (150, 150, 2, 1, 256, True, 40, 2.0),     # D = 256, a window < T and
                                              # a softcap
])
def test_flash_bwd_bf16_design_is_inside_the_bf16_tolerance(
        t, s, h, kv, d, causal, window, softcap):
    """The tensor-core backward's roundings (P and dS to two bf16 terms
    before their products, the gradients at the store) keep every gradient
    within 2^-8 of its scale of ``ref.attention_bwd`` and of ``jax.vjp`` of
    the JAX package's plain attention (``_sdpa_full`` with the cap, for a
    softcap), on the same bf16 inputs; one bf16 term for P and dS would
    not."""
    r = np.random.default_rng(t + s + d)
    arrays = [r.normal(size=shape).astype(np.float32)
              for shape in ((2, t, h, d), (2, s, kv, d), (2, s, kv, d),
                            (2, t, h, d))]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    mask = dict(causal=causal, window=window, softcap=softcap)
    o32, lse, _ = ref.attention_lse(q.float(), k.float(), v.float(), **mask)
    o = o32.to(torch.bfloat16)      # what the bf16 forward hands over
    got = _flash_bwd_bf16_model(q, k, v, o, lse, do, **mask)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = ref.attention_bwd(q, k, v, o, lse, do, **mask)
    for g, w in zip(got, want):
        assert _share(g.float(), w.float()) <= FLASH_BWD_RTOL
    # jax.vjp differentiates through the float32 output before its rounding
    # to bf16 (from the rounded one, D = rowsum(dO O) alone moves dQ and dK
    # by up to 0.005 of their scale here): the model takes that output
    if softcap:
        cfg = JAttnCfg(n_heads=h, n_kv=kv, head_dim=d, window=window,
                       causal=causal, softcap=softcap)
        qpos = jnp.broadcast_to(jnp.arange(t, dtype=jnp.int32), (2, t))
        kpos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (2, s))

        def plain(a, b_, c):
            return jattn._sdpa_full(a, b_, c, qpos, kpos, cfg)
        # the same bf16 values, in float32 (_sdpa_full computes its
        # scores in the inputs' dtype)
        jin = [jnp.asarray(x.float().numpy()) for x in (q, k, v, do)]
    else:
        def plain(a, b_, c):
            return jref.attention(a, b_, c, causal=causal, window=window)
        jin = [jnp.asarray(a, jnp.bfloat16) for a in arrays]

    @jax.jit
    def jax_grads(q_, k_, v_, do_):
        _, vjp = jax.vjp(plain, q_, k_, v_)
        return vjp(do_)

    got32 = _flash_bwd_bf16_model(q, k, v, o32, lse, do, **mask)
    for g, j in zip(got32, jax_grads(*jin)):
        assert _share(g.float(), np.asarray(j, np.float32)) <= FLASH_BWD_RTOL
    # the rounding is real: the model is not the float32 reference itself
    exact = ref.attention_bwd(q.float(), k.float(), v.float(), o.float(),
                              lse, do.float(), **mask)
    for g, e in zip(got, exact):
        assert float((g.float() - e).abs().max()) > 0
    # and one bf16 term would put some gradient past the tolerance
    one = _flash_bwd_bf16_model(q, k, v, o, lse, do, terms=1, **mask)
    assert max(_share(g.float(), w.float())
               for g, w in zip(one, want)) > FLASH_BWD_RTOL


@pytest.mark.parametrize("t,s,causal,window", [
    (512, 512, True, None), (300, 300, True, 128), (100, 77, False, 24),
    (200, 50, True, 16), (70, 130, False, None), (257, 129, True, 1),
    (1024, 1024, True, 512), (1000, 1000, True, 300)])
def test_dkdv_walk_covers_every_kept_pair(t, s, causal, window):
    """The dK/dV kernel's walk (``dkdv_visit``, 64-key tiles, q tiles of 64
    rows or 32 at D = 256) reaches exactly the q tiles that hold a kept
    pair of its key tile or a row with no key in its band, so under a
    window shorter than T it skips the tiles outside the band (h2o-danube
    trains on T = 2 windows)."""
    band = ref._band(t, s, causal, window, "cpu").numpy()
    for n in sorted({model.step(d) for d in (64, 256)}):
        skipped = 0
        for k0 in range(0, s, model.KEYS):
            k_hi = min(k0 + model.KEYS, s) - 1
            walk = model.dkdv_walk(t, s, k0, n, causal, window)
            for q0 in range(0, t, n):
                q_hi = min(q0 + n, t) - 1
                needed = band[q0:q_hi + 1, k0:k_hi + 1].any() or \
                    not band[q0:q_hi + 1].any(1).all()
                assert (q0 in walk) == needed, (n, k0, q0)
                skipped += q0 not in walk
        if causal and window and t == s and t >= 2 * window:
            assert skipped > 0          # the tiles before the band


@pytest.mark.parametrize("t,s,causal,window", [
    (512, 512, True, None), (300, 300, True, 128), (100, 77, False, 24),
    (200, 50, True, 16), (70, 130, False, None), (257, 129, True, 1),
    (1024, 1024, True, 512), (1000, 1000, True, 300)])
def test_dq_walk_covers_every_kept_pair(t, s, causal, window):
    """The dQ kernel's band of key tiles holds every kept pair of each
    128-row q tile, and each 64-row consumer skips only key tiles with no
    kept pair of its rows (rows with no key in their band get dQ = 0 and
    need none)."""
    band = ref._band(t, s, causal, window, "cpu").numpy()
    for n in sorted({model.step(d) for d in (64, 256)}):
        for q0 in range(0, t, model.Q_TILE):
            q_hi = min(q0 + model.Q_TILE, t) - 1
            tiles = model.dq_band(q0, q_hi, s, causal, window, n)
            cols = np.nonzero(band[q0:q_hi + 1].any(0))[0]
            assert cols.size == 0 or (cols.min() >= tiles[0]
                                      and cols.max() < tiles[-1] + n)
            for qw0 in range(q0, q_hi + 1, model.HALF):
                qw_hi = min(qw0 + model.HALF, t) - 1
                for kb in tiles:
                    if not model.dq_works(qw0, qw_hi, kb, n, t, causal,
                                          window):
                        assert not band[qw0:qw_hi + 1, kb:kb + n].any()


# ---------------------------------------------------------------------------
# the Mamba1 scan's backward with its states over lanes
# ---------------------------------------------------------------------------

F32 = np.float32
LOG2E32, LN2 = F32(LOG2E), F32(0.6931471805599453)


def _lanes_for(n):
    """Lanes a channel's states are split over (csrc ``lanes_for``)."""
    return 4 if n >= 10 else 2 if n >= 5 else 1


def _tree(v, axis):
    """Sum over ``axis`` (a power of two) as the butterflies do: entries
    that differ in the highest bit first, then the next."""
    v = np.moveaxis(v, axis, -1)
    while v.shape[-1] > 1:
        m = v.shape[-1] // 2
        v = (v[..., :m] + v[..., m:]).astype(F32)
    return v[..., 0]


def _scan_train_model(delta, x, bm, cm, a, *, steps=8):
    """The training forward's checkpoints (``selective_scan_lanes`` with
    kCkpt), in float32 numpy: h at the start of every ``steps`` steps,
    from the zero state, by exp2 of the prescaled A and one multiply-add
    a state and step -> (B, ceil(T/steps), D, N)."""
    bs, t, d = delta.shape
    a2 = (a * LOG2E32).astype(F32)
    h = np.zeros((bs, d, a.shape[1]), F32)
    starts = []
    for ti in range(t):
        if ti % steps == 0:
            starts.append(h.copy())
        e = np.exp2((delta[:, ti, :, None] * a2).astype(F32)).astype(F32)
        h = (e * h + (delta[:, ti] * x[:, ti])[..., None]
             * bm[:, ti, None, :]).astype(F32)
    return np.stack(starts, axis=1)


def _scan_bwd_model(delta, x, bm, cm, a, ckpt, dy, dh_final=None, *,
                    channels=128, steps=8, sub=8):
    """What ``scan_bwd_tma`` and ``scan_bwd_reduce_kernel`` compute, in
    float32 numpy: the intervals of ``steps`` from the last, each started
    from its checkpoint (no forward sweep; steps past T and channels past D
    arrive as zeros), its ``sub``-step parts from the last, each part's
    states and factors recomputed from the interval's start with exp2 of
    the prescaled A and kept for the reverse step; states padded to L
    lanes of S (padding states have a = B = C = 0); each lane's sums over
    its states in order, then over its two channels; the transposing
    butterflies' pairings (over the L lanes for dx, ddelta; over the
    warp's channel pairs for dB, dC), the warps and the CTAs in order."""
    bs, t, d = delta.shape
    n = a.shape[1]
    lanes = _lanes_for(n)
    s_per = -(-n // lanes)
    tp, dp = -(-t // steps) * steps, -(-d // channels) * channels
    groups_warp = 32 // lanes                  # channel pairs a warp
    warps = channels // 2 // groups_warp
    ns = lanes * s_per

    def pad(v, shape):
        out = np.zeros(shape, F32)
        out[tuple(slice(0, k) for k in v.shape)] = v
        return out

    dl, xl, gyl = (pad(v, (bs, tp, dp)) for v in (delta, x, dy))
    bl, cl = (pad(v, (bs, tp, ns)) for v in (bm, cm))
    a2 = (pad(a, (dp, ns)) * LOG2E32).astype(F32)
    starts = pad(ckpt, (bs, tp // steps, dp, ns))
    carry = np.zeros((bs, dp, ns), F32) if dh_final is None \
        else pad(dh_final, (bs, dp, ns))
    ddelta = np.zeros((bs, tp, dp), F32)
    dx = np.zeros((bs, tp, dp), F32)
    # per step, CTA and warp: dB and dC summed over the warp's channels
    warp_b = np.zeros((bs, tp, dp // channels, warps, ns), F32)
    warp_c = np.zeros_like(warp_b)
    da = np.zeros((bs, dp, ns), F32)
    for c in reversed(range(tp // steps)):
        for j in reversed(range(steps // sub)):
            h = starts[:, c].copy()
            hist, at = [], []
            for u in range(j * sub + sub):
                ti = c * steps + u
                e = np.exp2((dl[:, ti, :, None] * a2).astype(F32)).astype(F32)
                if u >= j * sub:
                    hist.append(h.copy())
                    at.append(e)
                h = (e * h + (dl[:, ti] * xl[:, ti])[..., None]
                     * bl[:, ti, None, :]).astype(F32)
            hist.append(h)
            for u in reversed(range(sub)):
                ti = c * steps + j * sub + u
                dt, xv, gy = dl[:, ti, :, None], xl[:, ti, :, None], \
                    gyl[:, ti, :, None]
                g = (gy * cl[:, ti, None, :] + carry).astype(F32)
                carry = (at[u] * g).astype(F32)
                w = (carry * hist[u]).astype(F32)
                da = (da + dt * w).astype(F32)
                # (B, D, L, S): a lane's states
                lane = (bs, dp, lanes, s_per)
                gb = (g * bl[:, ti, None, :]).reshape(lane).sum(-1, dtype=F32)
                wa = (a2 * w).reshape(lane).sum(-1, dtype=F32)
                pdx = (dt * gb).astype(F32)
                pdd = (xv * gb + wa * LN2).astype(F32)
                dx[:, ti] = _tree(pdx, -1)
                ddelta[:, ti] = _tree(pdd, -1)
                # dB, dC: a lane's two channels, then the warp's pairs
                pbv = (g * (dt * xv)).reshape(bs, dp // 2, 2, ns).sum(2)
                pcv = (gy * hist[u + 1]).reshape(bs, dp // 2, 2, ns).sum(2)
                shape = (bs, dp // channels, warps, groups_warp, ns)
                warp_b[:, ti] = _tree(pbv.reshape(shape), 3)
                warp_c[:, ti] = _tree(pcv.reshape(shape), 3)
    # the CTA: its warps in order; the reduce kernel: the CTAs, the batch
    part_b = np.zeros((bs, dp // channels, tp, ns), F32)
    part_c = np.zeros_like(part_b)
    for w in range(warps):
        part_b += warp_b[:, :, :, w].transpose(0, 2, 1, 3)
        part_c += warp_c[:, :, :, w].transpose(0, 2, 1, 3)
    db = np.zeros((bs, tp, ns), F32)
    dc = np.zeros_like(db)
    for cb in range(dp // channels):
        db += part_b[:, cb]
        dc += part_c[:, cb]
    da_sum = np.zeros((dp, ns), F32)
    for bi in range(bs):
        da_sum += da[bi]
    # the padded steps left carry as it was, the padded channels at 0
    assert not dx[:, :, d:].any() and not ddelta[:, :, d:].any()
    return (ddelta[:, :t, :d], dx[:, :t, :d], db[:, :t, :n], dc[:, :t, :n],
            da_sum[:d, :n])


def _scan_arrays(seed, b, t, d, n):
    r = np.random.default_rng(seed)
    delta = np.log1p(np.exp(r.normal(size=(b, t, d)))).astype(F32)
    x = r.normal(size=(b, t, d)).astype(F32)
    bm = r.normal(size=(b, t, n)).astype(F32)
    cm = r.normal(size=(b, t, n)).astype(F32)
    a = (-np.exp(r.normal(size=(d, n)) * 0.3)).astype(F32)
    dy = r.normal(size=(b, t, d)).astype(F32)
    dh = r.normal(size=(b, d, n)).astype(F32)
    return delta, x, bm, cm, a, dy, dh


@pytest.mark.parametrize("t,d,n,with_dh,steps", [
    (37, 40, 1, True, 8),      # one lane a channel, one state; D < a CTA
    (40, 70, 5, False, 8),     # 2 lanes of 3 states, one padded; ragged T
    (48, 160, 16, True, 8),    # 4 lanes of 4 states; D = a CTA + 32
    (33, 136, 16, False, 8),   # T one past whole intervals
    (5, 24, 4, True, 8),       # T inside one interval; N = 4 (rows on TMA)
    (21, 130, 12, True, 8),    # 4 lanes of 3 states; D % 4 != 0
    (40, 70, 9, True, 8),      # 2 lanes of 5 states, one padded
    (33, 136, 16, False, 16),  # 16-step intervals: two parts each
    (21, 130, 12, True, 16),   # the same, D % 4 != 0
])
def test_scan_bwd_model_matches_the_plain_backward(t, d, n, with_dh, steps):
    """N = 1, 4, 5, 9, 12 and 16, D not a multiple of the CTA's 128
    channels nor of 4, T not a multiple of the interval nor of the 8-step
    part (and shorter than one), with and without dh_final, at the
    interval as built and at 16 steps: the model's checkpoints within 1e-5
    of ``ref.selective_scan_states``, every gradient within 1e-4 of its
    scale of ``ref.selective_scan_bwd``."""
    arrays = _scan_arrays(t + d + n, 2, t, d, n)
    dh = arrays[6] if with_dh else None
    ckpt = _scan_train_model(*arrays[:5], steps=steps)
    states = ref.selective_scan_states(*map(torch.from_numpy, arrays[:5]),
                                       steps).numpy()
    assert ckpt.shape == states.shape
    assert _share(ckpt, states) <= 1e-5
    got = _scan_bwd_model(*arrays[:5], ckpt, arrays[5], dh, steps=steps)
    want = ref.selective_scan_bwd(*map(torch.from_numpy, arrays[:6]),
                                  None if dh is None else torch.from_numpy(dh))
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        assert _share(g, w.numpy()) <= SCAN_BWD_RTOL


def test_scan_bwd_model_is_not_the_float64_backward():
    """exp2 of the prescaled A and the new summation orders are a real
    change of arithmetic: the model differs from the backward in float64,
    by far less than the tolerance."""
    arrays = _scan_arrays(5, 2, 40, 136, 16)
    ckpt = _scan_train_model(*arrays[:5])
    got = _scan_bwd_model(*arrays[:5], ckpt, arrays[5], arrays[6])
    want = ref.selective_scan_bwd(*(torch.from_numpy(v).double()
                                    for v in arrays))
    shares = [_share(g, w.numpy()) for g, w in zip(got, want)]
    assert 0 < max(shares) < SCAN_BWD_RTOL / 10


def test_scan_bwd_constants_match_the_kernel():
    """The model's CTA width, interval and part are the kernels' (read
    from the sources: nothing compiles here): the training forward's
    checkpoint interval is the backward's, and the wrapper sizes the
    checkpoints and the scratch by the same numbers; both kernels split
    states over lanes by one rule."""
    src = (_build.CSRC / "selective_scan_bwd.cu").read_text()
    fwd = (_build.CSRC / "selective_scan.cu").read_text()
    channels = int(re.search(r"constexpr int kChannels = (\d+);", src)[1])
    steps = int(re.search(r"constexpr int kSteps = (\d+);", src)[1])
    sub = int(re.search(r"constexpr int kSub = (\d+);", src)[1])
    ckpt_steps = int(re.search(r"constexpr int kCkptSteps = (\d+);",
                               fwd)[1])
    assert (channels, steps, sub) == (128, 8, 8)
    assert ckpt_steps == steps == selective_scan.CKPT_STEPS
    assert selective_scan._BWD_CHANNELS == channels
    for text in (src, fwd):
        rule = re.search(r"lanes_for\(int n\) \{\s*return ([^;]+);",
                         text).group(1)
        assert rule == "n >= 10 ? 4 : (n >= 5 ? 2 : 1)"


def test_flash_bwd_tiles_match_the_kernel():
    """The model's tiles are the bf16 kernels' (read from the sources):
    64-key dK/dV CTAs and 128-row dQ CTAs of two 64-row consumers, steps of
    64 rows or keys (32 at D = 256), every head dim the wrappers take in
    its own translation unit, and past D = 128 a dV pass and a dK pass."""
    src = model.BWD_SRC
    assert int(re.search(r"constexpr int kBwdM = (\d+);", src)[1]) == 64
    assert model.KEYS == 64 and model.Q_TILE == 128 and model.HALF == 64
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert HEAD_DIMS == (16, 32, 64, 80, 128, 256)
    steps = {d: model.step(d) for d in HEAD_DIMS}
    assert steps == {16: 64, 32: 64, 64: 64, 80: 64, 128: 64, 256: 32}
    assert all(model.KEYS % n == 0 and n % 16 == 0 for n in steps.values())
    entries = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    for d in HEAD_DIMS:
        assert f"case {d}:" in entries
        assert f"return bwd_launch<{d}>(a);" in (
            _build.CSRC / f"flash_bwd_d{d}.cu").read_text()
    # past D = 128 the dK/dV kernel runs as a dV pass and a dK pass
    assert re.search(r"if constexpr \(D <= 128\) \{\s*err = launch_dkdv_bf16"
                     r"<D, kDkdvBoth, kCap>", src)
    assert "launch_dkdv_bf16<D, kDkdvOnlyDv, kCap>" in src
    assert "launch_dkdv_bf16<D, kDkdvOnlyDk, kCap>" in src
