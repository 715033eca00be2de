"""Plain models of the arithmetic of the two training backward kernels of
the PyTorch port, held against the JAX package on the CPU.

``csrc/flash_attention_bwd.cu`` runs bfloat16 on the tensor cores: a dK/dV
kernel over 64-key tiles that walks the group's q heads and the band's
64-row q tiles (at D = 128 and 256 each staged tile in two halves of 32
rows, ``kSubB``; at D = 256 as two launches, a dV pass and a dK pass, each
accumulating one of the two with the same arithmetic), and a dQ kernel
over 64-row q tiles that walks the band's 64-key tiles (at D = 256 each
in two halves of 32 keys, ``kSubQ``), at head dims 16 to 256
(h2o-danube's 80, qwen2-vl's 128, gemma3's 256), under windows shorter
than T and under gemma3's softcap c (S capped at c tanh(s/c), dS times
1 - tanh^2).  ``_flash_bwd_bf16_model`` repeats that in torch: products of
bf16 values accumulated in float32, P = 2^(S scale log2(e) - lse log2(e)),
P and dS ROUNDED TO TWO bf16 TERMS each before their products (hi =
bf16(x), lo = bf16(x - hi), one product each), the scale applied to dK and
dQ in float32 at the store.  It must stay within 2^-8 of each gradient's
scale of ``ref.attention_bwd`` and of ``jax.vjp`` of the JAX package's
plain attention on the same bf16 inputs (``FLASH_BWD_RTOL[bfloat16]`` in
``chip_smoke.py``, which holds the kernel to ``ref.attention_bwd`` on the
card).  One bf16 term alone does not: ``_bf16_terms(x, 1)`` puts dV or dQ
past 2^-8 of its scale at these shapes.

``csrc/selective_scan_bwd.cu`` splits each channel's N states over L lanes
(two channels a lane, 128 channels a CTA), checkpoints h every 16 steps,
recomputes 8-step parts with exp2 of the prescaled A, and sums over N and
over channels by transposing shuffle butterflies, then over warps and CTAs
in order.  ``_scan_bwd_model`` repeats that order in float32 numpy and is
held to ``ref.selective_scan_bwd`` at the backward's tolerance, 1e-4 of
each gradient's scale (``SCAN_BWD_RTOL``).

The kernels themselves run only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import math  # noqa: E402
import re  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import AttnCfg as JAttnCfg  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels import _build, ref, selective_scan  # noqa: E402

FLASH_BWD_RTOL = 2 ** -8    # chip_smoke.py, bf16 gradients
SCAN_BWD_RTOL = 1e-4        # chip_smoke.py, the scan's gradients
LOG2E = 1.4426950408889634
TILE = 64           # keys (dK/dV) or rows (dQ) a CTA owns, and the step
FLASH_BWD_SRC = (_build.CSRC / "flash_attention_bwd.cu").read_text()


def _sub_rule(name, d):
    """The kernel's ``constexpr int <name> = D <= L ? A : B;`` rule at head
    dim ``d``, read from the source."""
    lim, small, large = map(int, re.search(
        rf"constexpr int {name} = D <= (\d+) \? (\d+) : (\d+);",
        FLASH_BWD_SRC).groups())
    return small if d <= lim else large


def _sub_rows(d):
    """The q rows a dK/dV warp's S^T and dP^T span at once at head dim
    ``d`` (``kSubB``)."""
    return _sub_rule("kSubB", d)


def _sub_keys(d):
    """The keys a dQ warp's S and dP span at once at head dim ``d``
    (``kSubQ``)."""
    return _sub_rule("kSubQ", d)


def _share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# flash attention's backward in bf16 on the tensor cores
# ---------------------------------------------------------------------------


def _keep(rows, keys, causal, window):
    m = torch.ones((len(rows), len(keys)), dtype=torch.bool)
    r, k = rows[:, None], keys[None, :]
    if causal:
        m &= k <= r
    if window:
        m &= k > r - window
    return m


def _row_empty(r, s, causal, window):
    k_max = min(r, s - 1) if causal else s - 1
    k_min = max(r - window + 1, 0) if window else 0
    return k_max < k_min


def _tile(x, start, n):
    """Rows [start, start + n) of x (..., R, D), zero past its end."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    part = x[..., start:start + n, :]
    out[..., :part.shape[-2], :] = part
    return out


def _cut(x, start, n):
    """Entries [start, start + n) of the last axis, zero past its end."""
    out = x.new_zeros(x.shape[:-1] + (n,))
    part = x[..., start:start + n]
    out[..., :part.shape[-1]] = part
    return out


def _bf16_terms(x, terms=2):
    """x as the kernel feeds it to the tensor cores: hi = bf16(x), then
    (with two terms) lo = bf16(x - hi)."""
    hi = x.bfloat16().float()
    return [hi] if terms == 1 else [hi, (x - hi).bfloat16().float()]


def _mma(acc, x, b, terms):
    for part in _bf16_terms(x, terms):
        acc += part @ b


def _capped(st, scale, softcap):
    """(base-2 exponent of the scores before lse, the cap's derivative):
    s scale log2(e) and 1, or c log2(e) tanh(s scale / c) and 1 - tanh^2,
    in float32 as the kernels compute them."""
    f32 = torch.float32
    if not softcap:
        return st * (scale * torch.tensor(LOG2E, dtype=f32)), 1.0
    th = torch.tanh(st * (scale / torch.tensor(softcap, dtype=f32)))
    return (torch.tensor(softcap, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
            * th, 1 - th * th)


def _flash_bwd_bf16_model(q, k, v, o, lse, do, *, causal, window,
                          terms=2, softcap=None):
    """What ``flash_bwd_dkdv_bf16_kernel`` and ``flash_bwd_dq_bf16_kernel``
    compute, in plain torch, tile by tile (the kernels' walks and masks)."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    f32 = torch.float32
    qg = q.float().reshape(b, t, kvh, rep, d).permute(0, 2, 3, 1, 4)
    dog = do.float().reshape(b, t, kvh, rep, d).permute(0, 2, 3, 1, 4)
    kg, vg = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # (B,G,S,D)
    # the dot kernel: D = rowsum(dO * O) in float32
    dsum = (do.float() * o.float()).sum(-1).reshape(b, t, kvh, rep) \
        .permute(0, 2, 3, 1)                                     # (B,G,R,T)
    lg = lse.reshape(b, kvh, rep, t)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=f32)
    l2 = lg * torch.tensor(LOG2E, dtype=f32)
    empty = lg <= -0.5e30

    dk = torch.zeros((b, kvh, s, d))
    dv = torch.zeros((b, kvh, s, d))
    n_qt = -(-t // TILE)
    sub = _sub_rows(d)
    for k0 in range(0, s, TILE):
        k_hi = min(k0 + TILE, s) - 1
        keys = torch.arange(k0, k0 + TILE)
        kt, vt = _tile(kg, k0, TILE), _tile(vg, k0, TILE)
        dka = torch.zeros((b, kvh, TILE, d))
        dva = torch.zeros((b, kvh, TILE, d))
        for r in range(rep):
            for qt in range(n_qt):
                q0 = qt * TILE
                q_hi = min(q0 + TILE, t) - 1
                pairs = (not causal or k0 <= q_hi) and \
                    (not window or k_hi > q0 - window)
                if not (pairs or _row_empty(q_hi, s, causal, window)):
                    continue
                rows = torch.arange(q0, q0 + TILE)
                qt_, dot = _tile(qg[:, :, r], q0, TILE), _tile(dog[:, :, r],
                                                                q0, TILE)
                lt = _cut(l2[:, :, r], q0, TILE)[:, :, None, :]
                et = _cut(empty[:, :, r], q0, TILE)[:, :, None, :]
                dt = _cut(dsum[:, :, r], q0, TILE)[:, :, None, :]
                kept = (_keep(rows, keys, causal, window)
                        & (rows < t)[:, None]).T
                st = kt @ qt_.transpose(-1, -2)                 # (keys, rows)
                x, dcap = _capped(st, scale, softcap)
                p = torch.exp2(x - lt)
                p = torch.where(kept, p, torch.where(et, 1.0 / s, 0.0))
                dpt = vt @ dot.transpose(-1, -2)
                ds = torch.where(et, 0.0, p * (dpt - dt) * dcap)
                for r0 in range(0, TILE, sub):      # the kernel's sub-steps
                    part = slice(r0, r0 + sub)
                    _mma(dva, p[..., part], dot[..., part, :], terms)
                    _mma(dka, ds[..., part], qt_[..., part, :], terms)
        n = min(TILE, s - k0)
        dk[:, :, k0:k0 + n] = (dka * scale)[:, :, :n]
        dv[:, :, k0:k0 + n] = dva[:, :, :n]

    dq = torch.zeros((b, kvh, rep, t, d))
    for q0 in range(0, t, TILE):
        q_hi = min(q0 + TILE, t) - 1
        rows = torch.arange(q0, q0 + TILE)
        k_begin, k_end = 0, s
        if causal:
            k_end = min(s, q_hi + 1)
        if window:
            k_begin = max(q0 - window + 1, 0) // TILE * TILE
        qt_, dot = _tile(qg, q0, TILE), _tile(dog, q0, TILE)
        lt = _cut(l2, q0, TILE)[..., None]
        live = ~_cut(empty, q0, TILE)[..., None] & (rows < t)[:, None]
        dt = _cut(dsum, q0, TILE)[..., None]
        dqa = torch.zeros((b, kvh, rep, TILE, d))
        sub = _sub_keys(d)
        for kb in range(k_begin, k_end, TILE):
            keys = torch.arange(kb, kb + TILE)
            kt = _tile(kg, kb, TILE)[:, :, None]
            vt = _tile(vg, kb, TILE)[:, :, None]
            sc = qt_ @ kt.transpose(-1, -2)                     # (rows, keys)
            dp = dot @ vt.transpose(-1, -2)
            kept = live & _keep(rows, keys, causal, window) & (keys < s)
            x, dcap = _capped(sc, scale, softcap)
            ds = torch.where(kept, torch.exp2(x - lt) * (dp - dt) * dcap,
                             0.0)
            for k0_ in range(0, TILE, sub):         # the kernel's sub-steps
                part = slice(k0_, k0_ + sub)
                _mma(dqa, ds[..., part], kt[..., part, :], terms)
        n = min(TILE, t - q0)
        dq[:, :, :, q0:q0 + n] = (dqa * scale)[:, :, :, :n]
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


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
    """The dK/dV kernel's walk (``visit``) reaches exactly the q tiles that
    hold a kept pair of its key tile or a row with no key in its band, so
    under a window shorter than T it skips the tiles outside the band
    (h2o-danube trains on T = 2 windows)."""
    band = ref._band(t, s, causal, window, "cpu").numpy()
    skipped = 0
    for k0 in range(0, s, TILE):
        k_hi = min(k0 + TILE, s) - 1
        for q0 in range(0, t, TILE):
            q_hi = min(q0 + TILE, t) - 1
            pairs = (not causal or k0 <= q_hi) and \
                (not window or k_hi > q0 - window)
            visit = pairs or _row_empty(q_hi, s, causal, window)
            needed = band[q0:q_hi + 1, k0:k_hi + 1].any() or \
                not band[q0:q_hi + 1].any(1).all()
            assert visit == needed, (k0, q0)
            skipped += not visit
    if causal and window and t == s and t >= 2 * window:
        assert skipped > 0          # the tiles before the band


@pytest.mark.parametrize("t,s,causal,window", [
    (512, 512, True, None), (300, 300, True, 128), (100, 77, False, 24),
    (200, 50, True, 16), (70, 130, False, None), (257, 129, True, 1),
    (1024, 1024, True, 512), (1000, 1000, True, 300)])
def test_dq_walk_covers_every_kept_pair(t, s, causal, window):
    """The dQ kernel's band of key tiles holds every kept pair of each q
    tile (rows with no key in their band get dQ = 0 and need none)."""
    band = ref._band(t, s, causal, window, "cpu").numpy()
    for q0 in range(0, t, TILE):
        q_hi = min(q0 + TILE, t) - 1
        k_begin, k_end = 0, s
        if causal:
            k_end = min(s, q_hi + 1)
        if window:
            k_begin = max(q0 - window + 1, 0) // TILE * TILE
        cols = np.nonzero(band[q0:q_hi + 1].any(0))[0]
        assert cols.size == 0 or (cols.min() >= k_begin
                                  and cols.max() < k_end)


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


def _scan_bwd_model(delta, x, bm, cm, a, dy, dh_final=None, *, channels=128,
                    steps=16, sub=8):
    """What ``scan_bwd_lanes`` and ``scan_bwd_reduce_kernel`` compute, in
    float32 numpy: time padded to whole intervals of ``steps``, channels to
    whole CTAs of ``channels``, states to L lanes of S (padding states have
    a = B = C = 0); h recomputed from the checkpoints with exp2 of the
    prescaled A and the factors kept for the reverse step; each lane's sums
    over its states in order, then over its two channels; the transposing
    butterflies' pairings (over the L lanes for dx, ddelta; over the warp's
    channel pairs for dB, dC), the warps and the CTAs in order."""
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
    carry = np.zeros((bs, dp, ns), F32) if dh_final is None \
        else pad(dh_final, (bs, dp, ns))
    # the forward sweep: h at the start of every interval
    h = np.zeros((bs, dp, ns), F32)
    starts = []
    for ti in range(tp):
        if ti % steps == 0:
            starts.append(h.copy())
        e = np.exp2((dl[:, ti, :, None] * a2).astype(F32)).astype(F32)
        h = (e * h + (dl[:, ti] * xl[:, ti])[..., None]
             * bl[:, ti, None, :]).astype(F32)
    ddelta = np.zeros((bs, tp, dp), F32)
    dx = np.zeros((bs, tp, dp), F32)
    # per step, CTA and warp: dB and dC summed over the warp's channels
    warp_b = np.zeros((bs, tp, dp // channels, warps, ns), F32)
    warp_c = np.zeros_like(warp_b)
    da = np.zeros((bs, dp, ns), F32)
    for c in reversed(range(tp // steps)):
        for j in reversed(range(steps // sub)):
            h = starts[c].copy()
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


@pytest.mark.parametrize("t,d,n,with_dh", [
    (37, 40, 1, True),      # one lane a channel, one state; D < a CTA
    (40, 70, 5, False),     # 2 lanes of 3 states, one padded; ragged T
    (48, 160, 16, True),    # 4 lanes of 4 states; D = a CTA + 32
    (33, 136, 16, False),   # one checkpoint interval and a part of one
])
def test_scan_bwd_model_matches_the_plain_backward(t, d, n, with_dh):
    """N = 1, 5 and 16, D not a multiple of the CTA's 128 channels, T not a
    multiple of the 16-step interval nor of the 8-step part, with and
    without dh_final: every gradient within 1e-4 of its scale of
    ``ref.selective_scan_bwd``."""
    arrays = _scan_arrays(t + d + n, 2, t, d, n)
    dh = arrays[6] if with_dh else None
    got = _scan_bwd_model(*arrays[:6], dh)
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
    got = _scan_bwd_model(*arrays[:6], arrays[6])
    want = ref.selective_scan_bwd(*(torch.from_numpy(v).double()
                                    for v in arrays))
    shares = [_share(g, w.numpy()) for g, w in zip(got, want)]
    assert 0 < max(shares) < SCAN_BWD_RTOL / 10


def test_scan_bwd_constants_match_the_kernel():
    """The model's CTA width, interval and part are the kernel's, and the
    scratch the wrapper allocates is sized by the same numbers (read from
    the source: nothing compiles here)."""
    src = (_build.CSRC / "selective_scan_bwd.cu").read_text()
    channels = int(re.search(r"constexpr int kChannels = (\d+);", src)[1])
    steps = int(re.search(r"constexpr int kSteps = (\d+);", src)[1])
    sub = int(re.search(r"constexpr int kSub = (\d+);", src)[1])
    assert (channels, steps, sub) == (128, 16, 8)
    assert selective_scan._BWD_CHANNELS == channels
    assert selective_scan._BWD_STEPS == steps
    rule = re.search(r"lanes_for\(int n\) \{\s*return ([^;]+);", src).group(1)
    assert rule == "n >= 10 ? 4 : (n >= 5 ? 2 : 1)"


def test_flash_bwd_tiles_match_the_kernel():
    """The model's tiles are the bf16 kernels' (read from the source)."""
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    assert int(re.search(r"constexpr int kTB = (\d+);", src)[1]) == TILE
    assert int(re.search(r"constexpr int kStepB = (\d+);", src)[1]) == TILE
    # the head dims the wrappers take, each with its sub-steps: the whole
    # stage up to D = 64 (the design as it was), halves of it in dK/dV at
    # 128 and 256, and in dQ at 256
    from repro_torch.kernels.flash_attention import HEAD_DIMS
    assert HEAD_DIMS == (16, 32, 64, 80, 128, 256)
    subs = {d: _sub_rows(d) for d in HEAD_DIMS}
    assert subs == {16: 64, 32: 64, 64: 64, 80: 64, 128: 32, 256: 32}
    subq = {d: _sub_keys(d) for d in HEAD_DIMS}
    assert subq == {16: 64, 32: 64, 64: 64, 80: 64, 128: 64, 256: 32}
    assert all(TILE % sub == 0 and sub % 16 == 0
               for sub in (*subs.values(), *subq.values()))
    for d in HEAD_DIMS:
        assert f"case {d}:" in src
    # past D = 128 the dK/dV kernel runs as a dV pass and a dK pass
    assert re.search(r"if constexpr \(D <= 128\) \{\s*err = launch_dkdv_bf16"
                     r"<D, kDkdvBoth, kCap>", src)
    assert "launch_dkdv_bf16<D, kDkdvOnlyDv, kCap>" in src
    assert "launch_dkdv_bf16<D, kDkdvOnlyDk, kCap>" in src
