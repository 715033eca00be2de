"""A plain torch model of the bf16 flash backward of the PyTorch port
(``csrc/flash_bwd.cuh``), shared by the tests that hold it to the JAX
package.

The kernels, as this model repeats them:

* dK/dV: one CTA a (batch, kv head, 64-key tile, ``kBwdM``); its walk is
  the group's H/KV q heads and, for each, the q tiles of ``kBwdN`` rows
  (64; 32 at head dim 256) that hold a kept pair of its keys or a row with
  no key in its band.  Two consumer warpgroups take every other tile of
  the walk into their own partial dK and dV; the first adds the second's
  at the end.  Per tile: S^T = K Q^T and dP^T = V dO^T from bf16 values in
  float32, P^T = 2^(S^T scale log2(e) - lse log2(e)) (capped first under a
  softcap), masked only where the band's edge crosses the tile (a row with
  no key weighs every key 1/S), dS^T = P^T (dP^T - D) (times the cap's
  derivative), then dV += P^T dO and dK += dS^T Q with P^T and dS^T
  ROUNDED TO TWO bf16 TERMS (hi = bf16(x), lo = bf16(x - hi), one product
  each); dK times the scale in float32 at the store.
* dQ: one CTA a (batch, head, 128-row q tile, ``kTQ``) of two 64-row
  consumers; its band of ``kBwdN``-key tiles (a row with no key gets
  dQ = 0); a consumer skips a tile with no kept pair of its rows.  Per
  tile: S = Q K^T, dP = dO V^T, dS = P (dP - D), dQ += dS K with dS as two
  bf16 terms, the scale at the store.

The tiles are read from the sources (nothing compiles here)."""
from __future__ import annotations

import math
import re

import torch

from repro_torch.kernels import _build

LOG2E = 1.4426950408889634
BWD_SRC = (_build.CSRC / "flash_bwd.cuh").read_text()
FWD_SRC = (_build.CSRC / "flash_fwd.cuh").read_text()


def const(name, src=BWD_SRC):
    """``constexpr int <name> = <int>;`` in a source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])


def rule(name, d, src=BWD_SRC):
    """The source's ``constexpr int <name> = D <= L ? A : B;`` at ``d``."""
    lim, small, large = map(int, re.search(
        rf"constexpr int {name} = D <= (\d+) \? (\d+) : (\d+);",
        src).groups())
    return small if d <= lim else large


KEYS = const("kBwdM")                    # keys of a dK/dV CTA
Q_TILE = const("kTQ", FWD_SRC)           # rows of a dQ CTA
CONSUMERS = const("kConsumers", FWD_SRC)
HALF = Q_TILE // CONSUMERS               # rows of a dQ consumer


def step(d):
    """Rows (dK/dV) or keys (dQ) a ring stage holds at head dim ``d``."""
    return rule("kBwdN", d)


def row_empty(r, s, causal, window):
    """Does row ``r`` keep no key at all?"""
    k_max = min(r, s - 1) if causal else s - 1
    k_min = max(r - window + 1, 0) if window else 0
    return k_max < k_min


def dkdv_walk(t, s, k0, n, causal, window):
    """The q tiles (their first rows) the dK/dV CTA of keys [k0, k0 + 64)
    visits for one head, in order (``dkdv_visit``)."""
    k_hi = min(k0 + KEYS, s) - 1
    out = []
    for q0 in range(0, t, n):
        q_hi = min(q0 + n, t) - 1
        pairs = (not causal or k0 <= q_hi) and \
            (not window or k_hi > q0 - window)
        if pairs or row_empty(q_hi, s, causal, window):
            out.append(q0)
    return out


def dq_band(q0, q_hi, s, causal, window, n):
    """The key tiles (their first keys) the dQ CTA of rows [q0, q_hi]
    walks."""
    k_begin, k_end = 0, s
    if causal:
        k_end = min(s, q_hi + 1)
    if window:
        k_begin = max(q0 - window + 1, 0) // n * n
    return list(range(k_begin, k_end, n))


def dq_works(qw0, qw_hi, kb, n, t, causal, window):
    """Does the dQ consumer of rows [qw0, qw_hi] work on key tile kb?"""
    return qw0 < t and (not causal or kb <= qw_hi) and \
        (not window or kb + n - 1 > qw0 - window)


def keep(rows, keys, causal, window):
    m = torch.ones((len(rows), len(keys)), dtype=torch.bool)
    r, k = rows[:, None], keys[None, :]
    if causal:
        m &= k <= r
    if window:
        m &= k > r - window
    return m


def tile(x, start, n):
    """Rows [start, start + n) of x (..., R, D), zero past its end (the
    TMA's zero fill)."""
    out = x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    part = x[..., start:start + n, :]
    out[..., :part.shape[-2], :] = part
    return out


def cut(x, start, n):
    """Entries [start, start + n) of the last axis, zero past its end."""
    out = x.new_zeros(x.shape[:-1] + (n,))
    part = x[..., start:start + n]
    out[..., :part.shape[-1]] = part
    return out


def bf16_terms(x, terms=2):
    """x as the kernel feeds it to the tensor cores: hi = bf16(x), then
    (with two terms) lo = bf16(x - hi)."""
    hi = x.bfloat16().float()
    return [hi] if terms == 1 else [hi, (x - hi).bfloat16().float()]


def mma(acc, x, b, terms):
    for part in bf16_terms(x, terms):
        acc += part @ b


def capped(st, scale, softcap):
    """(base-2 exponent of the scores before lse, the cap's derivative)."""
    f32 = torch.float32
    if not softcap:
        return st * (scale * torch.tensor(LOG2E, dtype=f32)), 1.0
    th = torch.tanh(st * (scale / torch.tensor(softcap, dtype=f32)))
    return (torch.tensor(softcap, dtype=f32) * torch.tensor(LOG2E, dtype=f32)
            * th, 1 - th * th)


def flash_bwd_bf16_model(q, k, v, o, lse, do, *, causal, window,
                         softcap=None, terms=2, interleave=None):
    """What ``flash_bwd_dkdv_bf16_kernel`` and ``flash_bwd_dq_bf16_kernel``
    compute, tile by tile -> (dq, dk, dv) in q's dtype.  ``interleave``, a
    ``random.Random``, processes each dK/dV CTA's tiles in a random
    interleaving of the two consumers' turns (each consumer's own tiles in
    order), as any timing of the card would."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    n = step(d)
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
    for k0 in range(0, s, KEYS):
        keys = torch.arange(k0, k0 + KEYS)
        kt, vt = tile(kg, k0, KEYS), tile(vg, k0, KEYS)
        walk = [(r, q0) for r in range(rep)
                for q0 in dkdv_walk(t, s, k0, n, causal, window)]
        turns = [i % CONSUMERS for i in range(len(walk))]
        if interleave is not None:       # each consumer's tiles in order
            queues = [[i for i, c in enumerate(turns) if c == cw]
                      for cw in range(CONSUMERS)]
            order = []
            while any(queues):
                cw = interleave.choice([c for c in range(CONSUMERS)
                                        if queues[c]])
                order.append(queues[cw].pop(0))
        else:
            order = range(len(walk))
        dka = [torch.zeros((b, kvh, KEYS, d)) for _ in range(CONSUMERS)]
        dva = [torch.zeros((b, kvh, KEYS, d)) for _ in range(CONSUMERS)]
        for i in order:
            r, q0 = walk[i]
            cw = turns[i]
            q_hi = min(q0 + n, t) - 1
            rows = torch.arange(q0, q0 + n)
            qt_, dot = tile(qg[:, :, r], q0, n), tile(dog[:, :, r], q0, n)
            # lse log2(e) and D as the consumers stage them, 0 past T
            lt = cut(l2[:, :, r], q0, n)[:, :, None, :]
            et = cut(empty[:, :, r], q0, n)[:, :, None, :]
            dt = cut(dsum[:, :, r], q0, n)[:, :, None, :]
            st = kt @ qt_.transpose(-1, -2)                     # (keys, rows)
            x, dcap = capped(st, scale, softcap)
            p = torch.exp2(x - lt)
            dpt = vt @ dot.transpose(-1, -2)
            inside = (not causal or k0 + KEYS - 1 <= q0) and \
                (not window or k0 > q_hi - window)
            if not inside:
                kept = (keep(rows, keys, causal, window)
                        & (rows < t)[:, None]).T
                p = torch.where(kept, p, torch.where(et, 1.0 / s, 0.0))
            ds = p * (dpt - dt) * dcap
            if not inside:
                ds = torch.where(et, 0.0, ds)
            mma(dva[cw], p, dot, terms)
            mma(dka[cw], ds, qt_, terms)
        m = min(KEYS, s - k0)
        dk[:, :, k0:k0 + m] = ((dka[0] + dka[1]) * scale)[:, :, :m]
        dv[:, :, k0:k0 + m] = (dva[0] + dva[1])[:, :, :m]

    dq = torch.zeros((b, kvh, rep, t, d))
    live = ~empty
    l2q = torch.where(live, l2, 0.0)
    for q0 in range(0, t, Q_TILE):
        q_hi = min(q0 + Q_TILE, t) - 1
        band = dq_band(q0, q_hi, s, causal, window, n)
        for qw0 in range(q0, q0 + Q_TILE, HALF):       # the two consumers
            if qw0 >= t:
                continue
            qw_hi = min(qw0 + HALF, t) - 1
            rows = torch.arange(qw0, qw0 + HALF)
            qt_, dot = tile(qg, qw0, HALF), tile(dog, qw0, HALF)
            lt = cut(l2q, qw0, HALF)[..., None]
            lv = cut(live, qw0, HALF)[..., None] & (rows < t)[:, None]
            dt = cut(dsum, qw0, HALF)[..., None]
            acc = torch.zeros((b, kvh, rep, HALF, d))
            for kb in band:
                if not dq_works(qw0, qw_hi, kb, n, t, causal, window):
                    continue
                keys = torch.arange(kb, kb + n)
                kt = tile(kg, kb, n)[:, :, None]
                vt = tile(vg, kb, n)[:, :, None]
                sc = qt_ @ kt.transpose(-1, -2)                 # (rows, keys)
                dp = dot @ vt.transpose(-1, -2)
                x, dcap = capped(sc, scale, softcap)
                ds = torch.exp2(x - lt) * (dp - dt) * dcap
                inside = kb + n <= s and \
                    (not causal or kb + n - 1 <= qw0) and \
                    (not window or kb > qw_hi - window)
                if not inside:
                    kept = lv & keep(rows, keys, causal, window) & (keys < s)
                    ds = torch.where(kept, ds, 0.0)
                mma(acc, ds, kt, terms)
            m = min(HALF, t - qw0)
            dq[:, :, :, qw0:qw0 + m] = (acc * scale)[:, :, :, :m]
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def visited_pairs(t, s, causal, window, d):
    """(q row, key) blocks the two kernels' walks touch: the dK/dV walk's
    (q tile, key tile) pairs and the dQ consumers' (64-row half, key tile)
    pairs, as sets of (first row, first key)."""
    n = step(d)
    dkdv = {(q0, k0) for k0 in range(0, s, KEYS)
            for q0 in dkdv_walk(t, s, k0, n, causal, window)}
    dq = set()
    for q0 in range(0, t, Q_TILE):
        band = dq_band(q0, min(q0 + Q_TILE, t) - 1, s, causal, window, n)
        for qw0 in range(q0, min(q0 + Q_TILE, t), HALF):
            qw_hi = min(qw0 + HALF, t) - 1
            dq |= {(qw0, kb) for kb in band
                   if dq_works(qw0, qw_hi, kb, n, t, causal, window)}
    return dkdv, dq
