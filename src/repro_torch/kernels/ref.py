"""Plain PyTorch versions of the kernels on the HAIL read and build path
and on the LM serving path.

Each function computes what the matching function of the JAX package's
``kernels/ref.py`` computes — bit for bit on the integer HAIL path, except
where the JAX package misses rows: ``index_search`` starts an index scan one
partition earlier when a partition's minimum equals the range's lower bound.
The float ones (``attention``, ``selective_scan``) repeat the JAX oracles'
arithmetic in float32, summing in another order.  The parity tests hold
them against the JAX package, and the CUDA kernels are held against them.
CPU tensors always take these versions.

``attention_lse``, ``attention_bwd`` and ``selective_scan_bwd`` are the
plain versions of the training path's kernels: the forward that also gives
the log-sum-exp, and the two backward kernels.  The JAX package has no
counterpart (it differentiates plain jnp); the parity tests hold them to
``jax.vjp`` of the oracles above and to ``torch.autograd`` through them.
They compute in float32, and in float64 for float64 inputs (for
``gradcheck``); ``attention`` computes in float32 whatever its inputs.
"""
from __future__ import annotations

import math

import torch


def sort_by_key(keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable sort along the last axis -> (sorted_keys, int32 permutation)."""
    sorted_keys, perm = torch.sort(keys, dim=-1, stable=True)
    return sorted_keys, perm.to(torch.int32)


def index_search(mins: torch.Tensor, lo, hi) -> torch.Tensor:
    """mins (blocks, n_parts) sorted -> (blocks, 2) [p_first, p_last]:
    the first partition that can hold a key >= lo and the last that can
    hold a key <= hi.

    p_first counts the minima BELOW lo.  The JAX package counts those
    <= lo, which starts the scan at the last partition whose minimum equals
    lo and so misses the rows equal to lo at the end of the partitions
    before it — on 2^19-row blocks, a few blocks in ten for a range over
    visitDate.  Where no minimum equals lo, both agree."""
    first = torch.clamp((mins < lo).sum(-1).to(torch.int32) - 1, min=0)
    last = torch.clamp((mins <= hi).sum(-1).to(torch.int32) - 1, min=0)
    return torch.stack([first, last], dim=-1)


def pax_scan(key_col: torch.Tensor, proj: torch.Tensor, lo, hi):
    """key_col (rows,), proj (rows, C) -> (mask (rows,) bool, proj masked to
    0, 0-d int32 count of the rows kept)."""
    mask = (key_col >= lo) & (key_col <= hi)
    out = torch.where(mask[:, None], proj, 0)
    return mask, out, mask.sum(dtype=torch.int32)


def hail_read(mins, keys, proj, bad, use_index, lo, hi, *,
              partition_size: int):
    """Fused split reader: per-block root lookup + pruned range scan.

    mins (B,P), keys (B,R), proj (B,R,C), bad (B,R) bool, use_index (B,)
    -> (mask (B,R) bool, masked proj, rows_read_frac (B,) f32)."""
    rows = keys.shape[1]
    pr = index_search(mins, lo, hi)
    indexed = use_index > 0
    r0 = torch.where(indexed, pr[:, 0] * partition_size, 0)
    r1 = torch.where(indexed,
                     torch.clamp((pr[:, 1] + 1) * partition_size, max=rows),
                     rows)
    r = torch.arange(rows, dtype=torch.int32, device=keys.device)[None, :]
    in_range = (r >= r0[:, None]) & (r < r1[:, None])
    mask = (keys >= lo) & (keys <= hi) & in_range & ~bad
    out = torch.where(mask[..., None], proj, 0)
    frac = (r1 - r0).to(torch.float32) / rows
    return mask, out, frac


def hail_read_batch(mins, keys, proj, bad, use_index, lohi, *,
                    partition_size: int):
    """Shared-scan reader: Q range queries over one split at once.

    lohi (Q, 2) -> (mask (B, R, Q) bool, proj masked by the union of the Q
    masks (B, R, C), rows_read_frac (B, Q) f32)."""
    masks, fracs = [], []
    for q in range(lohi.shape[0]):
        m, _, f = hail_read(mins, keys, proj, bad, use_index,
                            lohi[q, 0], lohi[q, 1],
                            partition_size=partition_size)
        masks.append(m)
        fracs.append(f)
    mask = torch.stack(masks, dim=-1)
    out = torch.where(mask.any(dim=-1)[..., None], proj, 0)
    return mask, out, torch.stack(fracs, dim=-1)


def selective_scan(delta, x, b, c, a):
    """Plain Mamba1 recurrence from a zero state, one time step at a time.
    delta, x (B,T,D); b, c (B,T,N); a (D,N) negative
    -> y (B,T,D) in delta's dtype, h_final (B,D,N) float32."""
    bs, t, d = delta.shape
    h = torch.zeros((bs, d, a.shape[-1]), dtype=torch.float32,
                    device=delta.device)
    ys = []
    for i in range(t):
        dt_t = delta[:, i]
        at = torch.exp(dt_t[..., None] * a)                  # (B,D,N)
        bt = (dt_t * x[:, i])[..., None] * b[:, i, None, :]
        h = at * h + bt
        ys.append((h * c[:, i, None, :]).sum(-1))            # (B,D)
    return torch.stack(ys, dim=1).to(delta.dtype), h


def selective_scan_states(delta, x, b, c, a, interval: int):
    """The states of ``selective_scan`` at the start of every ``interval``
    steps, as the training forward checkpoints them: (B, ceil(T/interval),
    D, N) float32, the first the zero state."""
    bs, t, d = delta.shape
    h = torch.zeros((bs, d, a.shape[-1]), dtype=torch.float32,
                    device=delta.device)
    starts = []
    for i in range(t):
        if i % interval == 0:
            starts.append(h)
        at = torch.exp(delta[:, i, :, None].float() * a.float())
        h = at * h + (delta[:, i] * x[:, i]).float()[..., None] \
            * b[:, i, None, :].float()
    if not starts:
        return h.new_zeros((bs, 0, d, a.shape[-1]))
    return torch.stack(starts, dim=1)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              softcap: float | None = None):
    """q (B,T,H,D), k/v (B,S,KV,D) -> (B,T,H,D), float32 softmax; query and
    key positions are their indices; q head h reads kv head h // (H/KV).
    ``softcap`` c (None or 0: off) caps each scaled score s at c tanh(s/c)
    before the mask, as the JAX package's plain attention does.  Computes
    in float32 whatever the inputs' dtype."""
    return _attend(q, v, _scores(q, k, causal, window, torch.float32,
                                 softcap)).to(q.dtype)


# ---------------------------------------------------------------------------
# The training path: forward with log-sum-exp, and the two backwards
# ---------------------------------------------------------------------------

NEG_INF = -1e30     # the mask value of ``attention`` and the flash kernels


def _work_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _band(t: int, s: int, causal: bool, window, device) -> torch.Tensor:
    """(T, S) validity of (query, key) by index."""
    qp = torch.arange(t, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    m = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    return m


def _raw_scores(q, k, wd):
    """Scaled scores (B, KV, rep, T, S) in dtype ``wd``, unmasked."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, d).to(wd)
    return torch.einsum("btgrk,bsgk->bgrts", qg, k.to(wd)) / math.sqrt(d)


def _scores(q, k, causal, window, wd, softcap=None, raw=None):
    """Masked scaled scores (B, KV, rep, T, S) in dtype ``wd``, capped at
    ``softcap`` c tanh(s/c) before the mask when it is set; ``raw`` the
    unmasked scaled scores where the caller has them."""
    t, s = q.shape[1], k.shape[1]
    sc = _raw_scores(q, k, wd) if raw is None else raw
    if softcap:
        sc = softcap * torch.tanh(sc / softcap)
    return torch.where(_band(t, s, causal, window, q.device), sc, NEG_INF)


def _attend(q, v, sc):
    """softmax(scores) V -> (B,T,H,D) in the scores' dtype."""
    b, t, h, d = q.shape
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bgrts,bsgk->btgrk", w, v.to(sc.dtype))
    return out.reshape(b, t, h, d)


def attention_lse(q, k, v, *, causal: bool = True, window=None,
                  softcap=None):
    """``attention`` with its rows' log-sum-exp of the masked scaled (and
    capped) scores and the output before its rounding to q's dtype ->
    (out (B,T,H,D) in q's dtype, lse (B,H,T) float32, o32 (B,T,H,D)
    float32, ``out`` itself
    for float32 and float64 inputs): o32 is the O that ``attention_bwd``
    takes on the training path.  A row with no key in its band has lse =
    -1e30 (every score is the mask value): its output is the uniform
    average of v, as in ``attention``."""
    b, t, h, _ = q.shape
    sc = _scores(q, k, causal, window, _work_dtype(q), softcap)
    full = _attend(q, v, sc)
    out = full.to(q.dtype)
    lse = torch.logsumexp(sc, dim=-1).reshape(b, h, t)
    return out, lse, (out if q.dtype in (torch.float32, torch.float64)
                      else full)


def attention_bwd(q, k, v, o, lse, do, *, causal: bool = True, window=None,
                  softcap=None):
    """The backward of ``attention`` from its output and log-sum-exp, the
    formula the flash backward kernels compute:

        P  = exp(S - lse)              (S the masked scaled scores, capped)
        D  = rowsum(dO * O)
        dV = P^T dO                    (summed over the group's q heads)
        dS = P * (dO V^T - D)          (0 where the mask holds)
             * (1 - tanh^2(s / c))     (with ``softcap`` c, s the scaled
                                        score before its cap)
        dQ = dS K / sqrt(d),   dK = dS^T Q / sqrt(d)

    A row with no key in its band (lse <= -1e30 / 2) weighs every key
    1/S and passes no gradient to its scores, as softmax over equal masked
    scores does.  ``o`` is in q's dtype or in float32 (the output before
    its rounding, which the training path passes: D from a bfloat16 O
    moves dQ and dK by up to 0.005 of their scale).  -> (dq, dk, dv) in
    the inputs' dtypes."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    wd = _work_dtype(q)
    raw = _raw_scores(q, k, wd)                              # (B,G,R,T,S)
    sc = _scores(q, k, causal, window, wd, softcap, raw)
    band = _band(t, s, causal, window, q.device)
    lse_g = lse.to(wd).reshape(b, kvh, rep, t)[..., None]
    empty = lse_g <= NEG_INF / 2
    p = torch.where(empty, torch.full_like(sc, 1.0 / s), torch.exp(sc - lse_g))
    dog = do.reshape(b, t, kvh, rep, d).to(wd)
    og = o.reshape(b, t, kvh, rep, d).to(wd)
    dsum = (dog * og).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B,G,R,T,1)
    dv = torch.einsum("bgrts,btgrk->bsgk", p, dog)
    dp = torch.einsum("btgrk,bsgk->bgrts", dog, v.to(wd))
    ds = torch.where(band & ~empty, p * (dp - dsum), 0.0)
    if softcap:
        ds = ds * (1 - torch.tanh(raw / softcap) ** 2)
    ds = ds / math.sqrt(d)
    dq = torch.einsum("bgrts,bsgk->btgrk", ds, k.to(wd)).reshape(b, t, h, d)
    dk = torch.einsum("bgrts,btgrk->bsgk", ds,
                      q.reshape(b, t, kvh, rep, d).to(wd))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def selective_scan_bwd(delta, x, b, c, a, dy, dh_final=None):
    """The backward of ``selective_scan``, one time step at a time: the
    states h_t by a forward sweep, then the reverse sweep

        g_t = dy_t C_t + exp(delta_{t+1} A) g_{t+1},  from g = dh_final,

    and per step dC_t = sum_D dy_t h_t, dB_t = sum_D g_t delta_t x_t,
    dx_t = delta_t sum_N g_t B_t, ddelta_t = sum_N g_t (A e^{delta_t A}
    h_{t-1} + x_t B_t), dA = sum_{B,T} g_t delta_t e^{delta_t A} h_{t-1}.
    ``dh_final`` None reads as zeros.  -> (ddelta, dx, db, dc, da) in the
    inputs' dtypes."""
    wd = _work_dtype(delta)
    dl, xx, bb, cc, aa, gy = (v.to(wd) for v in (delta, x, b, c, a, dy))
    bs, t, d = dl.shape
    n = aa.shape[-1]
    hs = [torch.zeros((bs, d, n), dtype=wd, device=dl.device)]
    for i in range(t):
        at = torch.exp(dl[:, i, :, None] * aa)
        hs.append(at * hs[-1] + (dl[:, i] * xx[:, i])[..., None]
                  * bb[:, i, None, :])
    carry = (torch.zeros_like(hs[0]) if dh_final is None
             else dh_final.to(wd).clone())
    dd, dx, db, dc = (torch.empty_like(v) for v in (dl, xx, bb, cc))
    da = torch.zeros_like(aa)
    for i in reversed(range(t)):
        at = torch.exp(dl[:, i, :, None] * aa)               # (B,D,N)
        h_prev, h_t = hs[i], hs[i + 1]
        g = gy[:, i, :, None] * cc[:, i, None, :] + carry
        dc[:, i] = (gy[:, i, :, None] * h_t).sum(1)
        db[:, i] = (g * (dl[:, i] * xx[:, i])[..., None]).sum(1)
        dx[:, i] = dl[:, i] * (g * bb[:, i, None, :]).sum(-1)
        dd[:, i] = (g * (aa * at * h_prev
                         + xx[:, i, :, None] * bb[:, i, None, :])).sum(-1)
        da += (g * dl[:, i, :, None] * at * h_prev).sum(0)
        carry = at * g
    return (dd.to(delta.dtype), dx.to(x.dtype), db.to(b.dtype),
            dc.to(c.dtype), da.to(a.dtype))
