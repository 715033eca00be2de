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


def attention(q, k, v, *, causal: bool = True, window: int | None = None):
    """q (B,T,H,D), k/v (B,S,KV,D) -> (B,T,H,D), float32 softmax; query and
    key positions are their indices; q head h reads kv head h // (H/KV)."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, t, kvh, rep, d).float()
    sc = torch.einsum("btgrk,bsgk->bgrts", qg, k.float()) / math.sqrt(d)
    qp = torch.arange(t, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    m = torch.ones((t, s), dtype=torch.bool, device=q.device)
    if causal:
        m = m & (kp <= qp)
    if window is not None:
        m = m & (kp > qp - window)
    sc = torch.where(m, sc, -1e30)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bgrts,bsgk->btgrk", w, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)
