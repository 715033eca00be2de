"""Losses: softmax cross-entropy, and a chunked variant that computes the
logits one sequence chunk at a time, so the full (B, T, V) tensor never
exists at once (a memory lever for the large vocabularies).

The port of the JAX package's ``models/losses.py``.  Where the JAX package
scans over the chunks with ``jax.checkpoint`` around each, the port loops
and wraps each chunk in ``torch.utils.checkpoint.checkpoint``, so a chunk's
logits are recomputed in the backward instead of kept.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def xent(logits: torch.Tensor, labels: torch.Tensor, mask=None):
    """logits (B,T,V) float32, labels (B,T) int -> scalar mean nll (over
    the positions where ``mask`` is set, if given)."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _chunk_nll(xc, head, lc, mc):
    """(sum of masked nll, sum of mask) of one chunk."""
    logits = torch.einsum("btd,dv->btv", xc, head.to(xc.dtype)).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def chunked_xent(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 n_chunks: int = 8, mask=None):
    """x (B,T,D) final hidden states, head (D,V) -> scalar mean nll, over
    ``n_chunks`` chunks of the sequence (T a multiple of ``n_chunks``)."""
    b, t, _ = x.shape
    if t % n_chunks:
        raise ValueError(f"chunked_xent: T={t} is not a multiple of "
                         f"{n_chunks} chunks")
    tc = t // n_chunks
    ms = (torch.ones((b, t), dtype=torch.float32, device=x.device)
          if mask is None else mask.to(torch.float32))
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * tc, (i + 1) * tc)
        s, m = checkpoint(_chunk_nll, x[:, sl], head, labels[:, sl],
                          ms[:, sl], use_reentrant=False)
        tot = tot + s
        cnt = cnt + m
    return tot / torch.clamp(cnt, min=1.0)
