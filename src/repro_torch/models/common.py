"""Shared model components: RMSNorm, RoPE (with M-RoPE), embedding specs.

The port of the JAX package's ``models/common.py``."""
from __future__ import annotations

import torch

from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import TensorSpec, tspec


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> TensorSpec:
    return tspec((d,), ("act_embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, dim: int,
                 theta: float) -> torch.Tensor:
    """positions (...,) -> angles (..., dim//2)."""
    half = dim // 2
    return positions[..., None].float() * _freqs(0, half, half, theta,
                                                 positions.device)


def _freqs(start: int, stop: int, half: int, theta: float,
           device) -> torch.Tensor:
    """theta^(-i / half) for i in [start, stop), made on ``device`` (no
    host copy, which would wait for the device's queue at every call):
    the float32 exponent, as the JAX package computes it, raised in
    float64 and rounded once to float32, the same bits on every device.
    (A float32 ``pow`` is an ulp off for some of these in one library or
    another: XLA's on the CPU for 7 of head dim 80's 40, torch's for 3 of
    64; and an angle's error grows with the position.)  The exponent is
    the float64 quotient rounded to float32, the correctly rounded float32
    quotient on every device (PyTorch's CUDA division of a float32 tensor
    by a scalar multiplies by the reciprocal, which need not round to the
    quotient where half is not a power of two, as 40)."""
    e = (-torch.arange(start, stop, dtype=torch.float64, device=device)
         / half).float()
    return (theta ** e.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               mrope_section: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rotate pairs (x[..., :half], x[..., half:]).

    x: (B, T, H, D). positions: (B, T) — or (3, B, T) for M-RoPE, where the
    head-dim half is split into ``mrope_section`` chunks rotated by the
    t/h/w position streams respectively (Qwen2-VL)."""
    d = x.shape[-1]
    half = d // 2
    if mrope_section is None:
        ang = _rope_angles(positions, d, theta)           # (B, T, half)
    else:
        if positions.dim() != 3 or positions.shape[0] != len(mrope_section):
            raise ValueError(f"apply_rope: M-RoPE takes ({len(mrope_section)}"
                             f", B, T) positions, got "
                             f"{tuple(positions.shape)}")
        ang = torch.cat([
            _mrope_part(positions[i], sec, d, theta, sum(mrope_section[:i]))
            for i, sec in enumerate(mrope_section)], dim=-1)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def _mrope_part(pos: torch.Tensor, sec: int, d: int, theta: float,
                offset: int) -> torch.Tensor:
    """Frequencies for an M-RoPE section use the *global* frequency ladder
    (indices offset..offset+sec of the d//2 ladder), per Qwen2-VL."""
    return pos[..., None].float() * _freqs(offset, offset + sec, d // 2,
                                           theta, pos.device)


def default_positions(batch: int, seq: int, device=None,
                      mrope: bool = False) -> torch.Tensor:
    """(B, T) int32 indices, or the same for each of the three M-RoPE
    streams, (3, B, T), with ``mrope``."""
    p = torch.arange(seq, dtype=torch.int32, device=device)[None].expand(
        batch, seq)
    return p[None].expand(3, batch, seq) if mrope else p


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


def embed_spec(vocab: int, d: int) -> TensorSpec:
    return tspec((vocab, d), ("vocab", "embed"), init="embed")


def unembed_spec(d: int, vocab: int) -> TensorSpec:
    return tspec((d, vocab), ("embed", "vocab"))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 scale: float | None,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of ``table`` in ``dtype`` (gathered first, then cast: the same
    values as casting the whole table first, without the copy).

    Sharded (inside a slot's context) the lookup is vocab-parallel: the
    slot's part of the table, gathered over "data", holds a range of the
    vocabulary; the slot looks up the ids in its range, writes zeros for
    the rest, and the rows are all-reduced over the axes that split the
    vocabulary.  Each row comes from one slot, so the sum is exact."""
    if sh.in_slot():
        table = sh.gather_tree(table, "data")
        vocab_axes = sh.slot_layout(table)[0]
        rows = table.shape[0]
        ids = tokens.long() - sh.slot_index(vocab_axes)[0] * rows
        inside = (ids >= 0) & (ids < rows)
        x = table[ids.clamp(0, rows - 1)].to(dtype)
        x = torch.where(inside[..., None], x, torch.zeros(
            (), dtype=dtype, device=x.device))
        if vocab_axes:
            x = sh.all_reduce(x, vocab_axes)
    else:
        x = table[tokens.long()].to(dtype)
    if scale is not None:
        x = x * torch.tensor(scale, dtype=dtype, device=x.device)
    return x
