"""Shared model components: RMSNorm, RoPE (with M-RoPE), embedding specs.

The port of the JAX package's ``models/common.py``."""
from __future__ import annotations

import torch

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
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions[..., None].float() * freqs


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
    half = d // 2
    idx = torch.arange(offset, offset + sec, dtype=torch.float32,
                       device=pos.device)
    freqs = theta ** (-idx / half)
    return pos[..., None].float() * freqs


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
    values as casting the whole table first, without the copy)."""
    x = table[tokens.long()].to(dtype)
    if scale is not None:
        x = x * torch.tensor(scale, dtype=dtype, device=x.device)
    return x
