"""Shared model components: RMSNorm, RoPE, embedding specs.

The port of the JAX package's ``models/common.py``; M-RoPE waits for the
family that needs it."""
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

    x: (B, T, H, D). positions: (B, T)."""
    if mrope_section is not None:
        raise NotImplementedError("M-RoPE waits for the family that needs it")
    d = x.shape[-1]
    half = d // 2
    ang = _rope_angles(positions, d, theta)               # (B, T, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    return torch.arange(seq, dtype=torch.int32,
                        device=device)[None].expand(batch, seq)


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
