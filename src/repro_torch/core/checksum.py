"""Chunk checksums (HDFS keeps a CRC per 512B chunk; HAIL recomputes them
per replica because each replica's sort order differs — §3.2).

A vectorised position-weighted Fletcher-style sum: order-sensitive (it
detects a permutation, not only corruption).  The values equal the JAX
package's uint32 sums; they are held as int64 because PyTorch has no uint32
``%``/``<<`` on CUDA.  Each partial sum fits in int32 (at most
512 * 255 * 513 / 2 before the modulus), so the per-byte work stays in
int32 and only the per-chunk sums widen.
"""
from __future__ import annotations

import torch

CHUNK = 512  # bytes, HDFS default
_P = 65521


def _chunks(data: torch.Tensor, batch: int) -> torch.Tensor:
    """Any tensor's little-endian bytes, (batch, n_chunks, CHUNK) int32,
    the last chunk of each of the ``batch`` leading slices zero-padded."""
    raw = data.contiguous().view(torch.uint8).reshape(batch, -1)
    pad = (-raw.shape[1]) % CHUNK
    if pad:
        raw = torch.nn.functional.pad(raw, (0, pad))
    return raw.reshape(batch, -1, CHUNK).to(torch.int32)


def _sums(chunks: torch.Tensor) -> torch.Tensor:
    weights = torch.arange(1, CHUNK + 1, dtype=torch.int32,
                           device=chunks.device)
    s1 = chunks.sum(dim=-1) % _P
    s2 = (chunks * weights).sum(dim=-1) % _P
    return (s2 << 16) | s1


def chunk_checksums(data: torch.Tensor) -> torch.Tensor:
    """-> int64 (n_chunks,) position-weighted checksums of all of ``data``."""
    return _sums(_chunks(data, 1))[0]


def batched_chunk_checksums(data: torch.Tensor) -> torch.Tensor:
    """``chunk_checksums`` of each leading slice: (k, ...) -> (k, n_chunks)."""
    return _sums(_chunks(data, data.shape[0]))


def verify(data: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """-> bool (n_chunks,) chunk validity."""
    return chunk_checksums(data) == sums


def block_checksums(cols: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: chunk_checksums(v) for k, v in sorted(cols.items())}


def verify_block(cols: dict[str, torch.Tensor],
                 sums: dict[str, torch.Tensor]) -> torch.Tensor:
    """-> 0-d bool tensor: every chunk of every column matches its sum."""
    ok = torch.tensor(True)
    for k in sorted(cols):
        ok = ok & verify(cols[k], sums[k]).all()
    return ok


def verify_blocks(data: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Batched read-path verify: data (C, B, rows), sums (C, B, chunks)
    -> bool (C, B), True where EVERY chunk of (col, block) matches."""
    c, b = data.shape[:2]
    got = batched_chunk_checksums(data.reshape(c * b, *data.shape[2:]))
    return (got == sums.reshape(c * b, -1)).all(dim=-1).reshape(c, b)


def verify_root(mins: torch.Tensor, sorted_keys: torch.Tensor,
                partition_size: int) -> torch.Tensor:
    """Root-directory consistency: mins (B, P) vs sorted key column
    (B, rows) -> bool (B,).  The root directory is NOT checksummed (it is
    derived state), so a corrupt/stale directory is caught by re-deriving
    the partition minima from the (checksum-verified) key column."""
    return (mins == sorted_keys[:, ::partition_size]).all(dim=1)
