"""ASCII -> binary parsing (the HAIL client's to-PAX conversion).

The paper's client parses text logs row by row while uploading.  Here the
parse is a tensor program: bytes (rows, row_width) -> per-column int32
values + a bad-record mask.  A row is *bad* when any of its digit positions
is not '0'..'9' (paper §3.1: bad records are separated into a special part
of the block and handed to the map function with a flag).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schema import Schema


def format_rows(schema: Schema, cols: dict[str, np.ndarray],
                bad_fraction: float = 0.0, seed: int = 1) -> np.ndarray:
    """Host-side encoder: columns -> uint8 text block (rows, row_width)."""
    n = len(next(iter(cols.values())))
    parts = []
    for c in schema.columns:
        v = np.asarray(cols[c.name]).astype(np.int64)
        w = c.ascii_width
        digits = np.zeros((n, w), dtype=np.uint8)
        rem = v.copy()
        for i in range(w - 1, -1, -1):
            digits[:, i] = (rem % 10).astype(np.uint8) + ord("0")
            rem //= 10
        parts.append(digits)
    nl = np.full((n, 1), ord("\n"), dtype=np.uint8)
    out = np.concatenate(parts + [nl], axis=1)
    if bad_fraction > 0:
        r = np.random.default_rng(seed)
        bad = r.random(n) < bad_fraction
        idx = np.nonzero(bad)[0]
        # corrupt a random byte with a non-digit
        out[idx, r.integers(0, out.shape[1] - 1, len(idx))] = ord("x")
    return out


def parse_block(schema: Schema, raw: torch.Tensor
                ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """raw (..., rows, row_width) uint8 -> ({col: int32 (..., rows)},
    bad (..., rows) bool).  Leading dimensions batch blocks."""
    digits = raw.to(torch.int32) - ord("0")
    cols: dict[str, torch.Tensor] = {}
    bad = torch.zeros(raw.shape[:-1], dtype=torch.bool, device=raw.device)
    off = 0
    for c in schema.columns:
        w = c.ascii_width
        d = digits[..., off:off + w]
        bad |= ((d < 0) | (d > 9)).any(dim=-1)
        # Horner scheme in int32: partial values never exceed the final value,
        # so valid rows (schema contract: values < 2^31) cannot overflow.
        val = torch.zeros(raw.shape[:-1], dtype=torch.int32, device=raw.device)
        for i in range(w):
            val = val * 10 + d[..., i]
        cols[c.name] = val
        off += w
    # zero out bad rows (they live in the block's bad-record section)
    cols = {k: torch.where(bad, 0, v) for k, v in cols.items()}
    return cols, bad


def block_binary_bytes(schema: Schema, n_rows: int) -> int:
    """Size of the binary PAX representation (int32 per column)."""
    return 4 * len(schema.columns) * n_rows


def block_ascii_bytes(schema: Schema, n_rows: int) -> int:
    return schema.row_ascii_width * n_rows
