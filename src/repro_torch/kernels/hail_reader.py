"""Fused HAIL record reader: ONE launch per (split, query batch).

The port of the JAX package's ``kernels/hail_reader.py``.  The CUDA entry
point (``csrc/hail_reader.cu``) runs a whole split — per-block root-directory
lookup, tile-pruned range scan over Q queries, bad-row mask, union-masked
projection, per-(block, query) rows-read fractions — in two kernels:
``reader_kernel_ranges`` counts each block's root directory once per
(block, query) into a (B, Q, 4) scratch table, and ``reader_kernel_scan``,
one CTA per (row tile, block), stages each live tile's keys and bad flags
in shared memory, computes the tile's mask bytes into a shared-memory
window and writes the window and the masked projection as 16-byte stores,
with scalar heads and tails where a range is not 16-byte aligned.  The query ranges travel as a
(Q, 2) device tensor, so new ranges never build a new kernel; Q is a
runtime size of any value >= 1.

``hail_read_batch`` routes by device: a CPU tensor takes the plain version
(``hail_read_batch_plain``, the ``ref.py`` counterpart), a CUDA tensor
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

hail_read_batch_plain = ref.hail_read_batch

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 10 + [_I] * 6 + [_P]


def _check(mins, keys, proj, bad, use_index, lohi):
    dev = keys.device
    for name, t, dtype, ndim in (("mins", mins, torch.int32, 2),
                                 ("keys", keys, torch.int32, 2),
                                 ("proj", proj, torch.int32, 3),
                                 ("bad", bad, torch.bool, 2),
                                 ("use_index", use_index, torch.int32, 1),
                                 ("lohi", lohi, torch.int32, 2)):
        if t.device != dev:
            raise ValueError(f"hail_read: {name} on {t.device}, keys on {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"hail_read: {name} must be {ndim}-d {dtype}, "
                             f"got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"hail_read: {name} must be contiguous")
    b, rows = keys.shape
    if (mins.shape[0] != b or proj.shape[:2] != (b, rows)
            or bad.shape != (b, rows) or use_index.shape != (b,)
            or lohi.shape[1] != 2):
        raise ValueError(
            f"hail_read: inconsistent shapes mins {tuple(mins.shape)}, keys "
            f"{tuple(keys.shape)}, proj {tuple(proj.shape)}, bad "
            f"{tuple(bad.shape)}, use_index {tuple(use_index.shape)}, lohi "
            f"{tuple(lohi.shape)}")
    if lohi.shape[0] < 1:
        raise ValueError(f"hail_read: at least one query, got "
                         f"{lohi.shape[0]}")


def _launch(mins, keys, proj, bad, use_index, lohi, partition_size: int):
    _check(mins, keys, proj, bad, use_index, lohi)
    b, rows = keys.shape
    n_cols, n_q = proj.shape[2], lohi.shape[0]
    mask = torch.empty((b, rows, n_q), dtype=torch.bool, device=keys.device)
    out = torch.empty((b, rows, n_cols), dtype=torch.int32, device=keys.device)
    frac = torch.empty((b, n_q), dtype=torch.float32, device=keys.device)
    if b == 0 or rows == 0:
        return mask, out, frac
    # {lo, hi, r0, r1} per (block, query), written by the first kernel
    ranges = torch.empty((b, n_q, 4), dtype=torch.int32, device=keys.device)
    fn = _build.entry("hail_read_launch", _ARGTYPES)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = fn(mins.data_ptr(), keys.data_ptr(), proj.data_ptr(),
                  bad.data_ptr(), use_index.data_ptr(), lohi.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), frac.data_ptr(),
                  ranges.data_ptr(), b, rows, mins.shape[1], n_cols, n_q,
                  partition_size, stream)
    _build.check("hail_read", code)
    return mask, out, frac


def hail_read_batch(mins, keys, proj, bad, use_index, lohi, *,
                    partition_size: int):
    """mins (B, P) int32, keys (B, R) int32, proj (B, R, C) int32, bad (B, R)
    bool, use_index (B,) int32, lohi (Q, 2) int32, all on one device
    -> (mask (B, R, Q) bool, proj masked by the union of the Q masks
    (B, R, C) int32, rows_read_frac (B, Q) float32)."""
    if keys.device.type == "cpu":
        return hail_read_batch_plain(mins, keys, proj, bad, use_index, lohi,
                                     partition_size=partition_size)
    if keys.device.type != "cuda":
        raise ValueError(f"hail_read: no kernel for device {keys.device}")
    return _launch(mins, keys, proj, bad, use_index, lohi, partition_size)
