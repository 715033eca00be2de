"""Single-block PAX range scan: the range mask over one key column, the
projection with the rows outside the range set to 0, and one match count
per row tile.

The port of the JAX package's ``kernels/pax_scan.py``.  The fused reader
(``hail_reader``) subsumes it, so no path of the system calls it;
``ops.pax_scan`` is its entry point.  The CUDA kernel (``csrc/pax_scan.cu``)
gives each row tile one CTA; the tile follows the TPU kernel's rule
(``row_tile`` lowered until it divides the rows), so the counts have the
TPU kernel's shape and values.  int32 and float32 projections are copied
as 32-bit words by one kernel; (lo, hi) travel as a device int32 pair, so
one kernel variant serves every range.

``pax_scan`` routes by device: a CPU tensor takes the plain version
(``pax_scan_plain``, which also counts per tile), a CUDA tensor launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels.index_search import lohi_pair

ROW_TILE = 1024             # the TPU kernel's default row tile

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 6 + [_I] * 3 + [_P]


def row_tile_for(rows: int, row_tile: int = ROW_TILE) -> int:
    """The TPU kernel's tile: ``min(row_tile, rows)``, lowered until it
    divides ``rows``."""
    tr = min(row_tile, rows)
    while tr > 1 and rows % tr:
        tr -= 1
    return max(tr, 1)


def pax_scan_plain(key_col, proj, lo, hi, *, row_tile: int = ROW_TILE):
    """``ref.pax_scan`` with the TPU kernel's per-tile counts."""
    mask, out, _ = ref.pax_scan(key_col, proj, lo, hi)
    rows = key_col.shape[0]
    tr = row_tile_for(rows, row_tile)
    counts = mask.reshape(-1, tr).sum(-1, dtype=torch.int32) if rows else \
        torch.zeros((0,), dtype=torch.int32, device=key_col.device)
    return mask, out, counts


def _check(key_col, proj):
    if key_col.dtype != torch.int32 or key_col.dim() != 1:
        raise ValueError(f"pax_scan: key_col must be 1-d int32, got "
                         f"{key_col.dim()}-d {key_col.dtype}")
    if proj.dtype not in (torch.int32, torch.float32) or proj.dim() != 2:
        raise ValueError(f"pax_scan: proj must be 2-d int32 or float32, got "
                         f"{proj.dim()}-d {proj.dtype}")
    if proj.device != key_col.device:
        raise ValueError(f"pax_scan: proj on {proj.device}, key_col on "
                         f"{key_col.device}")
    if proj.shape[0] != key_col.shape[0]:
        raise ValueError(f"pax_scan: inconsistent shapes key_col "
                         f"{tuple(key_col.shape)}, proj {tuple(proj.shape)}")
    if not (key_col.is_contiguous() and proj.is_contiguous()):
        raise ValueError("pax_scan: key_col and proj must be contiguous")


def _launch(key_col, proj, lo, hi, row_tile):
    rows, n_cols = proj.shape
    dev = key_col.device
    mask = torch.empty((rows,), dtype=torch.bool, device=dev)
    out = torch.empty_like(proj)
    if rows == 0:
        return mask, out, torch.zeros((0,), dtype=torch.int32, device=dev)
    tr = row_tile_for(rows, row_tile)
    counts = torch.empty((rows // tr,), dtype=torch.int32, device=dev)
    lohi = lohi_pair(lo, hi, dev)
    fn = _build.entry("pax_scan_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(key_col.data_ptr(), proj.data_ptr(), lohi.data_ptr(),
                  mask.data_ptr(), out.data_ptr(), counts.data_ptr(),
                  rows // tr, tr, n_cols, stream)
    _build.check("pax_scan", code)
    return mask, out, counts


def pax_scan(key_col: torch.Tensor, proj: torch.Tensor, lo, hi, *,
             row_tile: int = ROW_TILE):
    """key_col (rows,) int32, proj (rows, C) int32 or float32; lo, hi ints or
    0-d tensors -> (mask (rows,) bool, masked proj in proj's dtype,
    per-tile counts (rows // tile,) int32)."""
    _check(key_col, proj)
    if row_tile < 1:
        raise ValueError(f"pax_scan: row_tile must be >= 1, got {row_tile}")
    if key_col.device.type == "cpu":
        return pax_scan_plain(key_col, proj, lo, hi, row_tile=row_tile)
    if key_col.device.type != "cuda":
        raise ValueError(f"pax_scan: no kernel for device {key_col.device}")
    return _launch(key_col, proj, lo, hi, row_tile)
