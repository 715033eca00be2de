"""Stable block sort: the adaptive index build's per-block sort.

The port of the JAX package's ``kernels/block_sort.py``.  Its bitonic
network sorts each block's int32 keys under the lexicographic (key,
original position) comparator, so its permutation is the stable argsort an
eager upload produces; ``ops.sort_block`` then gathers every PAX column by
it.  ``bitonic_sort_plain`` runs that network with tensor operations.

The CUDA kernel (``csrc/block_sort.cu``) computes the same function as a
stable LSD radix sort over four 8-bit digits, in the one-sweep style: one
histogram launch and one launch per digit, each tile's digit offsets from
decoupled look-back.  A stable radix sort's permutation is the stable
argsort, bit for bit, and it moves each key four times where the network
makes log n (log n + 1) / 2 steps (36 launches for a 2^19-row block).
``bitonic_sort`` routes by device: a CPU tensor takes the plain version, a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
TILE = 4096      # keys a CTA ranks in one digit pass (csrc kTile)
DIGITS = 4       # 8-bit digit passes over 32-bit keys
RADIX = 256


def _compare_exchange(keys, perm, j: int, k: int):
    """One network step: partner = pos ^ j, ascending iff (pos & k) == 0."""
    b, n = keys.shape
    groups = n // (2 * j)
    a_k = keys.reshape(b, groups, 2, j)
    a_p = perm.reshape(b, groups, 2, j)
    lo_k, hi_k = a_k[:, :, 0], a_k[:, :, 1]
    lo_p, hi_p = a_p[:, :, 0], a_p[:, :, 1]
    base = torch.arange(groups, dtype=torch.int32,
                        device=keys.device) * (2 * j)
    asc = ((base & k) == 0)[None, :, None]
    gt = (lo_k > hi_k) | ((lo_k == hi_k) & (lo_p > hi_p))
    lt = (lo_k < hi_k) | ((lo_k == hi_k) & (lo_p < hi_p))
    swap = torch.where(asc, gt, lt)
    keys = torch.stack([torch.where(swap, hi_k, lo_k),
                        torch.where(swap, lo_k, hi_k)], dim=2).reshape(b, n)
    perm = torch.stack([torch.where(swap, hi_p, lo_p),
                        torch.where(swap, lo_p, hi_p)], dim=2).reshape(b, n)
    return keys, perm


def bitonic_sort_plain(keys: torch.Tensor):
    """keys (blocks, n) int32, n a power of two -> (sorted, int32 perm)."""
    b, n = keys.shape
    perm = torch.arange(n, dtype=torch.int32,
                        device=keys.device).expand(b, n).contiguous()
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            keys, perm = _compare_exchange(keys, perm, j, k)
            j //= 2
        k *= 2
    return keys, perm


def _launch(keys: torch.Tensor):
    if keys.dtype != torch.int32 or keys.dim() != 2:
        raise ValueError(f"bitonic_sort: keys must be 2-d int32, got "
                         f"{keys.dim()}-d {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("bitonic_sort: keys must be contiguous")
    b, n = keys.shape
    if n >= 1 << 30:
        raise ValueError(f"bitonic_sort: {n} rows do not fit the kernel's "
                         f"30-bit counts")
    out = torch.empty_like(keys)
    perm = torch.empty_like(keys)
    if b == 0 or n == 0:
        return out, perm
    tmp_keys = torch.empty_like(keys)
    tmp_perm = torch.empty_like(keys)
    tiles = max(1, n // TILE)
    # one zeroed allocation: the histogram (b, 4, 256), the look-back words
    # (4, b, tiles, 256) and the tile counters (4, b)
    n_hist, n_status = b * DIGITS * RADIX, DIGITS * b * tiles * RADIX
    scratch = torch.zeros(n_hist + n_status + DIGITS * b, dtype=torch.int32,
                          device=keys.device)
    hist, status, counters = scratch.split([n_hist, n_status, DIGITS * b])
    fn = _build.entry("bitonic_sort_launch", _ARGTYPES)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        code = fn(keys.data_ptr(), out.data_ptr(), perm.data_ptr(),
                  tmp_keys.data_ptr(), tmp_perm.data_ptr(), hist.data_ptr(),
                  status.data_ptr(), counters.data_ptr(), b, n, stream)
    _build.check("bitonic_sort", code)
    return out, perm


def bitonic_sort(keys: torch.Tensor):
    """keys (blocks, n) int32, n a power of two -> (sorted keys, int32
    permutation), stable: ties keep their original order."""
    n = keys.shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic_sort: rows must be a power of two, got {n}")
    if keys.device.type == "cpu":
        return bitonic_sort_plain(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"bitonic_sort: no kernel for device {keys.device}")
    return _launch(keys)
