"""Sparse clustered index (paper §3.5, Figure 2).

After sorting a block by the index key, the index is a single root directory
of partition-minimum keys over fixed 1,024-row partitions; leaves (the
partitions) are contiguous, so child offsets are implicit
(leaf_id * partition_size).  A range lookup searches the root for the first
and last qualifying partition, streams exactly those partitions, and
post-filters.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

PARTITION = 1024  # rows per leaf partition (paper's default)
INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ClusteredIndex:
    """Root directory for one block: mins (n_parts,), key column name."""
    key: str
    partition_size: int


def sort_permutation(key_col: torch.Tensor,
                     bad: torch.Tensor | None = None) -> torch.Tensor:
    """Permutation sorting each block (last axis) by key; bad records go to
    the tail (the paper's 'special part of the data block').  Keys are int32
    with INT32_MAX reserved as the bad-record sentinel (schema contract).
    A library stable sort: the JAX package also sorts the eager upload
    outside any kernel."""
    k = key_col
    if bad is not None:
        k = torch.where(bad, INT32_MAX, k)
    return torch.sort(k, dim=-1, stable=True).indices


def build_root(sorted_key: torch.Tensor,
               partition_size: int = PARTITION) -> torch.Tensor:
    """Partition minima (the root directory). rows % partition_size == 0."""
    return sorted_key[::partition_size]


def build_block_roots(sorted_keys: torch.Tensor,
                      partition_size: int = PARTITION) -> torch.Tensor:
    """Batched ``build_root``: (k_blocks, rows) -> (k_blocks, n_parts)."""
    return sorted_keys[:, ::partition_size].contiguous()


def merge_block_roots(mins: torch.Tensor, block_ids,
                      new_mins: torch.Tensor) -> torch.Tensor:
    """Incremental root-directory merge (adaptive indexing): splice freshly
    built per-block root directories into a replica's (n_blocks, n_parts)
    directory.  Out of place — readers holding the old directory are
    unaffected; the store swaps in the merged one at commit."""
    bsel = torch.as_tensor(np.asarray(block_ids, np.int64), device=mins.device)
    return mins.index_copy(0, bsel, new_mins)


def search_range(mins: torch.Tensor, lo, hi, partition_size: int,
                 n_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (row_start, row_end) half-open row range covering [lo, hi], per
    root directory: mins (..., n_parts) -> two int32 (...) tensors.

    p_first = last partition whose min < lo (clamped to 0): the first
              that can hold a key >= lo;
    p_last  = last partition whose min <= hi.
    (The JAX package takes the last partition whose min <= lo, and so
    misses rows equal to lo before a partition that starts with lo.)
    """
    shape = (*mins.shape[:-1], 1)
    mins = mins.contiguous()
    first = torch.searchsorted(
        mins, torch.full(shape, lo, dtype=mins.dtype, device=mins.device))
    last = torch.searchsorted(
        mins, torch.full(shape, hi, dtype=mins.dtype, device=mins.device),
        right=True)
    row_start = torch.clamp(first[..., 0].to(torch.int32) - 1,
                            min=0) * partition_size
    row_end = torch.clamp((torch.clamp(last[..., 0].to(torch.int32) - 1, min=0)
                           + 1) * partition_size, max=n_rows)
    return row_start, row_end


def index_scan_mask(sorted_key: torch.Tensor, mins: torch.Tensor, lo, hi,
                    partition_size: int = PARTITION) -> torch.Tensor:
    """Qualifying-row mask touching only rows inside the partition range;
    sorted_key (..., rows) with mins (..., n_parts)."""
    n = sorted_key.shape[-1]
    row_start, row_end = search_range(mins, lo, hi, partition_size, n)
    r = torch.arange(n, dtype=torch.int32, device=sorted_key.device)
    in_range = (r >= row_start[..., None]) & (r < row_end[..., None])
    pred = (sorted_key >= lo) & (sorted_key <= hi)
    return in_range & pred


def full_scan_mask(key_col: torch.Tensor, lo, hi) -> torch.Tensor:
    return (key_col >= lo) & (key_col <= hi)


def rows_read_fraction(mins: torch.Tensor, lo, hi, partition_size: int,
                       n_rows: int) -> torch.Tensor:
    """Fraction of the block the index scan must read (I/O model)."""
    row_start, row_end = search_range(mins, lo, hi, partition_size, n_rows)
    return (row_end - row_start).to(torch.float32) / n_rows
