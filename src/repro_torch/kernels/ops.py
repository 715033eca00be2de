"""Counting wrappers around the kernels the record readers, the adaptive
build and the LM layers (prefill attention, the Mamba1 scan) call, and
around the two standalone primitives the fused reader inlines
(``index_search``, ``pax_scan``).

Routing follows the tensor: a CPU tensor takes the kernel's plain PyTorch
version, a CUDA tensor launches the hand-written kernel or raises — there
is no fallback; a meta tensor (the dry-run's trace) takes the LM kernels'
meta routes, empty outputs of the kernel's shapes.  ``use_kernels(False)`` is an explicit request for the plain
versions on any device.

Counters (the contract of the JAX package's ``kernels/ops.py``):

* ``DISPATCH_COUNTS`` — one per wrapper call, whichever route it takes
  (``hail_read`` once per split, or ``hail_read_sharded_waves`` once per
  wave of splits, plus scan-mode and verification counts;
  ``attention`` and ``selective_scan`` once per layer and prefill;
  ``index_search`` and ``pax_scan`` once per call);
* ``TRACE_COUNTS`` — kernel variants built or selected for the first time
  in this process (the counterpart of a jit retrace).  The reader,
  ``index_search`` and ``pax_scan`` have one variant each, since query
  ranges, batch width and tile size are runtime values, so new ranges
  never add to it;
* ``KERNEL_LAUNCHES`` — per kernel, the calls that really launched CUDA
  work (``_build.check`` counts them; the plain versions never do).

``reader_stats()`` / ``reset_stats()`` expose the first two;
``stats_scope()`` isolates them for one block of code.

Gradients.  With grad enabled and an input that requires grad,
``attention`` and ``selective_scan`` go through a ``torch.autograd.Function``
whose forward launches the forward kernel (attention's also writes the
rows' log-sum-exp) and saves what the backward needs, and whose backward
launches the hand-written backward kernel — on a CPU tensor the plain
forward and the explicit plain backward (``ref.attention_bwd``,
``ref.selective_scan_bwd``), the same formula.  Under ``torch.no_grad()``
(serving) the path is the plain forward launch, unchanged.
``use_kernels(False)`` stays the plain route, with PyTorch's own autograd
through ``ref.attention`` and ``ref.selective_scan``.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

from repro_torch.core import checksum as _ck
from repro_torch.kernels import (_build, block_sort, flash_attention,
                                 hail_reader, index_search as _search,
                                 pax_scan as _pax, ref,
                                 selective_scan as _scan)
from repro_torch.kernels._build import KERNEL_LAUNCHES  # noqa: F401
from repro_torch.obs import trace as _obs_trace

_USE_KERNELS = True

DISPATCH_COUNTS: collections.Counter = collections.Counter()
TRACE_COUNTS: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()


def use_kernels(on: bool):
    global _USE_KERNELS
    _USE_KERNELS = on


def reset_stats():
    DISPATCH_COUNTS.clear()
    TRACE_COUNTS.clear()


def reader_stats() -> dict:
    return {"dispatches": dict(DISPATCH_COUNTS),
            "traces": dict(TRACE_COUNTS)}


class StatsScope:
    """Handle yielded by ``stats_scope`` — holds the scope's counters so
    assertions can also run after the ``with`` block exits."""

    def __init__(self, dispatches: collections.Counter,
                 traces: collections.Counter):
        self.dispatches = dispatches
        self.traces = traces


@contextlib.contextmanager
def stats_scope(merge: bool = True):
    """Isolated dispatch/trace counters for one test or measurement block.

    Swaps FRESH counters into the module globals on entry and restores the
    previous ones on exit (merging the scope's counts back in unless
    ``merge=False``), so dispatch-count assertions see only the calls made
    inside the scope.

        with ops.stats_scope() as s:
            q.read_hail_kernels(store, query, qp)
        assert s.dispatches["hail_read"] == 1
    """
    global DISPATCH_COUNTS, TRACE_COUNTS
    prev_d, prev_t = DISPATCH_COUNTS, TRACE_COUNTS
    DISPATCH_COUNTS = collections.Counter()
    TRACE_COUNTS = collections.Counter()
    scope = StatsScope(DISPATCH_COUNTS, TRACE_COUNTS)
    try:
        yield scope
    finally:
        if merge:
            prev_d.update(scope.dispatches)
            prev_t.update(scope.traces)
        DISPATCH_COUNTS, TRACE_COUNTS = prev_d, prev_t


def sort_block(keys: torch.Tensor, cols: dict[str, torch.Tensor]):
    """Sort blocks by key, permuting all PAX columns.
    keys (blocks, n) -> (sorted_keys, permuted cols, int32 perm).  Rows that
    are not a power of two take the plain stable sort (a shape rule)."""
    n = keys.shape[-1]
    if _USE_KERNELS and n & (n - 1) == 0:
        sorted_keys, perm = block_sort.bitonic_sort(keys)
    else:
        sorted_keys, perm = ref.sort_by_key(keys)
    idx = perm.long()
    out = {c: torch.gather(v, 1, idx) for c, v in cols.items()}
    return sorted_keys, out, perm


def verify_blocks(data: torch.Tensor, sums: torch.Tensor) -> torch.Tensor:
    """Batched chunk-checksum verify: data (C, B, rows) int32 columns
    stacked, sums (C, B, chunks) -> bool (C, B).  ``verify_block_cols``
    counts the (col, block) pairs proven."""
    DISPATCH_COUNTS["verify_blocks"] += 1
    DISPATCH_COUNTS["verify_block_cols"] += int(data.shape[0] * data.shape[1])
    _obs_trace.instant("verify_blocks", track="kernels", cat="dispatch",
                       args={"cols": int(data.shape[0]),
                             "blocks": int(data.shape[1])})
    return _ck.verify_blocks(data, sums)


def verify_root(mins, keys, *, partition_size: int) -> torch.Tensor:
    """Root-directory consistency check (mins vs sorted key column)."""
    DISPATCH_COUNTS["verify_root"] += 1
    return _ck.verify_root(mins, keys, partition_size)


def _host_flags(use_index) -> np.ndarray:
    if torch.is_tensor(use_index):
        return use_index.cpu().numpy()
    return np.asarray(use_index)


def _read(name: str, mins, keys, proj, bad, u: np.ndarray,
          lohi: np.ndarray, partition_size: int):
    uidx = torch.as_tensor(u.astype(np.int32), device=keys.device)
    lohi_t = torch.as_tensor(lohi, device=keys.device)
    if not _USE_KERNELS:
        return ref.hail_read_batch(mins, keys, proj, bad, uidx, lohi_t,
                                   partition_size=partition_size)
    if keys.is_cuda:
        TRACE_COUNTS[name] += _build.note_variant("hail_read", None)
    return hail_reader.hail_read_batch(mins, keys, proj, bad, uidx, lohi_t,
                                       partition_size=partition_size)


def hail_read(mins, keys, proj, bad, use_index, lo, hi, *,
              partition_size: int):
    """Fused split reader: ONE dispatch per call (== per split).

    ``use_index`` should be a HOST (numpy) array: the per-block scan-mode
    counters read it before it ships to the device."""
    DISPATCH_COUNTS["hail_read"] += 1
    u = _host_flags(use_index)
    n_idx = int(u.astype(bool).sum())
    DISPATCH_COUNTS["index_scan_blocks"] += n_idx
    DISPATCH_COUNTS["full_scan_blocks"] += u.shape[0] - n_idx
    _obs_trace.instant("hail_read", track="kernels", cat="dispatch",
                       args={"index_blocks": n_idx,
                             "full_blocks": int(u.shape[0]) - n_idx})
    lohi = np.asarray([[lo, hi]], np.int32)
    mask, out, frac = _read("hail_read", mins, keys, proj, bad, u, lohi,
                            partition_size)
    return mask[..., 0], out, frac[:, 0]


def hail_read_batch(mins, keys, proj, bad, use_index, lohi, *,
                    partition_size: int):
    """Fused shared-scan reader: ONE dispatch per (split, query-batch).

    The scan-mode counters charge each of the Q queries with the blocks it
    logically scanned — serially-equivalent accounting."""
    DISPATCH_COUNTS["hail_read"] += 1
    DISPATCH_COUNTS["hail_read_batch"] += 1
    lohi = np.asarray(lohi, np.int32).reshape(-1, 2)
    n_q = lohi.shape[0]
    u = _host_flags(use_index)
    n_idx = int(u.astype(bool).sum())
    DISPATCH_COUNTS["index_scan_blocks"] += n_q * n_idx
    DISPATCH_COUNTS["full_scan_blocks"] += n_q * (u.shape[0] - n_idx)
    _obs_trace.instant("hail_read_batch", track="kernels", cat="dispatch",
                       args={"queries": n_q, "index_blocks": n_idx,
                             "full_blocks": int(u.shape[0]) - n_idx})
    return _read("hail_read_batch", mins, keys, proj, bad, u, lohi,
                 partition_size)


def hail_read_batch_sharded(splits, lohi, *, partition_size: int, mesh,
                            axes):
    """Sharded fused reader: a WAVE of up to n_dev splits, each split ONE
    reader launch on its own slot of ``mesh`` along ``axes`` (split k on
    slot k), all against the same (Q, 2) ranges.

    ``splits`` holds per-split inputs (mins, keys, proj, bad, use_index) as
    ``query.gather_shared_scan_inputs`` gives them.  A CUDA slot launches on
    its own stream, after the stream has waited for the work that made the
    inputs; a CPU slot takes the plain version.  Inputs move to the slot's
    device where they lie elsewhere (a slot on their own device does not
    copy).  Returns per split (mask, masked proj, frac) on its slot's
    device, made on its slot's stream: the caller records the split's
    completion event there.

    Where the JAX package pads ragged splits with dead blocks and the wave
    with dummy splits (so that one SPMD program runs on every device),
    separate launches need neither: nothing is padded, and each split's
    outputs are those of its own ``hail_read_batch``.  The counters are the
    JAX package's sharded accounting: one ``hail_read_sharded_waves`` a
    wave, one ``hail_read_sharded_splits`` per split it carries, and no
    ``hail_read`` / ``hail_read_batch``; the scan-mode counters are the
    caller's (``query.read_hail_batch_sharded``)."""
    axes = tuple(axes)
    slots = mesh.slots(axes)
    if not 1 <= len(splits) <= len(slots):
        raise ValueError(f"hail_read_batch_sharded: {len(splits)} splits "
                         f"for a wave of {len(slots)} slots")
    DISPATCH_COUNTS["hail_read_sharded_waves"] += 1
    DISPATCH_COUNTS["hail_read_sharded_splits"] += len(splits)
    _obs_trace.instant("hail_read_sharded", track="kernels", cat="dispatch",
                       args={"splits": len(splits),
                             "blocks": sum(int(g[0].shape[0])
                                           for g in splits),
                             "axes": ",".join(axes)})
    lohi = np.asarray(lohi, np.int32).reshape(-1, 2)
    outs = []
    for (mins, keys, proj, bad, use_index), slot in zip(splits, slots):
        u = _host_flags(use_index)
        dev = slot.device
        with slot.run((mins, keys, proj, bad)):
            out = _read("hail_read_sharded", mins.to(dev), keys.to(dev),
                        proj.to(dev), bad.to(dev), u, lohi, partition_size)
        slot.hand_back(out)
        outs.append(out)
    return outs


def index_search(mins, lo, hi):
    """Root-directory lookup: mins (blocks, P) sorted -> (blocks, 2) int32
    [p_first, p_last], by the port's lower-bound rule."""
    DISPATCH_COUNTS["index_search"] += 1
    if not _USE_KERNELS:
        return ref.index_search(mins, lo, hi)
    if mins.is_cuda:
        TRACE_COUNTS["index_search"] += _build.note_variant("index_search",
                                                            None)
    return _search.index_search(mins, lo, hi)


def pax_scan(key_col, proj, lo, hi):
    """Single-block range scan -> (mask, masked proj, per-tile counts) from
    the kernel route, (mask, masked proj, 0-d total) under
    ``use_kernels(False)``: the JAX package's two contracts."""
    DISPATCH_COUNTS["pax_scan"] += 1
    if not _USE_KERNELS:
        return ref.pax_scan(key_col, proj, lo, hi)
    if key_col.is_cuda:
        TRACE_COUNTS["pax_scan"] += _build.note_variant("pax_scan", None)
    return _pax.pax_scan(key_col, proj, lo, hi)


def _tally(counts: collections.Counter, key: str, n: int = 1):
    """``counts[key] += n`` under a lock: the slots of a sharded step call
    the LM kernels from their threads at once."""
    with _COUNT_LOCK:
        counts[key] += n


def _wants_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


class AttentionFn(torch.autograd.Function):
    """Flash attention with its backward: forward kernel with log-sum-exp,
    backward kernel (plain versions of both on a CPU tensor).  The backward
    gets the forward's float32 output, not the one rounded to q's dtype:
    D = rowsum(dO * O) from a bfloat16 O moves dQ and dK past 2^-8 of
    their scale (4 bytes an output element kept until the backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap=None):
        out, lse, o32 = flash_attention.flash_attention_fwd(
            q, k, v, causal=causal, window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.causal, ctx.window, ctx.softcap = causal, window, softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention.flash_attention_bwd(
            q, k, v, o32, lse, dout.contiguous(), causal=ctx.causal,
            window=ctx.window, softcap=ctx.softcap)
        return dq, dk, dv, None, None, None


class SelectiveScanFn(torch.autograd.Function):
    """The Mamba1 scan with its backward kernel (plain versions of both on
    a CPU tensor); a gradient for ``h_final`` too, None read as zeros.  The
    forward is the training forward, which also keeps the states at the
    start of every 8 steps (``ckpt``, 4 B per (b, interval, d, n), held
    until the backward), so the backward kernel makes no forward sweep."""

    @staticmethod
    def forward(ctx, delta, x, b, c, a):
        y, h_final, ckpt = _scan.selective_scan_train(delta, x, b, c, a)
        ctx.save_for_backward(delta, x, b, c, a, ckpt)
        ctx.set_materialize_grads(False)   # an unused output's grad: None
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        delta, x, b, c, a, ckpt = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(delta)
        return _scan.selective_scan_bwd(
            delta, x, b, c, a, dy.contiguous(),
            None if dh_final is None else dh_final.contiguous(), ckpt)


def attention(q, k, v, *, causal=True, window=None, softcap=None):
    """Attention, q (B,T,H,D), k/v (B,S,KV,D) -> (B,T,H,D), the scores
    capped at ``softcap`` c tanh(s/c) where it is set: the flash kernel on
    a CUDA tensor, the plain version on a CPU tensor or under
    ``use_kernels(False)``; with grad, through ``AttentionFn``."""
    _tally(DISPATCH_COUNTS, "attention")
    if not _USE_KERNELS:
        return ref.attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if q.is_cuda:
        _tally(TRACE_COUNTS, "attention", _build.note_variant(
            "flash_attention", (q.dtype, q.shape[-1], causal, window,
                                softcap or None)))
    if _wants_grad(q, k, v):
        return AttentionFn.apply(q, k, v, causal, window, softcap)
    return flash_attention.flash_attention(q, k, v, causal=causal,
                                           window=window, softcap=softcap)


def selective_scan(delta, x, b, c, a):
    """Mamba1 recurrence from a zero state -> (y (B,T,D), h_final (B,D,N)):
    the fused kernel on a CUDA tensor, the plain version on a CPU tensor or
    under ``use_kernels(False)``; with grad, through ``SelectiveScanFn``."""
    _tally(DISPATCH_COUNTS, "selective_scan")
    if not _USE_KERNELS:
        return ref.selective_scan(delta, x, b, c, a)
    if delta.is_cuda:
        _tally(TRACE_COUNTS, "selective_scan", _build.note_variant(
            "selective_scan", a.shape[-1]))
    if _wants_grad(delta, x, b, c, a):
        return SelectiveScanFn.apply(delta, x, b, c, a)
    return _scan.selective_scan(delta, x, b, c, a)
