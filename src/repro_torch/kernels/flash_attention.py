"""Flash attention (forward): the LM prefill's attention, ONE launch per
layer.

The port of the JAX package's ``kernels/flash_attention.py``.  The CUDA
sources (``csrc/flash_attention.cu``, the entry points; ``csrc/
flash_fwd.cuh``, the kernels, built a head dim a file) keep the JAX layout
— q (B,T,H,D), k/v (B,S,KV,D), no transposes outside the kernel — with one
CTA per (batch x head, q tile) looping over kv tiles, an online float32
softmax, causal and window masks by index and GQA by index (q head h reads
kv head h // (H/KV)).  It takes float32 or bfloat16, any T and S, head
dims 16, 32, 64, 80, 128 and 256, and an optional softcap c (gemma3's
scores capped at c tanh(s/c) before the mask; a runtime argument, 0 when
off).  bfloat16 runs on the tensor cores (``wgmma`` fed by TMA loads,
warp-specialised, 128-row q tiles; P rounded to bfloat16 before P·V, the
only rounding beyond the reference's); float32 runs on the CUDA cores in
full float32.

``flash_attention`` routes by device: a CPU tensor takes the plain version
(``flash_attention_plain``, the ``ref.py`` counterpart), a CUDA tensor
launches the kernel or raises.

The training path (``ops.attention`` with grad) uses the two entries
beside it, routed the same way: ``flash_attention_fwd`` is the same kernel
also writing each row's log-sum-exp and, for bfloat16, the float32
output before its rounding (``flash_attention_lse_launch``; plain version
``ref.attention_lse``), and ``flash_attention_bwd`` is the backward
(``csrc/flash_attention_bwd.cu``: a dot kernel for D = rowsum(dO * O), a
dK/dV kernel and a dQ kernel, deterministic, no atomics; plain version
``ref.attention_bwd``; the kernels in ``csrc/flash_bwd.cuh``, built a
head dim a file).  The backward reads O in q's dtype or in float32; the
training path hands it the float32 O, since D from the bfloat16 O moves
dQ and dK past the 2^-8 tolerance.  bfloat16 runs on the tensor cores as
the forward does (``wgmma`` fed by TMA loads, warp-specialised): the
dK/dV kernel loads a 64-key tile's K and V once and its two consumer
warpgroups take every other tile of the walk over the group's q heads
and the band's q tiles (S^T, P^T, dV += P^T dO, dP^T, dS^T, dK += dS^T
Q), adding their partial sums in a fixed order at the end; the dQ kernel
loads a 128-row tile's Q and dO once and walks the band's key tiles (S,
dP, dS, dQ += dS K).  P and dS enter their products as two bfloat16 terms
each (hi and the rest), the scale applied in float32 at the store.  At
head dim 256 the dK/dV kernel runs as two launches, a dV pass and a dK
pass (each accumulator alone fills a thread's registers); a softcap is
recomputed in the backward, dS taking its derivative.  No atomics: a
second call gives the same bits.  float32 runs on the CUDA cores in full
float32.  The forward counts as a
``flash_attention`` launch, the backward as one ``flash_attention_bwd``
launch, each also under its ``launch_key`` in ``_build.SHAPE_LAUNCHES``.

A ``meta`` tensor takes the meta route: ``torch.empty`` outputs of exactly
the CUDA route's shapes and dtypes (lse and the float32 O included), after
the CUDA route's checks, for the dry-run's cost trace
(``launch/cost_analysis.py``).  Under that trace each wrapper notes its
launch's work on any device by ``fwd_work`` / ``bwd_work``, the formulas of
``chip_smoke.py``'s bounds, and the trace counts nothing inside it.  Any
other device raises.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the kernels' compiled head dims

flash_attention_plain = ref.attention

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = [_P] * 4 + [_I] * 9 + [_F, _F, _P]
_LSE_ARGTYPES = [_P] * 6 + [_I] * 9 + [_F, _F, _P]
_BWD_ARGTYPES = [_P] * 10 + [_I] * 10 + [_F, _F, _P]


def _check(q, k, v, window, softcap=None):
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{dev}")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16):
            raise ValueError(f"flash_attention: q, k, v must all be float32 "
                             f"or all bfloat16, got {q.dtype}/{k.dtype}/"
                             f"{v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be 4-d, got "
                             f"{t.dim()}-d")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, _, h, d = q.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d
            or k.shape[2] < 1 or h % k.shape[2] != 0 or k.shape[1] < 1):
        raise ValueError(f"flash_attention: inconsistent shapes q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if softcap is not None and not softcap >= 0:
        raise ValueError(f"flash_attention: softcap must be >= 0 (0 or "
                         f"None: off), got {softcap}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 q, k, v must start on "
                         "16-byte boundaries (the kernel copies 16-byte "
                         "chunks)")


def launch_key(what: str, q, k, causal: bool, window, softcap=None) -> str:
    """The key a launch is counted under in ``_build.SHAPE_LAUNCHES``:
    ``what`` ("fwd", "fwd+lse" or "bwd from <O's dtype> O"), q's and k's
    shapes, the dtype, the mask and the softcap where it is set."""
    return (f"{what} q {tuple(q.shape)} k/v {tuple(k.shape)} "
            f"{str(q.dtype)[6:]} {'causal' if causal else 'non-causal'}"
            + ("" if window is None else f" window {window}")
            + (f" softcap {softcap}" if softcap else ""))


def unmasked_pairs(t: int, s: int, causal: bool, window) -> int:
    """(query, key) pairs the masks keep over queries i < t and keys
    j < s: j <= i where ``causal``, j > i - window where ``window`` is
    set (the kernels' masks by index)."""
    i = np.arange(t, dtype=np.int64)
    hi = np.minimum(i, s - 1) if causal else np.full(t, s - 1, np.int64)
    lo = (np.maximum(i - window + 1, 0) if window is not None
          else np.zeros(t, np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def fwd_work(q, k, causal: bool, window, *, with_lse: bool = False
             ) -> tuple[int, int]:
    """(bytes, flops) of one forward launch: q, k and v read once and the
    output written once (with ``with_lse`` also each row's lse and, for
    bfloat16 inputs, the float32 output, 4 bytes each), against 4 flops
    (QK^T and PV, a multiply and an add each) per head dim and unmasked
    (query, key) pair."""
    b, t, h, d = q.shape
    n_bytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    if with_lse:
        n_bytes += 4 * b * h * t
        if q.dtype == torch.bfloat16:
            n_bytes += 4 * q.numel()
    return n_bytes, 4 * b * h * d * unmasked_pairs(t, k.shape[1], causal,
                                                   window)


def bwd_work(q, k, causal: bool, window, o_itemsize: int = 4
             ) -> tuple[int, int]:
    """(bytes, flops) of one backward launch: q, k, v and dO read once, O
    read once (``o_itemsize`` bytes an element: the training path hands
    over the float32 O), lse and D (float32 a row and head) read once, dq,
    dk and dv written once, against 10 flops (QK^T, dO V^T, P^T dO, dS^T Q,
    dS K: a multiply and an add each) per head dim and unmasked pair."""
    b, t, h, d = q.shape
    n_bytes = ((3 * q.numel() + 4 * k.numel()) * q.element_size()
               + o_itemsize * q.numel() + 2 * 4 * b * h * t)
    return n_bytes, 10 * b * h * d * unmasked_pairs(t, k.shape[1], causal,
                                                    window)


def _as_cost(work) -> tuple[int, int, int]:
    """(bytes, flops) of a flash launch -> (flops, dot flops, bytes):
    every flop of the kernel is a product's."""
    n_bytes, flops = work
    return flops, flops, n_bytes


def _meta(q, k, v, o=None, lse=None, do=None, *, window, softcap,
          with_lse: bool = False, bwd: bool = False):
    """The meta route: the CUDA route's checks, then empty outputs of its
    shapes and dtypes."""
    if bwd:
        _check_bwd(q, k, v, o, lse, do, window, softcap)
        return tuple(torch.empty_like(x) for x in (q, k, v))
    _check(q, k, v, window, softcap)
    out = torch.empty_like(q)
    if not with_lse:
        return out
    b, t, h, _ = q.shape
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    o32 = out if q.dtype == torch.float32 else torch.empty(
        q.shape, dtype=torch.float32, device=q.device)
    return out, lse, o32


def _launch(q, k, v, causal: bool, window, softcap,
            with_lse: bool = False):
    """-> out, or (out, lse, out in float32) with ``with_lse``."""
    _check(q, k, v, window, softcap)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = o32 = None
    if with_lse:
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        o32 = out if q.dtype == torch.float32 else torch.empty(
            q.shape, dtype=torch.float32, device=q.device)
    if b == 0 or t == 0:
        return (out, lse, o32) if with_lse else out
    tail = (b, t, s, h, kvh, d, int(causal),
            -1 if window is None else int(window),
            int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(d),
            float(softcap or 0.0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if with_lse:
            fn = _build.entry("flash_attention_lse_launch", _LSE_ARGTYPES)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), o32.data_ptr(), lse.data_ptr(), *tail,
                      stream)
        else:
            fn = _build.entry("flash_attention_launch", _ARGTYPES)
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), *tail, stream)
    _build.check("flash_attention", code, launch_key(
        "fwd+lse" if with_lse else "fwd", q, k, causal, window, softcap))
    return (out, lse, o32) if with_lse else out


def _check_bwd(q, k, v, o, lse, do, window, softcap=None):
    _check(q, k, v, window, softcap)
    b, t, h, _ = q.shape
    for name, x, dtypes in (("o", o, (q.dtype, torch.float32)),
                            ("do", do, (q.dtype,))):
        if (x.shape != q.shape or x.dtype not in dtypes
                or x.device != q.device or not x.is_contiguous()):
            raise ValueError(f"flash_attention_bwd: {name} must be "
                             f"contiguous, of q's shape and device, and of "
                             f"dtype {' or '.join(map(str, dtypes))}")
        if q.dtype == torch.bfloat16 and x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must start on a "
                             f"16-byte boundary")
    if (lse.shape != (b, h, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be contiguous "
                         f"float32 {(b, h, t)} on q's device")


def _launch_bwd(q, k, v, o, lse, do, causal: bool, window, softcap):
    _check_bwd(q, k, v, o, lse, do, window, softcap)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if b == 0 or t == 0:
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.entry("flash_attention_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(*(x.data_ptr() for x in (q, k, v, o, lse, do, dq, dk, dv,
                                            dsum)),
                  b, t, s, h, kvh, d, int(causal),
                  -1 if window is None else int(window),
                  int(q.dtype == torch.bfloat16),
                  int(o.dtype == torch.float32), 1.0 / math.sqrt(d),
                  float(softcap or 0.0), stream)
    _build.check("flash_attention_bwd", code, launch_key(
        f"bwd from {str(o.dtype)[6:]} O", q, k, causal, window, softcap))
    return dq, dk, dv


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    softcap=None):
    """q (B,T,H,D), k/v (B,S,KV,D) on one device, H a multiple of KV
    -> (B,T,H,D) in q's dtype; ``softcap`` None or 0 leaves the scores
    uncapped."""
    def run():
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, causal=causal,
                                         window=window, softcap=softcap)
        if q.device.type == "meta":
            return _meta(q, k, v, window=window, softcap=softcap)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: no kernel for device "
                             f"{q.device}")
        return _launch(q, k, v, causal, window, softcap)
    return _build.noted("flash_attention", lambda: _as_cost(fwd_work(
        q, k, causal, window)), run, (q, k, v))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window=None,
                        softcap=None):
    """The training forward: ``flash_attention``, each row's log-sum-exp
    of the masked scaled scores and the output before its rounding to q's
    dtype -> (out (B,T,H,D) in q's dtype, lse (B,H,T) float32, -1e30 for
    a row with no key in its band; o32 (B,T,H,D) float32, ``out`` itself
    for float32 inputs): o32 is what the backward's D = rowsum(dO * O)
    reads."""
    def run():
        if q.device.type == "cpu":
            return ref.attention_lse(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
        if q.device.type == "meta":
            return _meta(q, k, v, window=window, softcap=softcap,
                         with_lse=True)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: no kernel for device "
                             f"{q.device}")
        return _launch(q, k, v, causal, window, softcap, with_lse=True)
    return _build.noted("flash_attention", lambda: _as_cost(fwd_work(
        q, k, causal, window, with_lse=True)), run, (q, k, v))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window=None, softcap=None):
    """The backward from ``flash_attention_fwd``'s output ``o`` (in q's
    dtype or in float32) and lse and the upstream gradient ``do``
    (contiguous, q's shape and dtype) -> (dq, dk, dv) in the inputs'
    dtype."""
    def run():
        if q.device.type == "cpu":
            return ref.attention_bwd(q, k, v, o, lse, do, causal=causal,
                                     window=window, softcap=softcap)
        if q.device.type == "meta":
            return _meta(q, k, v, o, lse, do, window=window,
                         softcap=softcap, bwd=True)
        if q.device.type != "cuda":
            raise ValueError(f"flash_attention: no kernel for device "
                             f"{q.device}")
        return _launch_bwd(q, k, v, o, lse, do, causal, window, softcap)
    return _build.noted("flash_attention_bwd", lambda: _as_cost(bwd_work(
        q, k, causal, window, o.element_size())), run, (q, k, v, do))
