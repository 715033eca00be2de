"""Fused Mamba1 selective scan: the falcon-mamba prefill's recurrence, ONE
launch per layer.

The port of the JAX package's ``kernels/selective_scan.py``.  The CUDA
kernel (``csrc/selective_scan.cu``, function ``selective_scan_lanes``) runs
the time loop sequentially inside the thread, with each channel's N <= 16
states split over 1, 2 or 4 neighbouring lanes (4 at N = 16) and kept in
registers from a zero state to ``h_final``, each lane working on two
channels that share its reads of B_t and C_t; delta, x and the B_t, C_t rows
come through a 3-stage ``cp.async`` ring in shared memory, and y is summed
over the lanes by a shuffle butterfly and stored as coalesced rows.

``selective_scan`` routes by device: a CPU tensor takes the plain version
(``selective_scan_plain``, the ``ref.py`` counterpart), a CUDA tensor
launches the kernel or raises.

``selective_scan_bwd`` is the training path's backward, routed the same
way: ``csrc/selective_scan_bwd.cu`` on a CUDA tensor,
``ref.selective_scan_bwd`` on a CPU tensor.  The kernel splits states over
lanes as the forward does (two channels a lane, 128 channels a CTA): a
forward sweep checkpoints h every 16 steps, a reverse sweep recomputes each
8-step part's states and factors exp(delta A) into registers and runs it
backwards, summing over N and over the warp's channels with transposing
shuffle butterflies; a second kernel sums the per-CTA partials of dB, dC
and dA in a fixed order (deterministic, no atomics).  It counts as one
``selective_scan_bwd`` launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

MAX_STATE = 16                    # the kernel keeps N states in registers

selective_scan_plain = ref.selective_scan

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P] * 7 + [_I] * 4 + [_P]
_BWD_ARGTYPES = [_P] * 16 + [_I] * 4 + [_P]
_BWD_STEPS = 16                   # the checkpoint interval of the backward
_BWD_CHANNELS = 128               # channels a backward CTA owns


def _check(delta, x, b, c, a):
    dev = delta.device
    for name, t, ndim in (("delta", delta, 3), ("x", x, 3), ("b", b, 3),
                          ("c", c, 3), ("a", a, 2)):
        if t.device != dev:
            raise ValueError(f"selective_scan: {name} on {t.device}, delta "
                             f"on {dev}")
        if t.dtype != torch.float32 or t.dim() != ndim:
            raise ValueError(f"selective_scan: {name} must be {ndim}-d "
                             f"float32, got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"selective_scan: {name} must be contiguous")
    bs, t_len, d = delta.shape
    n = a.shape[1]
    if (x.shape != delta.shape or b.shape != (bs, t_len, n)
            or c.shape != b.shape or a.shape[0] != d):
        raise ValueError(f"selective_scan: inconsistent shapes delta "
                         f"{tuple(delta.shape)}, x {tuple(x.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, a "
                         f"{tuple(a.shape)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {n} not in "
                         f"1..{MAX_STATE}")


def _launch(delta, x, b, c, a):
    _check(delta, x, b, c, a)
    bs, t_len, d = delta.shape
    n = a.shape[1]
    y = torch.empty_like(delta)
    h_final = torch.zeros((bs, d, n), dtype=torch.float32,
                          device=delta.device)
    if bs == 0 or t_len == 0 or d == 0:
        return y, h_final
    fn = _build.entry("selective_scan_launch", _ARGTYPES)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        code = fn(delta.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                  a.data_ptr(), y.data_ptr(), h_final.data_ptr(), bs, t_len,
                  d, n, stream)
    _build.check("selective_scan", code)
    return y, h_final


def selective_scan(delta, x, b, c, a):
    """delta, x (B,T,D) float32; b, c (B,T,N) float32; a (D,N) float32
    (negative), all on one device -> y (B,T,D) float32, h_final (B,D,N)
    float32."""
    if delta.device.type == "cpu":
        return selective_scan_plain(delta, x, b, c, a)
    if delta.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device "
                         f"{delta.device}")
    return _launch(delta, x, b, c, a)


def _check_bwd(delta, x, b, c, a, dy, dh_final):
    _check(delta, x, b, c, a)
    bs, _, d = delta.shape
    n = a.shape[1]
    for name, g, shape in (("dy", dy, delta.shape),
                           ("dh_final", dh_final, (bs, d, n))):
        if g is None and name == "dh_final":
            continue
        if (g.shape != shape or g.dtype != torch.float32
                or g.device != delta.device or not g.is_contiguous()):
            raise ValueError(f"selective_scan_bwd: {name} must be contiguous "
                             f"float32 {tuple(shape)} on delta's device")


def _launch_bwd(delta, x, b, c, a, dy, dh_final):
    _check_bwd(delta, x, b, c, a, dy, dh_final)
    bs, t_len, d = delta.shape
    n = a.shape[1]
    ddelta, dx, db, dc = (torch.empty_like(v) for v in (delta, x, b, c))
    da = torch.empty_like(a)
    if bs == 0 or t_len == 0 or d == 0:
        for g in (ddelta, dx, db, dc, da):
            g.zero_()
        return ddelta, dx, db, dc, da
    chunks = -(-t_len // _BWD_STEPS)
    n_cb = -(-d // _BWD_CHANNELS)
    f32 = dict(dtype=torch.float32, device=delta.device)
    ckpt = torch.empty((bs, chunks, d, n), **f32)
    part_b = torch.empty((bs, n_cb, t_len, n), **f32)
    part_c = torch.empty_like(part_b)
    part_a = torch.empty((bs, d, n), **f32)
    fn = _build.entry("selective_scan_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        code = fn(delta.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                  a.data_ptr(), dy.data_ptr(),
                  None if dh_final is None else dh_final.data_ptr(),
                  *(g.data_ptr() for g in (ddelta, dx, db, dc, da, ckpt,
                                           part_b, part_c, part_a)),
                  bs, t_len, d, n, stream)
    _build.check("selective_scan_bwd", code)
    return ddelta, dx, db, dc, da


def selective_scan_bwd(delta, x, b, c, a, dy, dh_final=None):
    """The backward of ``selective_scan`` from its inputs and the upstream
    gradients of y (B,T,D) and h_final (B,D,N; None reads as zeros) ->
    (ddelta, dx, db, dc, da), float32."""
    if delta.device.type == "cpu":
        return ref.selective_scan_bwd(delta, x, b, c, a, dy, dh_final)
    if delta.device.type != "cuda":
        raise ValueError(f"selective_scan: no kernel for device "
                         f"{delta.device}")
    return _launch_bwd(delta, x, b, c, a, dy, dh_final)
