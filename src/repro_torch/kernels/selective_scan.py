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
