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

``selective_scan_train`` is the training path's forward: the same kernel
(``selective_scan_ckpt_launch``), which also writes h at the start of
every ``CKPT_STEPS`` steps into ``ckpt`` (B, ceil(T/8), D, N);
``ops.SelectiveScanFn`` keeps it for the backward (4 B per (b, interval,
d, n)).  The prefill (no grad) keeps the launch without it.

``selective_scan_bwd`` is the training path's backward, routed the same
way: ``csrc/selective_scan_bwd.cu`` on a CUDA tensor, from the training
forward's checkpoints (it makes no forward sweep of its own),
``ref.selective_scan_bwd`` on a CPU tensor.  The kernel splits states over
lanes as the forward does (two channels a lane, 128 channels a CTA) and
walks the 8-step intervals once, from the last: one producer thread feeds
delta, x, dy, the B_t and C_t rows and the checkpoint through TMA into a
ring of intervals; the compute warps recompute each interval's states and
factors exp(delta A) once into registers, run it backwards and sum over N
and over the warp's channels with transposing shuffle butterflies; a
second kernel sums the per-CTA partials of dB, dC and dA in a fixed order
(deterministic, no atomics).  It counts as one ``selective_scan_bwd``
launch.

A ``meta`` tensor takes the meta route: the CUDA route's checks, then
``torch.empty`` outputs of its shapes and dtypes, for the dry-run's cost
trace (``launch/cost_analysis.py``).  Under that trace each wrapper notes
its launch's work on any device by ``fwd_work`` / ``train_work`` /
``bwd_work``, the
formulas of ``chip_smoke.py``'s bounds, and the trace counts nothing
inside it.  Any other device raises.
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
_CKPT_ARGTYPES = [_P] * 8 + [_I] * 4 + [_P]
_BWD_ARGTYPES = [_P] * 16 + [_I] * 4 + [_P]
CKPT_STEPS = 8                    # the training forward's checkpoint interval
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


def fwd_work(delta, b) -> tuple[int, int]:
    """(bytes, flops) of one forward launch: delta and x read and y
    written (4 B each per (b, t, d)), b and c read, a read and h_final
    written; 7 float32 operations per (b, t, d, n): delta*a, exp, *h,
    (delta x)*B, +, and the multiply-add into y."""
    bs, t, d = delta.shape
    n = b.shape[-1]
    return (4 * (3 * bs * t * d + 2 * bs * t * n + d * n + bs * d * n),
            7 * bs * t * d * n)


def train_work(delta, b) -> tuple[int, int]:
    """(bytes, flops) of one training-forward launch: ``fwd_work`` and the
    checkpoints it writes, h at the start of every ``CKPT_STEPS`` steps
    (4 B per (b, interval, d, n))."""
    bs, t, d = delta.shape
    n = b.shape[-1]
    n_bytes, flops = fwd_work(delta, b)
    return n_bytes + 4 * bs * -(-t // CKPT_STEPS) * d * n, flops


def bwd_work(delta, b, with_dh: bool) -> tuple[int, int]:
    """(bytes, flops) of one backward launch: delta, x, dy read and ddelta,
    dx written (4 B each per (b, t, d)), b, c read and db, dc written, a
    read and da written, dh_final read if given; about 12 float32
    operations per (b, t, d, n) (the two recurrences and the five
    gradient terms)."""
    bs, t, d = delta.shape
    n = b.shape[-1]
    return (4 * (5 * bs * t * d + 4 * bs * t * n + 2 * d * n
                 + (bs * d * n if with_dh else 0)),
            12 * bs * t * d * n)


def _as_cost(work) -> tuple[int, int, int]:
    """(bytes, flops) of a scan launch -> (flops, dot flops, bytes): the
    scan makes no product."""
    n_bytes, flops = work
    return flops, 0, n_bytes


def _ckpt_shape(delta, a) -> tuple[int, int, int, int]:
    bs, t_len, d = delta.shape
    return bs, -(-t_len // CKPT_STEPS), d, a.shape[1]


def _launch(delta, x, b, c, a, train: bool = False):
    """The prefill's launch -> (y, h_final); ``train``: the training
    forward's -> (y, h_final, ckpt)."""
    _check(delta, x, b, c, a)
    bs, t_len, d = delta.shape
    n = a.shape[1]
    y = torch.empty_like(delta)
    h_final = torch.zeros((bs, d, n), dtype=torch.float32,
                          device=delta.device)
    ckpt = torch.empty(_ckpt_shape(delta, a), dtype=torch.float32,
                       device=delta.device) if train else None
    if bs == 0 or t_len == 0 or d == 0:
        return (y, h_final, ckpt.zero_()) if train else (y, h_final)
    ptrs = [t.data_ptr() for t in (delta, x, b, c, a, y, h_final)]
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        if train:
            fn = _build.entry("selective_scan_ckpt_launch", _CKPT_ARGTYPES)
            code = fn(*ptrs, ckpt.data_ptr(), bs, t_len, d, n, stream)
        else:
            fn = _build.entry("selective_scan_launch", _ARGTYPES)
            code = fn(*ptrs, bs, t_len, d, n, stream)
    if train:
        _build.check("selective_scan_train", code)
        return y, h_final, ckpt
    _build.check("selective_scan", code, launch_key(delta, a))
    return y, h_final


def launch_key(delta, a) -> str:
    """The key a prefill launch is counted under in
    ``_build.SHAPE_LAUNCHES``: delta's shape and the state count."""
    return f"delta/x {tuple(delta.shape)} n {a.shape[1]}"


def selective_scan(delta, x, b, c, a):
    """delta, x (B,T,D) float32; b, c (B,T,N) float32; a (D,N) float32
    (negative), all on one device -> y (B,T,D) float32, h_final (B,D,N)
    float32."""
    def run():
        if delta.device.type == "cpu":
            return selective_scan_plain(delta, x, b, c, a)
        if delta.device.type == "meta":
            _check(delta, x, b, c, a)
            return torch.empty_like(delta), torch.empty(
                (delta.shape[0], delta.shape[2], a.shape[1]),
                dtype=torch.float32, device=delta.device)
        if delta.device.type != "cuda":
            raise ValueError(f"selective_scan: no kernel for device "
                             f"{delta.device}")
        return _launch(delta, x, b, c, a)
    return _build.noted("selective_scan",
                        lambda: _as_cost(fwd_work(delta, b)), run,
                        (delta, x, b, c))


def selective_scan_train(delta, x, b, c, a):
    """The training forward: ``selective_scan`` that also returns its
    states at the start of every ``CKPT_STEPS`` steps, ckpt
    (B, ceil(T/CKPT_STEPS), D, N) float32 (the first the zero state), which
    ``selective_scan_bwd`` starts its intervals from -> (y, h_final,
    ckpt)."""
    def run():
        if delta.device.type == "cpu":
            y, h_final = selective_scan_plain(delta, x, b, c, a)
            return y, h_final, ref.selective_scan_states(delta, x, b, c, a,
                                                         CKPT_STEPS)
        if delta.device.type == "meta":
            _check(delta, x, b, c, a)
            return (torch.empty_like(delta), torch.empty(
                (delta.shape[0], delta.shape[2], a.shape[1]),
                dtype=torch.float32, device=delta.device),
                torch.empty(_ckpt_shape(delta, a), dtype=torch.float32,
                            device=delta.device))
        if delta.device.type != "cuda":
            raise ValueError(f"selective_scan: no kernel for device "
                             f"{delta.device}")
        return _launch(delta, x, b, c, a, train=True)
    return _build.noted("selective_scan_train",
                        lambda: _as_cost(train_work(delta, b)), run,
                        (delta, x, b, c))


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


def _check_ckpt(delta, a, ckpt):
    shape = _ckpt_shape(delta, a)
    if ckpt is None:
        raise ValueError("selective_scan_bwd: the kernel starts from the "
                         "training forward's checkpoints (ckpt): "
                         "selective_scan_train gives them")
    if (tuple(ckpt.shape) != shape or ckpt.dtype != torch.float32
            or ckpt.device != delta.device or not ckpt.is_contiguous()):
        raise ValueError(f"selective_scan_bwd: ckpt must be contiguous "
                         f"float32 {shape} on delta's device")


def _launch_bwd(delta, x, b, c, a, dy, dh_final, ckpt):
    _check_bwd(delta, x, b, c, a, dy, dh_final)
    _check_ckpt(delta, a, ckpt)
    bs, t_len, d = delta.shape
    n = a.shape[1]
    ddelta, dx, db, dc = (torch.empty_like(v) for v in (delta, x, b, c))
    da = torch.empty_like(a)
    if bs == 0 or t_len == 0 or d == 0:
        for g in (ddelta, dx, db, dc, da):
            g.zero_()
        return ddelta, dx, db, dc, da
    n_cb = -(-d // _BWD_CHANNELS)
    f32 = dict(dtype=torch.float32, device=delta.device)
    part_b = torch.empty((bs, n_cb, t_len, n), **f32)
    part_c = torch.empty_like(part_b)
    part_a = torch.empty((bs, d, n), **f32)
    fn = _build.entry("selective_scan_bwd_launch", _BWD_ARGTYPES)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream(delta.device).cuda_stream
        code = fn(delta.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                  a.data_ptr(), ckpt.data_ptr(), dy.data_ptr(),
                  None if dh_final is None else dh_final.data_ptr(),
                  *(g.data_ptr() for g in (ddelta, dx, db, dc, da, part_b,
                                           part_c, part_a)),
                  bs, t_len, d, n, stream)
    _build.check("selective_scan_bwd", code)
    return ddelta, dx, db, dc, da


def selective_scan_bwd(delta, x, b, c, a, dy, dh_final=None, ckpt=None):
    """The backward of ``selective_scan`` from its inputs and the upstream
    gradients of y (B,T,D) and h_final (B,D,N; None reads as zeros) ->
    (ddelta, dx, db, dc, da), float32.  ``ckpt``: the training forward's
    checkpoints (``selective_scan_train``), which the kernel starts its
    intervals from (it makes no forward sweep of its own); the plain
    version recomputes the states and does not read them."""
    def run():
        if delta.device.type == "cpu":
            if ckpt is not None:
                _check_ckpt(delta, a, ckpt)
            return ref.selective_scan_bwd(delta, x, b, c, a, dy, dh_final)
        if delta.device.type == "meta":
            _check_bwd(delta, x, b, c, a, dy, dh_final)
            if ckpt is not None:
                _check_ckpt(delta, a, ckpt)
            return tuple(torch.empty_like(v) for v in (delta, x, b, c, a))
        if delta.device.type != "cuda":
            raise ValueError(f"selective_scan: no kernel for device "
                             f"{delta.device}")
        return _launch_bwd(delta, x, b, c, a, dy, dh_final, ckpt)
    return _build.noted("selective_scan_bwd", lambda: _as_cost(bwd_work(
        delta, b, dh_final is not None)), run, (delta, x, b, c, dy))
