"""Device meshes: the multi-device wave dispatch's, and the dry-run's
production meshes.

The counterpart of the JAX package's ``launch/mesh.py`` (``make_mesh``,
``make_host_mesh``, ``make_production_mesh``, ``HW``).  A ``DeviceMesh``
has what the axis rules read of a ``jax.sharding.Mesh`` — ``axis_names`` and ``devices``, a numpy object
array of ``torch.device`` shaped like the mesh — and one thing more: each
position of the mesh is a *slot*, a (device, stream) pair, and the mesh
owns one ``torch.cuda.Stream`` per CUDA slot.

That is the port's one deliberate difference from a jax mesh: a device may
appear more than once.  Four slots over ``cuda:0`` are four streams on one
card, so the wave path runs with n_dev > 1 where there is one card, and
four ``"cpu"`` slots let the CPU tests run it with n_dev > 1 (a CPU slot
takes the kernels' plain versions).  The production meshes of the
dry-run (``launch/dryrun.py``) are the ``meta`` device repeated 256 or 512
times: their slots have no stream, and nothing placed on them is
allocated.

**SPMD in one process** (``DeviceMesh.run_spmd``): one thread a slot runs
the same function on the slot's own shards, with the slot's device and
stream current and the caller's grad mode.  The slots take turns between
collectives (a token passed round them in slot order), so one slot
thread at a time runs Python and the slots' work reaches their streams
in a fixed order.  The slots meet at collectives over named mesh axes
(``all_to_all``, ``all_gather``, ``all_reduce``).  A collective is
written in torch: the receiving slot reads each peer's tensor in place
where the two share a device (its stream first waits on an event the
sender's stream recorded), or copies it across where they do not (on the
sender's card, after the same event), and sums and maxima run in the
fixed order of the group, so every member gets the same bits and two
calls give the same bits.  No library of collectives is used: NCCL wants
one process a card, and cannot put two ranks on one card, which is what
a mesh of four streams on one card is.  A slot that raises stops the
others at their next turn, and ``run_spmd`` raises the first slot's
exception; a slot that leaves without reaching a collective the others
reach, or a turn that does not come within the timeout, fails the call
too.  ``collective_counts`` reads the collectives run and the bytes they
moved between slots, by kind and axes.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import math
import threading
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch


class Slot(NamedTuple):
    """One position of a mesh: a device and, for a CUDA device, the
    mesh's own stream for that position (None on the CPU)."""
    device: torch.device
    stream: Optional[torch.cuda.Stream]

    @contextlib.contextmanager
    def run(self, inputs: Sequence[torch.Tensor] = ()):
        """Make the slot's device and stream current for the body.

        The stream first waits for everything queued so far on its device's
        current stream (where ``inputs`` were made), and each input on that
        device is marked as used by the stream, so the caching allocator
        does not hand its memory out while the slot's work still reads
        it."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in inputs:
            if t.device == self.device:
                t.record_stream(self.stream)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def hand_back(self, outputs: Sequence[torch.Tensor]):
        """Mark tensors made on the slot's stream as used by its device's
        current stream, which reads them once the slot's work is done (the
        reader waits on an event first), so their memory is not reused
        under that stream's reads."""
        if self.stream is None:
            return
        caller = torch.cuda.current_stream(self.device)
        for t in outputs:
            t.record_stream(caller)

    def join(self, outputs: Sequence[torch.Tensor]):
        """Order the device's current stream after the slot's work, and
        hand ``outputs`` back to it."""
        if self.stream is None:
            return
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        self.hand_back(outputs)


class DeviceMesh:
    """``axis_names`` and ``devices`` (numpy object array of
    ``torch.device``) as a jax mesh has them, plus one slot per position."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} with axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names
        streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                   for d in devices.reshape(-1)]
        self._slots = np.empty(devices.shape, dtype=object)
        for i, (d, s) in enumerate(zip(devices.reshape(-1), streams)):
            self._slots.reshape(-1)[i] = Slot(d, s)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def slots(self, axes: Sequence[str]) -> list[Slot]:
        """The slots a dimension sharded over ``axes`` lands on, in shard
        order (the first axis major), each at index 0 of the other axes —
        where a jax ``PartitionSpec(axes)`` puts its tiles."""
        order = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in order]
        grid = self._slots.transpose(order + rest)
        n = math.prod(self.devices.shape[i] for i in order)
        return list(grid.reshape(n, -1)[:, 0])

    def slot_at(self, pos: tuple) -> Slot:
        """The slot at mesh position ``pos`` (one index an axis)."""
        return self._slots[pos]

    def run_spmd(self, fn: Callable[[dict], Any]) -> np.ndarray:
        """``fn(coords)`` on every slot at once, one thread a slot, where
        ``coords`` maps each axis name to the slot's index on it; returns
        the results in an object array shaped like the mesh.

        Each thread takes the caller's grad mode and enters ``Slot.run``
        (the slot's device and stream, its stream after the caller's
        work), so collectives (``all_to_all``, ``all_gather``,
        ``all_reduce``) may be called inside ``fn``; the slots take turns
        between them (``_Run``).  Afterwards the caller's stream on each
        device waits for the slots' streams, and the tensors of the
        results are handed back to it.  A slot's exception fails the whole
        call: the other slots stop at their next turn, and the first
        exception raised by a slot (in slot order) is raised here; a turn
        that does not come within ``SPMD_TIMEOUT_S`` seconds fails it
        too."""
        kinds = {d.type for d in self.devices.reshape(-1)}
        if len(kinds) != 1 or kinds & {"meta"}:
            raise ValueError(f"run_spmd: a mesh of one device type other "
                             f"than meta, got {sorted(kinds)}")
        run = _Run(self, SPMD_TIMEOUT_S)
        n = self.devices.size
        results = np.empty(self.devices.shape, dtype=object)
        errors: list = [None] * n
        grad = torch.is_grad_enabled()

        def body(i: int):
            pos = np.unravel_index(i, self.devices.shape)
            pos = tuple(int(p) for p in pos)
            _SPMD.state = (run, pos)
            try:
                run.wait_turn(i)
                with torch.set_grad_enabled(grad), self._slots[pos].run():
                    results[pos] = fn(dict(zip(self.axis_names, pos)))
            except BaseException as e:   # noqa: BLE001 - re-raised below
                errors[i] = e
                run.abort()
            finally:
                run.finish(i)
                _SPMD.state = None

        threads = [threading.Thread(target=body, args=(i,),
                                    name=f"spmd-slot-{i}", daemon=True)
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(run.timeout + 60.0)
        if any(t.is_alive() for t in threads):
            run.abort()
            raise TimeoutError(f"run_spmd: a slot of {self} did not finish")
        first = next((e for e in errors if e is not None
                      and not isinstance(e, SpmdAbort)), None)
        if first is None:
            first = next((e for e in errors if e is not None), None)
        if first is not None:
            raise first
        for pos in np.ndindex(self.devices.shape):
            self._slots[pos].join(_tensors(results[pos]))
        return results

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


# ---------------------------------------------------------------------------
# SPMD: the slots' rendezvous and the collectives
# ---------------------------------------------------------------------------

SPMD_TIMEOUT_S = 600.0    # the longest a slot waits for its turn

_SPMD = threading.local()
_COUNT_LOCK = threading.Lock()
COLLECTIVE_CALLS: collections.Counter = collections.Counter()
COLLECTIVE_BYTES: collections.Counter = collections.Counter()


class SpmdAbort(RuntimeError):
    """A slot stopped at a collective because another slot failed or left
    without reaching it, or because it waited past the timeout."""


class _Run:
    """One ``run_spmd`` call.  The slots take turns: a token goes round
    them in slot order, and only the slot that holds it runs, from one
    collective to the next, so one slot thread at a time runs Python (with
    every slot thread runnable, each operation's release of the
    interpreter lock hands it to another thread: a thread switch an
    operation).  At a collective a slot posts what it sends on a board and
    passes the token on; when the token comes back, every other slot has
    posted the same collective, and it reads.  Two boards are used in
    turns: a slot is at most one collective ahead of another, so a board
    is not written while it is read."""

    def __init__(self, mesh: DeviceMesh, timeout: float):
        self.mesh = mesh
        self.n = mesh.devices.size
        self.timeout = timeout
        self.lock = threading.Lock()
        self.token = [threading.Semaphore(0) for _ in range(self.n)]
        self.token[0].release()            # slot 0 starts
        self.done = [False] * self.n
        self.failed = False
        self.boards: tuple[dict, dict] = ({}, {})
        self.calls: dict[tuple, int] = collections.Counter()

    def wait_turn(self, i: int):
        got = self.token[i].acquire(timeout=self.timeout)
        if self.failed:
            raise SpmdAbort("a slot stopped: another slot failed")
        if not got:
            self.abort()
            raise SpmdAbort(f"a slot waited {self.timeout} s for its turn "
                            f"at a collective")

    def pass_turn(self, i: int):
        """Give the token to the next slot after ``i`` still running."""
        with self.lock:
            nxt = ((i + k) % self.n for k in range(1, self.n + 1))
            j = next((j for j in nxt if not self.done[j]), None)
        if j is not None:
            self.token[j].release()

    def finish(self, i: int):
        """Slot ``i`` is done: the token, which it holds unless the call
        failed, goes on."""
        with self.lock:
            self.done[i] = True
        if not self.failed:
            self.pass_turn(i)

    def abort(self):
        self.failed = True
        for t in self.token:
            t.release()


def _tensors(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _state() -> tuple:
    state = getattr(_SPMD, "state", None)
    if state is None:
        raise RuntimeError("a collective outside DeviceMesh.run_spmd")
    return state


def spmd_coords() -> Optional[dict]:
    """The calling slot's {axis: index}, None outside ``run_spmd``."""
    state = getattr(_SPMD, "state", None)
    if state is None:
        return None
    run, pos = state
    return dict(zip(run.mesh.axis_names, pos))


def spmd_mesh() -> Optional[DeviceMesh]:
    """The mesh of the ``run_spmd`` call the calling thread is a slot of,
    None outside one."""
    state = getattr(_SPMD, "state", None)
    return None if state is None else state[0].mesh


@functools.lru_cache(maxsize=1 << 12)
def group_positions(pos: tuple, axes: tuple, names: tuple,
                    shape: tuple) -> tuple:
    """The positions of a mesh (its axis names and shape) that share
    ``pos``'s indices on every axis but ``axes``, in the order of a
    dimension split over ``axes`` (the first axis major)."""
    idx = [names.index(a) for a in axes]
    out = []
    for k in np.ndindex(*[shape[i] for i in idx]):
        p = list(pos)
        for i, v in zip(idx, k):
            p[i] = int(v)
        out.append(tuple(p))
    return tuple(out)


def _fetch(t: torch.Tensor, event, dst: Slot) -> torch.Tensor:
    """A peer's tensor, readable on ``dst``'s stream."""
    if t.device.type != "cuda":
        return t
    if t.device == dst.device:
        cur = torch.cuda.current_stream(dst.device)
        if event is not None:
            cur.wait_event(event)
        t.record_stream(cur)
        return t
    # another card: copy on this thread's stream of the sender's card,
    # after the sender's event; the copy orders the receiver's stream
    with torch.cuda.device(t.device):
        src_stream = torch.cuda.current_stream(t.device)
        if event is not None:
            src_stream.wait_event(event)
        out = t.to(dst.device, non_blocking=True)
        t.record_stream(src_stream)
    return out


def _exchange(kind: str, send: list, axes: Sequence[str]) -> list:
    """The core of every collective: this slot sends ``send[j]`` (a
    tensor, or a tuple of tensors) to the j-th member of its group over
    ``axes`` and gets what each member sent it, in group order.  A group
    of one slot passes no token."""
    run, pos = _state()
    mesh = run.mesh
    axes = tuple(axes)
    members = group_positions(pos, axes, mesh.axis_names,
                              mesh.devices.shape)
    if len(send) != len(members):
        raise ValueError(f"{kind}: {len(send)} sends to a group of "
                         f"{len(members)}")
    if len(members) == 1:
        return list(send)
    slot = mesh.slot_at(pos)
    event = None
    if slot.stream is not None:
        event = torch.cuda.Event()
        event.record(slot.stream)
    call = run.calls[pos]
    run.calls[pos] = call + 1
    board = run.boards[call % 2]
    board[pos] = (call, send, event)
    i = int(np.ravel_multi_index(pos, mesh.devices.shape))
    run.pass_turn(i)
    run.wait_turn(i)
    me = members.index(pos)
    recv, moved = [], 0
    for src in members:
        got, items, ev = board.get(src, (None, None, None))
        if got != call:
            raise SpmdAbort(f"{kind}: slot {src} left without reaching the "
                            f"collective slot {pos} is at")
        t = items[me]
        if src != pos:
            ts = t if isinstance(t, tuple) else (t,)
            moved += sum(x.numel() * x.element_size() for x in ts)
            ts = tuple(_fetch(x, ev, slot) for x in ts)
            t = ts if isinstance(t, tuple) else ts[0]
        recv.append(t)
    key = (kind, axes)
    with _COUNT_LOCK:
        COLLECTIVE_BYTES[key] += moved
        if all(p == 0 for p in pos):
            COLLECTIVE_CALLS[key] += 1
    return recv


def all_to_all(pieces: list, axes: Sequence[str]) -> list:
    """Send ``pieces[j]`` to the j-th slot of the group over ``axes``;
    returns the pieces the group's slots sent here, in group order.
    Received tensors may be the senders' own: read them, do not write
    them (and a sender does not write what it sent)."""
    return _exchange("all_to_all", list(pieces), axes)


def all_gather(x: torch.Tensor, axes: Sequence[str],
               kind: str = "all_gather") -> list:
    """Every group member's ``x`` over ``axes``, in group order."""
    run, pos = _state()
    n = len(group_positions(pos, tuple(axes), run.mesh.axis_names,
                            run.mesh.devices.shape))
    return _exchange(kind, [x] * n, axes)


def all_reduce(x: torch.Tensor, axes: Sequence[str],
               op: str = "sum") -> torch.Tensor:
    """The sum (in float32 at least, rounded once to x's dtype) or the
    maximum of the group's ``x`` over ``axes``: one reduction over the
    parts stacked in group order, the same operation on the same inputs
    on every member, so the same bits."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op {op!r}")
    parts = all_gather(x, axes, kind=f"all_reduce_{op}")
    if len(parts) == 1:
        return x
    stacked = torch.stack(parts)
    if op == "max":
        return stacked.amax(0)
    acc_dtype = torch.promote_types(x.dtype, torch.float32)
    return stacked.sum(0, dtype=acc_dtype).to(x.dtype)


def collective_counts() -> dict:
    """"kind over axes" -> {"calls", "bytes"} since ``clear_collectives``:
    the mesh-wide collectives run and the bytes every slot received from
    other slots."""
    with _COUNT_LOCK:
        keys = sorted(set(COLLECTIVE_CALLS) | set(COLLECTIVE_BYTES))
        return {f"{kind} over {','.join(axes)}":
                {"calls": COLLECTIVE_CALLS[kind, axes],
                 "bytes": COLLECTIVE_BYTES[kind, axes]}
                for kind, axes in keys}


def clear_collectives():
    with _COUNT_LOCK:
        COLLECTIVE_CALLS.clear()
        COLLECTIVE_BYTES.clear()


def _device(d) -> torch.device:
    """A device with its index: a bare "cuda" is the current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(shape, axes, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``devices`` (any mix of device names or
    ``torch.device``s, repeats allowed, exactly prod(shape) of them).
    ``devices=None`` means the first prod(shape) visible CUDA devices, and
    raises where there are fewer."""
    shape, axes = tuple(shape), tuple(axes)
    n = math.prod(shape)
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if visible < n:
            raise RuntimeError(f"make_mesh: a mesh of {n} devices, but "
                               f"{visible} CUDA devices are visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"make_mesh: shape {shape} holds {n} devices, "
                         f"got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return DeviceMesh(grid.reshape(shape), axes)


def make_host_mesh(device=None) -> DeviceMesh:
    """A one-device mesh with the production axis names ("data", "model");
    ``device`` None means the card."""
    return make_mesh((1, 1), ("data", "model"),
                     devices=["cuda" if device is None else device])


def make_production_mesh(*, multi_pod: bool = False,
                         devices=None) -> DeviceMesh:
    """The JAX package's production meshes: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model") with
    ``multi_pod``.  ``devices=None`` is the ``meta`` device in every
    position (the dry-run traces on it and needs no card); a single device
    is repeated, a sequence must hold one device per position."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if devices is None:
        devices = ["meta"] * n
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n
    return make_mesh(shape, axes, devices=devices)


# The roofline's hardware model, per device, with the JAX package's keys
# (its HW models a TPU v5e).  Datasheet figures for the NVIDIA H100 SXM5
# 80GB, not measurements: dense bf16 on the tensor cores, HBM3 bandwidth
# and capacity, and NVLink 4's 450 GB/s a direction as the link rate.  A
# 16-wide mesh axis spans two nodes of eight GPUs, whose links between
# nodes are slower than NVLink, so the collective term taken at this rate
# is a lower bound, as the roofline is.  ``peak_f32_flops`` and
# ``peak_int_ops`` (outside the tensor cores) are the port's additions,
# for the kernels' bounds in ``chip_smoke.py``.
HW = {
    "peak_bf16_flops": 989e12,      # FLOP/s
    "hbm_bw": 3.35e12,              # B/s
    "ici_bw": 450e9,                # B/s, a direction
    "hbm_bytes": 80e9,
    "peak_f32_flops": 67e12,        # FLOP/s on the CUDA cores
    "peak_int_ops": 67e12,          # int32 ops/s on the CUDA cores
}
