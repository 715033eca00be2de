"""Device meshes for the multi-device wave dispatch.

The counterpart of the JAX package's ``launch/mesh.py`` (``make_mesh``,
``make_host_mesh``).  A ``DeviceMesh`` has what the axis rules read of a
``jax.sharding.Mesh`` — ``axis_names`` and ``devices``, a numpy object
array of ``torch.device`` shaped like the mesh — and one thing more: each
position of the mesh is a *slot*, a (device, stream) pair, and the mesh
owns one ``torch.cuda.Stream`` per CUDA slot.

That is the port's one deliberate difference from a jax mesh: a device may
appear more than once.  Four slots over ``cuda:0`` are four streams on one
card, so the wave path runs with n_dev > 1 where there is one card, and
four ``"cpu"`` slots let the CPU tests run it with n_dev > 1 (a CPU slot
takes the kernels' plain versions).
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence

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

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


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
