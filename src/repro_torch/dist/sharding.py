"""Tensor specs and their single-device uses (accounting and
initialization), and the scan axes of a mesh.

Every parameter and cache tensor is declared once as a ``TensorSpec`` with
logical axis names; the specs drive parameter accounting and
``init_params``.  Of the JAX package's logical-axis resolver the port has
what the wave dispatch reads: the "batch" rule and ``scan_mesh_axes`` /
``scan_device_count``, over a ``launch.mesh.DeviceMesh`` or any object with
``axis_names`` and ``devices.shape``.  ``resolve_pspec``, ``constrain`` and
``sharding_ctx`` have no counterpart yet, and the port's models make no
``constrain`` calls.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape + logical axes + dtype + init recipe for one tensor."""
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]
    dtype: torch.dtype = torch.float32
    init: str = "normal"            # 'normal' | 'zeros' | 'ones' | 'embed'
    scale: Optional[float] = None   # override the fan-in init scale

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.size * self.dtype.itemsize


def tspec(shape, axes, dtype=torch.float32, init: str = "normal",
          scale: Optional[float] = None) -> TensorSpec:
    return TensorSpec(tuple(shape), tuple(axes), dtype, init, scale)


def is_spec(x) -> bool:
    return isinstance(x, TensorSpec)


def map_specs(fn: Callable[[TensorSpec], Any], tree):
    """Apply ``fn`` to every spec of a tree of dicts; other leaves stay."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    return fn(tree) if is_spec(tree) else tree


def _leaves(tree) -> list[TensorSpec]:
    """Specs in the JAX package's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _leaves(tree[k])]
    return [tree] if is_spec(tree) else []


def param_count(tree) -> int:
    return sum(s.size for s in _leaves(tree))


def param_bytes(tree) -> int:
    return sum(s.nbytes for s in _leaves(tree))


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

_CHUNK_ELEMS = 1 << 26    # draw big leaves in slices of at most 64 M values


def _init_one(spec: TensorSpec, generator: torch.Generator,
              device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "embed":
        # N(0, (0.5 d^-1/2)^2) on the model dim: tied embeddings keep the
        # initial logits near-uniform
        scale = 0.5 * spec.shape[-1] ** -0.5
    elif spec.scale is not None:
        scale = spec.scale
    else:    # fan-in: the leading axis, as the JAX package counts it
        scale = (spec.shape[0] if spec.shape else 1) ** -0.5
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    # draw in float32 at most _CHUNK_ELEMS values at a time, so a stacked
    # leaf's float32 draw never sits beside the whole low-precision leaf
    flat = out.view(-1, *spec.shape[-1:]) if spec.shape else out.view(1)
    rows = max(1, _CHUNK_ELEMS // max(1, flat.shape[-1]))
    for r0 in range(0, flat.shape[0], rows):
        part = flat[r0:r0 + rows]
        draw = torch.randn(part.shape, generator=generator, device=device,
                           dtype=torch.float32)
        part.copy_(draw * scale)
    return out


def init_params(tree, generator: torch.Generator, device, dtype=None):
    """A tree of tensors on ``device`` from a TensorSpec tree, leaf by leaf
    in the JAX package's flattening order.

    The recipes are the JAX package's (zeros, ones, embed, normal at
    ``spec.scale`` or fan-in^-1/2); the numbers come from ``generator``
    (which must live on ``device``), so they differ from ``jax.random``'s.
    ``dtype`` (e.g. ``torch.bfloat16``) replaces every floating spec dtype;
    each leaf is drawn in float32 a slice at a time and stored in its own
    dtype, which keeps the peak near the tree's size in that dtype."""
    device = torch.device(device)

    def one(spec: TensorSpec) -> torch.Tensor:
        dt = dtype if dtype is not None and spec.dtype.is_floating_point \
            else spec.dtype
        return _init_one(spec, generator, device, dt)

    def walk(node: dict) -> dict:
        return {k: walk(node[k]) if isinstance(node[k], dict)
                else one(node[k]) if is_spec(node[k]) else node[k]
                for k in sorted(node)}

    return walk(tree)


# ---------------------------------------------------------------------------
# Scan axes of a mesh
# ---------------------------------------------------------------------------

# logical axis -> candidate mesh axes, best first; a tuple is compound
# (shard over several mesh axes).  The JAX package's rule for "batch", the
# one logical axis the wave dispatch resolves.
DEFAULT_RULES: dict[str, tuple] = {
    "batch": (("pod", "data"), "data"),
}


def _mesh_sizes(mesh) -> dict[str, int]:
    # a DeviceMesh and the duck-typed fake meshes in tests alike (only
    # axis_names + devices.shape are read)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def scan_mesh_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the fused reader's split dimension shards over: the first
    "batch" candidate with an axis of size > 1 in ``mesh``, its size-1 and
    missing axes dropped, so a (1, 1) host mesh yields ``()`` and callers
    take the single-device path.  No divisibility test: a wave holds up to
    n_dev splits."""
    sizes = _mesh_sizes(mesh)
    for cand in DEFAULT_RULES["batch"]:
        cand_axes = (cand,) if isinstance(cand, str) else tuple(cand)
        cand_axes = tuple(a for a in cand_axes if sizes.get(a, 1) > 1)
        if cand_axes:
            return cand_axes
    return ()


def scan_device_count(mesh, axes: Sequence[str]) -> int:
    """Number of slots the scan grid spans on ``axes`` of ``mesh``."""
    sizes = _mesh_sizes(mesh)
    return int(math.prod(sizes[a] for a in axes)) if axes else 1
