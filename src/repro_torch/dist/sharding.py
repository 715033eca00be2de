"""Logical-axis sharding: TensorSpec trees and the rule-based resolver.

Every parameter and cache tensor is declared once as a ``TensorSpec`` with
logical axis names ("embed", "mlp", "batch", ...); the specs drive
parameter accounting and ``init_params``.  ``resolve_pspec`` maps logical
axes to mesh axes by the JAX package's priority rules with divisibility
fallbacks:

* a rule lists candidate mesh axes per logical axis, best first; a
  candidate may be a COMPOUND tuple like ("pod", "data"), sharding over
  both;
* mesh axes absent from the mesh, or of size 1, are dropped from a
  candidate; for a compound one the longest PREFIX whose size product
  divides the dimension is used;
* a mesh axis is used at most once per tensor: later logical axes fall
  through to their next candidate or stay replicated;
* anything that does not divide evenly stays replicated (never errors).

The port has no ``PartitionSpec``: a resolved spec is a plain tuple with
one entry per dimension (None, a mesh axis name, or a tuple of names),
its trailing Nones trimmed as the JAX package trims them.  The port's
parameters live on one device, so nothing is placed by a spec:
``shard_shape`` / ``shard_bytes`` (the per-device counterparts of the JAX
package's ``shardings`` / ``shape_structs``) size a device's part for the
dry-run, and ``sharding_ctx`` / ``constrain`` record, inside a step traced
by the dry-run, the constraints the JAX package's steps put on their
activations.  Outside a context ``constrain`` is the identity and records
nothing, and inside one it returns its input unchanged: no number changes.
``scan_mesh_axes`` / ``scan_device_count`` give the wave dispatch the
"batch" rule's mesh axes.  Meshes are a ``launch.mesh.DeviceMesh`` or any
object with ``axis_names`` and ``devices.shape``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
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
# Rules and resolver
# ---------------------------------------------------------------------------

# logical axis -> candidate mesh axes, best first; a tuple is compound
# (shard over several mesh axes); missing keys mean "always replicated".
# The JAX package's rules.
DEFAULT_RULES: dict[str, tuple] = {
    # data-parallel axes
    "batch": (("pod", "data"), "data"),
    "layers": (),
    # long-context KV: prefer data, spill to model when batch already took it
    "kv_seq": ("data", "model"),
    # weight axes
    "embed": ("data",),
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "expert": ("model",),
    "expert_mlp": ("model",),
    "ssm_inner": ("model",),
    "conv_dim": ("model",),
    "ssm_heads": ("model",),
    "ssm_state": (),
    "dt_rank": (),
    # activation axes (constrain() names)
    "seq": (),
    "act_embed": (),
    "act_vocab": ("model",),
    "act_mlp": ("model",),
    "act_kv_heads": ("model",),
}

# Variant rule sets for the dry-run's --rules flag, the JAX package's.
RULE_PRESETS: dict[str, dict[str, tuple]] = {
    "baseline": DEFAULT_RULES,
    # pure data-parallel: weights replicated, only batch-ish axes sharded
    "dp_only": {"batch": (("pod", "data"), "data"), "kv_seq": ("data",)},
    # fsdp-flavoured: the embed dimension of weights over the compound
    # (data, model) grid where it divides, else over data alone
    "fsdp": {**DEFAULT_RULES, "embed": (("data", "model"), "data"),
             "vocab": ("model", "data")},
}


def _mesh_sizes(mesh) -> dict[str, int]:
    # a DeviceMesh and the duck-typed fake meshes in tests alike (only
    # axis_names + devices.shape are read)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def resolve_pspec(shape: Sequence[int], axes: Sequence[Optional[str]],
                  mesh, rules: Optional[dict] = None) -> tuple:
    """Map logical axes to a spec on ``mesh`` (see the module doc): one
    entry per dimension, None, a mesh axis or a tuple of mesh axes, the
    trailing Nones trimmed."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = _mesh_sizes(mesh)
    used: set[str] = set()
    entries: list = []
    for dim, name in zip(shape, axes):
        entry = None
        for cand in rules.get(name, ()) if name else ():
            cand_axes = (cand,) if isinstance(cand, str) else tuple(cand)
            # drop mesh axes that do not exist, shard nothing (size 1) or
            # are used already: a size-1 axis kept inside a compound
            # prefix would give a non-canonical spec and burn the axis
            cand_axes = tuple(a for a in cand_axes
                              if sizes.get(a, 1) > 1 and a not in used)
            if not cand_axes:
                continue
            # the longest prefix whose size product divides the dimension
            for k in range(len(cand_axes), 0, -1):
                prefix = cand_axes[:k]
                prod = math.prod(sizes[a] for a in prefix)
                if prod > 1 and dim % prod == 0:
                    entry = prefix[0] if k == 1 else prefix
                    used.update(prefix)
                    break
            if entry is not None:
                break
        entries.append(entry)
    while entries and entries[-1] is None:   # trim for clean equality
        entries.pop()
    return tuple(entries)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one entry of a resolved spec."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(spec: TensorSpec, mesh, rules: Optional[dict] = None
                ) -> tuple[int, ...]:
    """The shape of one device's part of ``spec`` on ``mesh``."""
    sizes = _mesh_sizes(mesh)
    ps = resolve_pspec(spec.shape, spec.axes, mesh, rules)
    return tuple(
        dim // math.prod(sizes[a] for a in spec_axes(ps[i]))
        if i < len(ps) else dim for i, dim in enumerate(spec.shape))


def shard_bytes(tree, mesh, rules: Optional[dict] = None) -> int:
    """The bytes one device holds of every spec of ``tree`` on ``mesh``."""
    return sum(math.prod(shard_shape(s, mesh, rules)) * s.dtype.itemsize
               for s in _leaves(tree))


# ---------------------------------------------------------------------------
# Constraints inside a traced step (sharding_ctx / constrain /
# ctx_axis_size)
# ---------------------------------------------------------------------------

_CTX = threading.local()


@dataclasses.dataclass(frozen=True)
class Constraint:
    """One ``constrain`` call inside a ``sharding_ctx``: the logical axes,
    the tensor's shape and dtype, the resolved spec and, where the tensor
    is the output of a product with a weight, that weight's spec as the
    product saw it (its leaf's trailing dimensions: what the dry-run's
    collective model reads to find the dimensions the product summed
    over)."""
    axes: tuple
    shape: tuple[int, ...]
    dtype: torch.dtype
    spec: tuple
    weight: Optional[TensorSpec] = None


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None, observer=None):
    """Install (mesh, rules) for ``constrain`` calls; yields the list the
    calls append their ``Constraint`` records to.  ``observer`` (the
    dry-run's cost trace) names a weight's spec (``weight_spec(w)``) and
    is told of every constrained tensor (``pin(x, axes)``)."""
    prev = getattr(_CTX, "state", None)
    records: list[Constraint] = []
    _CTX.state = (mesh, DEFAULT_RULES if rules is None else rules, records,
                  observer)
    try:
        yield records
    finally:
        _CTX.state = prev


def ctx_axis_size(name: str) -> int:
    """Size of a mesh axis inside ``sharding_ctx`` (1 when absent or
    without a context)."""
    state = getattr(_CTX, "state", None)
    if state is None:
        return 1
    return _mesh_sizes(state[0]).get(name, 1)


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]], *,
              weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's ``with_sharding_constraint`` site: the identity.
    Inside ``sharding_ctx`` it records a ``Constraint``; ``weight`` is the
    weight of the product that made ``x``, as that product read it."""
    state = getattr(_CTX, "state", None)
    if state is None:
        return x
    mesh, rules, records, observer = state
    wspec = None
    if observer is not None:
        if weight is not None:
            wspec = observer.weight_spec(weight)
        observer.pin(x, axes)
    records.append(Constraint(
        tuple(axes), tuple(x.shape), x.dtype,
        resolve_pspec(x.shape, tuple(axes), mesh, rules), wspec))
    return x


# ---------------------------------------------------------------------------
# Scan axes of a mesh
# ---------------------------------------------------------------------------


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
