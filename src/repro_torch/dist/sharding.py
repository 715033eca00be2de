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
its trailing Nones trimmed as the JAX package trims them.
``shard_shape`` / ``shard_bytes`` (the per-device counterparts of the JAX
package's ``shardings`` / ``shape_structs``) size a device's part, and
``sharding_ctx`` / ``constrain`` record, inside a step traced by the
dry-run, the constraints the JAX package's steps put on their
activations.  Outside a context ``constrain`` is the identity and records
nothing; inside the dry-run's it returns its input unchanged.
``scan_mesh_axes`` / ``scan_device_count`` give the wave dispatch the
"batch" rule's mesh axes.  Meshes are a ``launch.mesh.DeviceMesh`` or any
object with ``axis_names`` and ``devices.shape``.

**Sharded execution** (the serving steps over a mesh of more than one
slot, ``train.step``).  ``place`` splits whole tensors into per-slot
shards (``Sharded``) exactly where ``resolve_pspec`` puts them, each on its
slot's device, the slots along an axis a leaf does not split holding equal
copies; ``gather`` puts them back together.  A *layout* names, for each
dimension of a tensor a slot holds, the mesh axes it is split over (``()``
whole).  Inside ``DeviceMesh.run_spmd`` each slot enters ``slot_ctx``:
its coordinates, the axes the activations' batch is split over, and the
layouts of the tensors it holds (``register`` / ``slot_layout``).  There
``constrain`` is where a product's partial sums meet: its ``weight``'s
layout says which dimensions the product summed over (the weight's
leading ``w.dim() - (x.dim() - 2)``: a product's output is (batch, seq)
and the weight's other dimensions), and where those are split, the
output is all-reduced over their axes (``reduce_partials``).
``gather_tree`` all-gathers a tensor, or every leaf of a tree, over one
axis (a layer's weights over "data" before the layer), and
``reshard_many`` moves tensors from one layout to another by one
all-to-all over their axes (or by a slice, where every slot already holds
what it needs).  The models reach the mesh's collectives
(``all_reduce``, ``all_gather``, ``all_to_all`` of ``launch.mesh``)
through this module alone.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import weakref
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import (all_gather, all_reduce,  # noqa: F401
                                     all_to_all)


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
                  observer, None)
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
    weight of the product that made ``x``, as that product read it.  In a
    slot's context (``slot_ctx``) it all-reduces the partial sums of a
    product whose summed dimensions ``weight`` holds split
    (``reduce_partials``), and records nothing."""
    state = getattr(_CTX, "state", None)
    if state is None:
        return x
    mesh, rules, records, observer, slot = state
    if slot is not None:
        return x if weight is None else reduce_partials(x, weight)
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


# ---------------------------------------------------------------------------
# Sharded execution: leaves placed on a mesh's slots
# ---------------------------------------------------------------------------


def layout_of(spec: tuple, ndim: int) -> tuple:
    """A resolved spec as a layout: for each of ``ndim`` dimensions the
    mesh axes it is split over, ``()`` where it is whole."""
    return tuple(spec_axes(spec[i]) if i < len(spec) else ()
                 for i in range(ndim))


def _split_index(axes: tuple, sizes: dict, coords: dict) -> tuple[int, int]:
    """(the slot's part, the number of parts) of a dimension split over
    ``axes``, the first axis major."""
    k, n = 0, 1
    for a in axes:
        k, n = k * sizes[a] + coords[a], n * sizes[a]
    return k, n


def region(shape: Sequence[int], layout: tuple, sizes: dict,
           coords: dict) -> tuple:
    """The (start, stop) of each dimension of a whole tensor of ``shape``
    that the slot at ``coords`` holds under ``layout``."""
    out = []
    for dim, axes in zip(shape, layout):
        k, n = _split_index(axes, sizes, coords)
        out.append((k * (dim // n), (k + 1) * (dim // n)))
    return tuple(out)


def whole_shape(local: Sequence[int], layout: tuple, sizes: dict) -> tuple:
    """The whole tensor's shape from a slot's part and its layout."""
    return tuple(d * math.prod(sizes[a] for a in axes)
                 for d, axes in zip(local, layout))


def _slices(reg, base=None) -> tuple:
    """A region as slices, relative to the start of region ``base``."""
    base = base or [(0, 0)] * len(reg)
    return tuple(slice(a - b[0], z - b[0]) for (a, z), b in zip(reg, base))


def _within(inner, outer) -> bool:
    return all(o0 <= i0 and i1 <= o1 for (i0, i1), (o0, o1)
               in zip(inner, outer))


def _meet(r1, r2) -> tuple:
    return tuple((max(a0, b0), max(max(a0, b0), min(a1, b1)))
                 for (a0, a1), (b0, b1) in zip(r1, r2))


@dataclasses.dataclass(eq=False)
class Sharded:
    """One leaf placed on a mesh: ``shards``, an object array shaped like
    the mesh, holds each slot's part (on the slot's device); ``shape`` is
    the whole leaf's and ``layout`` the split (``layout_of`` its resolved
    spec)."""
    shards: np.ndarray
    shape: tuple
    layout: tuple
    mesh: Any

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.reshape(-1)[0].dtype

    def shard(self, coords: dict) -> torch.Tensor:
        return self.shards[tuple(coords[a] for a in self.mesh.axis_names)]


def is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def _zip_specs(fn, tree, specs):
    if isinstance(specs, dict):
        if not isinstance(tree, dict) or sorted(tree) != sorted(specs):
            raise ValueError(f"a tree with keys {sorted(specs)} expected")
        return {k: _zip_specs(fn, tree[k], specs[k]) for k in sorted(specs)}
    return fn(tree, specs)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def place(tree, specs, mesh, rules: Optional[dict] = None):
    """A tree of whole tensors -> the same tree of ``Sharded`` leaves on
    ``mesh``: each slot gets a copy of its region of each leaf under the
    leaf's spec in ``specs`` (``resolve_pspec``), on the slot's device."""
    sizes = _mesh_sizes(mesh)

    def one(x: torch.Tensor, spec: TensorSpec) -> Sharded:
        if tuple(x.shape) != tuple(spec.shape):
            raise ValueError(f"place: a leaf of shape {tuple(x.shape)} for "
                             f"a spec of shape {spec.shape}")
        lay = layout_of(resolve_pspec(spec.shape, spec.axes, mesh, rules),
                        x.dim())
        shards = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(mesh.devices.shape):
            reg = region(x.shape, lay, sizes, dict(zip(mesh.axis_names, pos)))
            part = x[_slices(reg)]
            shards[pos] = torch.empty(part.shape, dtype=x.dtype,
                                      device=mesh.devices[pos]).copy_(part)
        return Sharded(shards, tuple(x.shape), lay, mesh)

    return _zip_specs(one, tree, specs)


def assemble(parts: np.ndarray, specs, mesh, rules: Optional[dict] = None):
    """Each slot's tree of parts (an object array shaped like the mesh, as
    ``run_spmd`` returns it) -> one tree of ``Sharded`` leaves, each laid
    out as its spec in ``specs`` resolves; a part of another shape
    raises."""
    sizes = _mesh_sizes(mesh)

    def leaf(path: tuple, spec: TensorSpec) -> Sharded:
        lay = layout_of(resolve_pspec(spec.shape, spec.axes, mesh, rules),
                        len(spec.shape))
        shards = np.empty(mesh.devices.shape, dtype=object)
        for pos in np.ndindex(mesh.devices.shape):
            t = parts[pos]
            for k in path:
                t = t[k]
            reg = region(spec.shape, lay, sizes,
                         dict(zip(mesh.axis_names, pos)))
            if tuple(t.shape) != tuple(b - a for a, b in reg):
                raise RuntimeError(f"assemble: {'/'.join(path)} is "
                                   f"{tuple(t.shape)} on slot {pos}, its "
                                   f"layout {lay} gives {reg}")
            shards[pos] = t
        return Sharded(shards, tuple(spec.shape), lay, mesh)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], path + (k,)) for k in sorted(node)}
        return leaf(path, node)

    return walk(specs, ())


def gather(tree, device=None):
    """A tree of ``Sharded`` leaves -> whole tensors on ``device`` (the
    mesh's first device by default), each region copied once."""
    def one(x: Sharded) -> torch.Tensor:
        mesh = x.mesh
        dev = mesh.devices.reshape(-1)[0] if device is None else device
        sizes = _mesh_sizes(mesh)
        out = torch.empty(x.shape, dtype=x.dtype, device=dev)
        done = set()
        for pos in np.ndindex(mesh.devices.shape):
            reg = region(x.shape, x.layout, sizes,
                         dict(zip(mesh.axis_names, pos)))
            if reg not in done:
                done.add(reg)
                out[_slices(reg)] = x.shards[pos]
        return out

    return _map(one, tree)


def shard_tree(tree, coords: dict):
    """A slot's tree of parts of a tree of ``Sharded`` leaves, each part
    registered with its layout (inside ``slot_ctx``)."""
    return _map(lambda x: register(x.shard(coords), x.layout), tree)


# ---------------------------------------------------------------------------
# A slot's context inside DeviceMesh.run_spmd
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _SlotState:
    coords: dict
    sizes: dict
    batch: tuple                      # the activations' batch split
    layouts: dict = dataclasses.field(default_factory=dict)


@contextlib.contextmanager
def slot_ctx(mesh, rules: Optional[dict] = None, batch_axes: tuple = ()):
    """The calling slot's sharding context, inside ``run_spmd``: the
    slot's coordinates on ``mesh``, the axes the activations' batch is
    split over, and the layouts of the tensors it registers."""
    coords = mesh_mod.spmd_coords()
    if coords is None:
        raise RuntimeError("slot_ctx outside DeviceMesh.run_spmd")
    prev = getattr(_CTX, "state", None)
    slot = _SlotState(coords, _mesh_sizes(mesh), tuple(batch_axes))
    _CTX.state = (mesh, DEFAULT_RULES if rules is None else rules, [],
                  None, slot)
    try:
        yield slot
    finally:
        _CTX.state = prev


def _slot() -> Optional[_SlotState]:
    state = getattr(_CTX, "state", None)
    return None if state is None else state[4]


def in_slot() -> bool:
    """True inside a slot's context (sharded execution)."""
    return _slot() is not None


def batch_axes() -> tuple:
    """The mesh axes the activations' batch is split over."""
    return _slot().batch


def register(t: torch.Tensor, layout: tuple) -> torch.Tensor:
    """Record ``t``'s layout in the slot's context; returns ``t``."""
    slot = _slot()
    if len(layout) != t.dim():
        raise ValueError(f"register: a layout of {len(layout)} dimensions "
                         f"for a tensor of {t.dim()}")
    slot.layouts[id(t)] = (weakref.ref(t), tuple(layout))
    return t


def slot_layout(t: torch.Tensor) -> tuple:
    """The layout ``t`` was registered with in the slot's context."""
    entry = _slot().layouts.get(id(t))
    if entry is None or entry[0]() is not t:
        raise RuntimeError(f"no layout is registered for a tensor of shape "
                           f"{tuple(t.shape)}: a product site whose weight "
                           f"the sharded step did not place")
    return entry[1]


def slot_region(shape: Sequence[int], layout: tuple) -> tuple:
    """The calling slot's (start, stop) a dimension of a whole tensor of
    ``shape`` under ``layout``."""
    slot = _slot()
    return region(shape, layout, slot.sizes, slot.coords)


def slot_whole_shape(local: Sequence[int], layout: tuple) -> tuple:
    """The whole tensor's shape from the calling slot's part."""
    return whole_shape(local, layout, _slot().sizes)


def spec_layout(spec: TensorSpec) -> tuple:
    """The layout ``spec`` resolves to on the slot context's mesh and
    rules."""
    mesh, rules = _CTX.state[:2]
    return layout_of(resolve_pspec(spec.shape, spec.axes, mesh, rules),
                     len(spec.shape))


def slot_index(axes: tuple) -> tuple[int, int]:
    """(the calling slot's index, the count) along ``axes``."""
    slot = _slot()
    return _split_index(tuple(axes), slot.sizes, slot.coords)


def group_view(tree, g: int):
    """The views ``[g]`` of a group-stacked tree a slot holds, each
    registered with its leaf's layout past the stacking axis."""
    def one(x):
        lay = slot_layout(x)
        if lay[0]:
            raise NotImplementedError("a stacked leaf split over its "
                                      "layers axis")
        return register(x[g], lay[1:])
    return _map(one, tree)


def _ordered_axes(layout, mesh) -> tuple:
    """The mesh axes a layout uses, in the mesh's order."""
    used = {a for d in layout for a in d}
    return tuple(a for a in mesh.axis_names if a in used)


def reshard_many(moves: list) -> list:
    """For each ``(x, have, want)`` of ``moves``, the slot's part of a
    tensor under layout ``want`` from its part ``x`` under ``have`` (every
    slot calls it alike), registered with ``want``: a slice where every
    slot already holds what it needs, else one all-to-all for all the
    moves over the same axes, in which each slot sends each peer the
    region of its part the peer needs.  A move's group is the axes
    ``have`` splits, less those that split a dimension the same way in
    ``want`` (a peer that differs there holds none of what the slot
    needs)."""
    slot = _slot()
    mesh = mesh_mod.spmd_mesh()
    names, shape = tuple(mesh.axis_names), tuple(mesh.devices.shape)
    pos = tuple(slot.coords[a] for a in names)
    out: list = [None] * len(moves)
    swaps: dict = {}
    for i, (x, have, want) in enumerate(moves):
        plan = _reshard_plan(tuple(x.shape), tuple(have), tuple(want), names,
                             shape, pos)
        if plan is None:
            out[i] = x
        elif plan[0] == "slice":
            out[i] = register(x[plan[1]], tuple(want))
        else:
            _, axes, cat_dim, sends, parts, need = plan
            swaps.setdefault(axes, []).append(
                (i, x, tuple(want), cat_dim, [x[sl] for sl in sends], parts,
                 need))
    for axes, swap in swaps.items():
        kind = ("all_gather" if all(m[3] is not None for m in swap)
                else "all_to_all")
        recv = mesh_mod._exchange(
            kind, [tuple(m[4][j] for m in swap)
                   for j in range(len(swap[0][4]))], axes)
        for k, (i, x, want, cat_dim, _, parts, need) in enumerate(swap):
            if cat_dim is not None:     # whole parts, end to end
                res = torch.cat([got[k] for got in recv], dim=cat_dim)
            else:
                res = x.new_empty(need)
                for sl, got in zip(parts, recv):
                    if got[k].numel():
                        res[sl] = got[k]
            out[i] = register(res, want)
    return out


@functools.lru_cache(maxsize=1 << 14)
def _reshard_plan(local: tuple, have: tuple, want: tuple, names: tuple,
                  mesh_shape: tuple, pos: tuple):
    """How the slot at ``pos`` moves its part (shape ``local``) from
    layout ``have`` to ``want``: None (the same layout); ("slice", its
    slices) where every slot already holds what it needs; else ("swap",
    the group's axes, the dimension along which the members' whole parts
    lie end to end in member order where they do (an all-gather: the
    result is their concatenation) else None, the slices of its part it
    sends each member, the slices of the result each member's piece
    fills, the result's shape).  A function of shapes and positions only,
    so it is computed once a slot and shape."""
    if have == want:
        return None
    sizes = dict(zip(names, mesh_shape))
    shape = whole_shape(local, have, sizes)

    def reg(lay, p):
        return region(shape, lay, sizes, dict(zip(names, p)))

    everywhere = list(np.ndindex(mesh_shape))
    mine, need = reg(have, pos), reg(want, pos)
    if all(_within(reg(want, p), reg(have, p)) for p in everywhere):
        return ("slice", _slices(need, mine))
    kept = {a for h, w in zip(have, want) if h == w for a in h}
    used = {a for d in have for a in d}
    axes = tuple(a for a in names if a in used and a not in kept)
    members = mesh_mod.group_positions(pos, axes, names, mesh_shape)
    parts = [_meet(reg(have, q), need) for q in members]
    cat_dim = None
    if all(_within(reg(have, p), reg(want, q)) for p in everywhere
           for q in mesh_mod.group_positions(p, axes, names, mesh_shape)):
        split = [d for d in range(len(local))
                 if any(r[d] != need[d] for r in parts)]
        if len(split) == 1 and all(
                a[split[0]][1] == b[split[0]][0]
                for a, b in zip(parts, parts[1:])):
            cat_dim = split[0]
    return ("swap", axes, cat_dim,
            tuple(_slices(_meet(mine, reg(want, q)), mine) for q in members),
            tuple(_slices(part, need) for part in parts),
            tuple(b - a for a, b in need))


def gather_tree(tree, axis: str):
    """A tensor, or every leaf of a tree in one all-gather, gathered over
    mesh axis ``axis`` wherever its layout splits it there (itself where
    it does not); the results are registered."""
    paths, moves = [], []

    def collect(node, path):
        if isinstance(node, dict):
            for k in node:
                collect(node[k], path + (k,))
            return
        have = slot_layout(node)
        paths.append(path)
        moves.append((node, have, tuple(tuple(a for a in d if a != axis)
                                        for d in have)))

    collect(tree, ())
    done = reshard_many(moves)
    if not isinstance(tree, dict):
        return done[0]
    out: dict = {}
    for path, t in zip(paths, done):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def reduce_partials(x: torch.Tensor,
                    weight: torch.Tensor) -> torch.Tensor:
    """The output ``x`` (batch, seq, ...) of a product with ``weight``,
    all-reduced over the mesh axes that split the dimensions the product
    summed over (``weight``'s leading ``weight.dim() - (x.dim() - 2)``);
    ``x`` itself outside a slot's context or where none is split."""
    if not in_slot():
        return x
    lay = slot_layout(weight)
    summed = lay[:weight.dim() - (x.dim() - 2)]
    axes = _ordered_axes(summed, mesh_mod.spmd_mesh())
    return mesh_mod.all_reduce(x, axes) if axes else x
