"""Cost of a step from the operations it dispatches: FLOPs, HBM bytes,
live bytes, and a model of its collectives.

The counterpart of the JAX package's ``launch/hlo_analysis.py``, which
parses the post-SPMD HLO of a compiled step and multiplies each ``while``
body by its trip count, since XLA's own cost analysis visits a loop body
once.  The port has no compiler and no partitioner: its step is eager
PyTorch, and the operations it dispatches are the kernels the card runs.
So this module is not an HLO parser.  ``CostTrace``, a
``TorchDispatchMode``, records every aten operation a step dispatches,
run on the ``meta`` device (nothing is allocated) or on a real one:

* every layer runs in Python, so every loop is unrolled already, and the
  trip-count correction has no counterpart;
* eager PyTorch writes each operation's output to memory, so the bytes
  in and out of each operation are the eager program's own traffic,
  where the JAX package had to take fusion boundaries as a proxy.

The hand-written kernels' wrappers note their own work by their formulas
(``kernels/_build.noted``) and the trace counts nothing inside them, so a
step traced on ``meta`` (the kernels' meta routes) and the same step
traced on the card give the same record.

Keys, the JAX package's: ``flops`` (dot FLOPs 2*M*N*K of ``mm``, ``bmm``,
``addmm``, ``baddbmm`` -- what ``matmul`` and ``einsum`` decompose into --
plus one a value for pointwise operations and one an input value for
reductions), ``dot_flops``, ``hbm_bytes`` (inputs + outputs of every
operation that moves data; views, ``empty`` and ``detach`` count nothing),
``coll_bytes`` / ``coll_link_bytes`` / ``coll_count`` (from
``model_collectives``: the port has no partitioner, so they are a model
built from the specs and the recorded constraints), and the port's
``peak_live_bytes``: the most bytes the tensors the trace made held at
once, counted once per storage and freed when its last reference goes.

``roofline_terms`` is the JAX package's function.
"""
from __future__ import annotations

import collections
import math
import weakref
from typing import Optional

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import sharding as sh
from repro_torch.kernels import _build

aten = torch.ops.aten

# operations that move no data: allocation without a fill, and aliases
_NO_DATA = {aten.empty.memory_format, aten.empty_like.default,
            aten.empty_strided.default, aten.new_empty.default,
            aten.new_empty_strided.default, aten.detach.default,
            aten.alias.default, aten._local_scalar_dense.default}
# reductions: one flop an input value
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.cumsum, aten.logsumexp, aten.prod,
               aten._softmax, aten._log_softmax, aten.norm,
               aten.linalg_vector_norm, aten.var_mean, aten.var,
               aten.topk, aten.argmax, aten.any, aten.all}


def _dot_flops(func, args, kwargs, out) -> float:
    """2*M*N*K of a product (``mm``, ``bmm``, ``addmm``, ``baddbmm``, and
    the convolutions and fused attentions ``FlopCounterMode`` knows), by
    ``torch.utils.flop_counter``'s formulas; 0 for anything else."""
    fn = flop_registry.get(func.overloadpacket)
    return 0.0 if fn is None else float(fn(*args, **kwargs, out_val=out))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


# A tensor's class in a trace laid on meshes (``CostTrace(meshes=...)``):
#   "W" a weight as the products read it: a parameter of a serving step,
#       the copy a training step differentiates, and whatever is computed
#       from weights alone (casts, views, slices); split over its leaf's
#       mesh axes but the batch axes, over which it is all-gathered first;
#   "G" a weight's gradient as the product that makes it writes it: a
#       product of activations that reads a storage which met a training
#       weight in a product (the forward's input, or the output's gradient
#       in the backward) and whose output has that weight's shape (each
#       device sums its batch shard into the weight's "W" split); right
#       after, the reduce-scatter the collective model counts leaves it at
#       the parameter's split, "P", for the update;
#   "P" a parameter of a training step's state, as the optimizer reads it,
#       and "S" the optimizer's other state: split over all the leaf's
#       axes; any operation that reads one is part of the update, "S";
#   "D" the batch and the caches: split as their specs say;
#   "A" every other tensor: an activation, split as its inputs are (the
#       batch axes of one, the other axes of another: a product of a
#       batch-split activation and a model-split weight is split over
#       both), then as ``constrain`` pins it.
# A split is a (batch part, other part) pair a mesh.
_W, _G, _P, _S, _D, _A = "W", "G", "P", "S", "D", "A"


class _Class:
    __slots__ = ("kind", "pairs", "leaf", "gathered", "shard", "ref",
                 "fresh")

    def __init__(self, kind, pairs, leaf=None, gathered=None, shard=None):
        self.kind, self.pairs, self.leaf = kind, pairs, leaf
        self.gathered = gathered        # a "P" leaf's "W" pairs
        self.shard = shard              # a "W" copy's "P" pairs
        self.ref = None
        self.fresh = False


class _Storage:
    """A storage the trace made: its bytes, its split and, for an
    activation, the bytes read and written of it so far (counted when it
    is freed, at the split a later ``constrain`` may have pinned).
    ``fresh``: made from no tensor (``empty``, ``zeros``, ``arange``):
    split over every device until an operation touches it, then as that
    operation's outputs are if it writes into it (a buffer), else whole on
    every device (a mask, a range)."""
    __slots__ = ("ref", "nbytes", "pairs", "acc", "fresh")

    def __init__(self, nbytes, pairs, fresh=False):
        self.ref, self.nbytes, self.pairs, self.acc = None, nbytes, pairs, 0
        self.fresh = fresh


def _widest(pairs_list, k):
    """The elementwise widest split of several: per mesh the largest
    batch part and the largest other part."""
    return tuple((max(p[j][0] for p in pairs_list),
                  max(p[j][1] for p in pairs_list)) for j in range(k))


def _most(pairs_list, k):
    """Per mesh, the pair that splits most."""
    return tuple(max((p[j] for p in pairs_list), key=lambda q: q[0] * q[1])
                 for j in range(k))


class CostTrace(TorchDispatchMode):
    """Records the cost of every aten operation dispatched inside it (see
    the module doc).  ``device``: count only the operations that touch a
    tensor of that device type (the card's or ``meta``), so host-side
    bookkeeping (the checkpoint's RNG states) stays out; None counts
    every operation.  ``keep_ops`` keeps a per-operation table
    (``op_table``: name -> calls, flops, bytes).

    ``meshes`` (with ``rules``) lays the step on each mesh as it runs:
    every tensor gets a class (the ``_W`` .. ``_A`` table above) and a
    split, ``seed`` gives the arguments theirs, and ``constrain`` pins an
    activation's (``pin``; ``weight_spec`` names a weight's spec).  A
    device reads and writes each tensor's bytes over its split, and holds
    each live one's over it.

    After the block: ``flops``, ``dot_flops``, ``hbm_bytes``,
    ``peak_live_bytes``, ``op_counts`` (aten operation -> calls),
    ``kernels`` (launch counter name -> calls, flops, dot flops, bytes),
    ``to_dict()``, and per mesh, one device's ``dev_bytes`` and
    ``dev_peak_live_bytes``."""

    def __init__(self, device=None, keep_ops: bool = False, meshes=(),
                 rules=None):
        super().__init__()
        self.device_type = (None if device is None
                            else torch.device(device).type)
        self.flops = 0.0
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.op_counts: collections.Counter = collections.Counter()
        self.op_table: Optional[dict] = {} if keep_ops else None
        self.kernels: dict[str, dict] = {}
        self.skipped_ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict[int, _Storage] = {}    # storage id -> its entry
        self._paused = 0
        self._prev_hook = None
        self.meshes = list(meshes)
        self.rules = sh.DEFAULT_RULES if rules is None else rules
        self._batch = _batch_mesh_axes(self.rules)
        k = self._k = len(self.meshes)
        self._one = ((1, 1),) * k
        self._full = tuple(self._all_devices(mesh) for mesh in self.meshes)
        self._cls: dict[int, _Class] = {}       # id(tensor) -> its class
        # storage id -> {a training weight's shape as a product read it
        # beside that storage, and transposed -> the weight's class, or
        # None where weights of two splits share the shape}: a product of
        # activations that reads the storage with that output shape is the
        # weight's gradient
        self._wgrad: dict[int, dict[tuple, Optional[_Class]]] = {}
        self.dev_bytes = [0.0] * k
        self._dev_live = [0.0] * k
        self.dev_peak_live_bytes = [0.0] * k

    # -- the mode -----------------------------------------------------------

    def __enter__(self):
        self._prev_hook = _build.COST_HOOK
        _build.COST_HOOK = self._kernel
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COST_HOOK = self._prev_hook
        for entry in self._live.values():      # fold what is still live
            self._fold(entry)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._record(func, args, kwargs, out)
        return out

    # -- splits --------------------------------------------------------------

    def _pairs(self, shape, axes, gathered: bool = False) -> tuple:
        """(batch part, other part) of ``axes`` resolved on each mesh;
        ``gathered``: without the batch axes, as after an all-gather."""
        out = []
        for mesh in self.meshes:
            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            b = m = 1
            for e in sh.resolve_pspec(shape, axes, mesh, self.rules):
                for a in sh.spec_axes(e):
                    if a in self._batch:
                        b *= sizes[a]
                    else:
                        m *= sizes[a]
            out.append((1, m) if gathered else (b, m))
        return tuple(out)

    def _all_devices(self, mesh) -> tuple:
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        b = math.prod(n for a, n in sizes.items() if a in self._batch)
        return (b, math.prod(sizes.values()) // b)

    def _set_class(self, t: torch.Tensor, c: _Class):
        key = id(t)
        c.ref = weakref.ref(t, lambda _: self._cls.pop(key, None))
        self._cls[key] = c

    def seed(self, t: torch.Tensor, spec: sh.TensorSpec, role: str):
        """An argument's class: ``role`` "weight" (a serving step's
        parameter), "param" (a training state's), "state" (the optimizer's
        moments and count) or "data" (the batch, the caches)."""
        if not self._k:
            return
        if role == "weight":
            c = _Class(_W, self._pairs(spec.shape, spec.axes, True), spec)
        elif role == "param":
            c = _Class(_P, self._pairs(spec.shape, spec.axes), spec,
                       self._pairs(spec.shape, spec.axes, True))
        else:
            c = _Class(_S if role == "state" else _D,
                       self._pairs(spec.shape, spec.axes))
        self._set_class(t, c)

    def _class(self, t: torch.Tensor) -> _Class:
        c = self._cls.get(id(t))
        if c is not None:
            return c
        entry = self._live.get(t.untyped_storage()._cdata)
        return _Class(_A, entry.pairs if entry is not None else self._one)

    def split_of(self, t: torch.Tensor) -> tuple:
        """``t``'s (batch part, other part) a mesh."""
        return self._class(t).pairs

    def weight_spec(self, w: torch.Tensor) -> Optional[sh.TensorSpec]:
        """The spec of weight ``w`` as a product reads it: its leaf's
        trailing dimensions (a layer's slice of a stacked leaf, an
        expert's of a layer's)."""
        c = self._cls.get(id(w))
        if c is None or c.leaf is None:
            return None
        n = w.dim()
        return sh.TensorSpec(c.leaf.shape[-n:], c.leaf.axes[-n:], w.dtype)

    def pin(self, x: torch.Tensor, axes):
        """``constrain(x, axes)``: an activation's split from here on,
        and for the bytes already moved of it."""
        if not self._k or id(x) in self._cls:
            return
        entry = self._live.get(x.untyped_storage()._cdata)
        if entry is None:
            return
        pairs = self._pairs(tuple(x.shape), tuple(axes))
        if any(a is not None and a not in self.rules for a in axes):
            # an axis with no rule ("act_heads", "moe_group"): the split
            # the product gave it stays, as the JAX package's comments
            # intend (heads over "model", MoE groups on the batch's
            # shard); its rules would replicate them (PERF.md section 7)
            pairs = tuple((max(b, old[0]), max(m, old[1])) for (b, m), old
                          in zip(pairs, entry.pairs))
        self._resplit(entry, pairs)

    def _resplit(self, entry: _Storage, pairs):
        for j in range(self._k):
            self._dev_live[j] += entry.nbytes * (
                1 / math.prod(pairs[j]) - 1 / math.prod(entry.pairs[j]))
            self.dev_peak_live_bytes[j] = max(self.dev_peak_live_bytes[j],
                                              self._dev_live[j])
        entry.pairs = pairs
        entry.fresh = False

    def _out_class(self, func, cin: list, tin: list, outs: list,
                   dot: float) -> _Class:
        """The class of an operation's outputs from its inputs' (``cin``,
        of the tensors ``tin``)."""
        kinds = {c.kind for c in cin}
        if dot and outs:
            if _W in kinds:
                self._note_weight_product(cin, tin)
            elif kinds == {_A}:
                w = self._gradient_of(tin, tuple(outs[0].shape))
                if w is not None:
                    return _Class(_G, w.pairs, w.leaf, shard=w.shard)
        if func is aten.detach.default and kinds == {_P}:
            return _Class(_W, cin[0].gathered, cin[0].leaf,
                          shard=cin[0].pairs)
        if kinds & {_S, _P}:
            return _Class(_S, _most([c.pairs for c in cin], self._k))
        if kinds == {_W}:
            return _Class(_W, _widest([c.pairs for c in cin], self._k),
                          cin[0].leaf, shard=cin[0].shard)
        return _Class(_A, _widest([c.pairs for c in cin] or [self._one],
                                  self._k))

    def _note_weight_product(self, cin: list, tin: list):
        """A product of a training weight: its other inputs' storages met
        the weight, at its shape and transposed."""
        for t, c in zip(tin, cin):
            if c.kind != _W or t.dim() != 2 or c.shard is None:
                continue
            for o, oc in zip(tin, cin):
                if oc.kind == _W:
                    continue
                met = self._wgrad.setdefault(o.untyped_storage()._cdata, {})
                for shape in (tuple(t.shape), tuple(t.shape)[::-1]):
                    old = met.get(shape, c)
                    same = old is not None and (old.pairs, old.shard) == (
                        c.pairs, c.shard)
                    met[shape] = c if same else None

    def _gradient_of(self, tin: list, shape: tuple) -> Optional[_Class]:
        """The weight whose gradient a product of activations ``tin`` with
        output ``shape`` is: one that met an input's storage at that shape,
        with no other split met there (a square wq beside a square wo of
        the other split is told apart by the storage); None if none or
        if the inputs name two splits."""
        found = {}
        for t in tin:
            c = self._wgrad.get(t.untyped_storage()._cdata, {}).get(shape)
            if c is not None:
                found[(c.pairs, c.shard)] = c
        return next(iter(found.values())) if len(found) == 1 else None

    # -- live bytes ----------------------------------------------------------

    def _adopt(self, tensors, known: set, oc: Optional[_Class] = None):
        """Count each output storage not seen before and not one of the
        operation's inputs' (``known``) as live until it is freed; with
        meshes, at the split of the operation's outputs ``oc``."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in known or key in self._live:
                continue
            n = st.nbytes()
            entry = _Storage(n, oc.pairs if oc is not None else self._one,
                             oc is not None and oc.fresh)
            entry.ref = weakref.ref(st, self._freer(key))
            self._live[key] = entry
            self.live_bytes += n
            if self.live_bytes > self.peak_live_bytes:
                self.peak_live_bytes = self.live_bytes
            for j in range(self._k):
                self._dev_live[j] += n / math.prod(entry.pairs[j])
                if self._dev_live[j] > self.dev_peak_live_bytes[j]:
                    self.dev_peak_live_bytes[j] = self._dev_live[j]

    def _fold(self, entry: _Storage):
        """An activation's bytes moved so far, at its split."""
        for j in range(self._k):
            self.dev_bytes[j] += entry.acc / math.prod(entry.pairs[j])
        entry.acc = 0

    def _freer(self, key):
        def free(_):
            self._wgrad.pop(key, None)
            entry = self._live.pop(key, None)
            if entry is not None:
                self.live_bytes -= entry.nbytes
                self._fold(entry)
                for j in range(self._k):
                    self._dev_live[j] -= entry.nbytes / math.prod(
                        entry.pairs[j])
        return free

    # -- one operation -------------------------------------------------------

    def _record(self, func, args, kwargs, out):
        if func is aten.lift_fresh.default:
            # the marker ``torch.tensor`` leaves on a fresh constant (none
            # on the meta device, whose constants are made unmarked): no
            # operation and no data, on any device
            return
        ins = [x for x in tree_leaves((args, kwargs))
               if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if self.device_type is not None and not any(
                t.device.type == self.device_type for t in ins + outs):
            self.skipped_ops += 1
            return
        name = str(func)
        self.op_counts[name] += 1
        in_keys = {t.untyped_storage()._cdata for t in ins}
        aliases = all(t.untyped_storage()._cdata in in_keys for t in outs)
        moves = not (func in _NO_DATA or func.is_view or (
            outs and aliases and not func._schema.is_mutable))
        n_bytes = (sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
                   if moves else 0)
        flops = dot = 0.0
        if outs:
            dot = _dot_flops(func, args, kwargs, out)
            if dot:
                flops = dot
            elif torch.Tag.pointwise in func.tags:
                flops = float(sum(t.numel() for t in outs))
            elif func.overloadpacket in _REDUCTIONS and ins:
                flops = float(ins[0].numel())
        self.flops += flops
        self.dot_flops += dot
        self.hbm_bytes += n_bytes
        if self.op_table is not None:
            row = self.op_table.setdefault(name, [0, 0.0, 0])
            row[0] += 1
            row[1] += flops
            row[2] += n_bytes
        if not self._k:
            self._adopt(outs, in_keys)
            return
        # a fresh storage this operation writes into takes its split; one
        # it reads is whole on every device
        written = ({t.untyped_storage()._cdata for t in outs} & in_keys
                   if func._schema.is_mutable else set())
        fresh = {key for key in in_keys if key in self._live
                 and self._live[key].fresh}
        for key in fresh - written if moves else ():
            self._resplit(self._live[key], self._one)
        tin = [t for t in ins
               if t.untyped_storage()._cdata not in fresh & written]
        cin = [self._class(t) for t in tin]
        oc = self._out_class(func, cin, tin, outs, dot)
        if not ins:
            oc.pairs, oc.fresh = self._full, True
        for key in fresh & written:
            self._resplit(self._live[key], oc.pairs)
        self._adopt(outs, in_keys, oc)
        for t in outs:
            # an activation's split lives on its storage; a view of an
            # argument's (a cache's slot) carries its own
            if id(t) not in self._cls and (
                    oc.kind != _A
                    or t.untyped_storage()._cdata not in self._live):
                self._set_class(t, _Class(oc.kind, oc.pairs, oc.leaf,
                                          oc.gathered, oc.shard))
        if moves:
            for t in ins + outs:
                self._moved(t, _nbytes(t))
        if oc.kind == _G:
            # reduce-scattered: the parameter's split from here on
            for t in outs:
                entry = self._live.get(t.untyped_storage()._cdata)
                if entry is not None:
                    self._resplit(entry, oc.shard)
                self._set_class(t, _Class(_P, oc.shard, oc.leaf, oc.pairs))

    def _moved(self, t: torch.Tensor, n: int):
        """``n`` bytes of ``t`` read or written: an activation's counted
        when its storage is freed, anything else's now."""
        c = self._cls.get(id(t))
        if c is None:
            entry = self._live.get(t.untyped_storage()._cdata)
            if entry is not None:
                entry.acc += n
                return
            pairs = self._one
        else:
            pairs = c.pairs
        for j in range(self._k):
            self.dev_bytes[j] += n / math.prod(pairs[j])

    def _kernel(self, kernel: str, work, run, inputs=()):
        """``_build.noted``'s hook: run the wrapper's body unrecorded, then
        record its work (its bytes split as its ``inputs`` are), and count
        its outputs as live."""
        self._paused += 1
        try:
            out = run()
            flops, dot, n_bytes = work()
        finally:
            self._paused -= 1
        rec = self.kernels.setdefault(kernel, {"calls": 0, "flops": 0.0,
                                               "dot_flops": 0.0,
                                               "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += flops
        rec["dot_flops"] += dot
        rec["bytes"] += n_bytes
        self.flops += flops
        self.dot_flops += dot
        self.hbm_bytes += n_bytes
        outs = [x for x in tree_leaves(out) if isinstance(x, torch.Tensor)]
        if not self._k:
            self._adopt(outs, set())
            return out
        oc = _Class(_A, _widest([self._class(t).pairs for t in inputs]
                                or [self._one], self._k))
        self._adopt(outs, set(), oc)
        for j in range(self._k):
            self.dev_bytes[j] += n_bytes / math.prod(oc.pairs[j])
        return out

    def to_dict(self) -> dict:
        """The JAX package's cost keys (collectives empty: see
        ``model_collectives``) and the port's."""
        return {"flops": self.flops, "dot_flops": self.dot_flops,
                "hbm_bytes": self.hbm_bytes, "coll_bytes": {},
                "coll_link_bytes": 0.0, "coll_count": {},
                "peak_live_bytes": self.peak_live_bytes,
                "ops": sum(self.op_counts.values()),
                "kernels": {k: dict(v) for k, v in self.kernels.items()}}


# ---------------------------------------------------------------------------
# Collectives, modelled
# ---------------------------------------------------------------------------


def _batch_mesh_axes(rules) -> set[str]:
    """The mesh axes the rules' "batch" candidates name ("pod", "data")."""
    return {a for cand in rules.get("batch", ())
            for a in sh.spec_axes(cand)}


def contracted_dims(weight_axes, out_axes) -> list[int]:
    """The dimensions of a weight that a product with it summed over: those
    whose logical axis the output's axes do not carry (an activation's
    "act_mlp" carries a weight's "mlp")."""
    kept = {a[4:] if a and a.startswith("act_") else a for a in out_axes}
    return [d for d, a in enumerate(weight_axes) if a not in kept]


def model_collectives(weights, records, mesh, rules, *, train: bool,
                      batch_axes) -> dict:
    """The collectives of one step on ``mesh``, per device, modelled from
    the weights' specs (``weights``, a TensorSpec tree: what moves is in
    their dtype) and the step's ``Constraint`` records, with
    ``batch_axes`` the mesh axes that split the batch.  This is a model,
    not a measurement: the port has no partitioner.

    1. A weight sharded over a mesh axis of the "batch" rule ("pod",
       "data") is all-gathered over those axes in the forward; in
       training again in the backward (the gathered copy is not kept
       between them: the JAX package's step compiled on a (2, 4) mesh
       gathers twice too), and its gradient is reduce-scattered over
       them.  Payload: the weight's bytes on a device after the gather.
    2. In training, a weight's gradient is all-reduced over the batch
       axes that split the batch but not the weight.  Payload: its shard.
    3. An activation recorded after a product that contracted a weight
       dimension the rules shard over another axis ("model") is
       all-reduced over that axis, twice in training (its gradient's in
       the backward).  The record names the weight (``weight``); the
       contracted dimensions are those whose axis the activation's axes
       do not carry (``contracted_dims``).
    4. An activation with an "expert" dimension the rules shard, recorded
       with no product before it (the MoE dispatch buffer), goes to its
       experts and back by two all-to-alls over that axis, twice as many
       in training.
    5. An attention whose query heads the rules shard over a mesh axis
       that they leave its KV heads whole on (the KV heads do not divide
       it: 8 KV heads on a 16-wide "model" axis, the reduced configs' 2
       on a 4-wide one; gemma3-4b's 8 query heads do not divide 16
       either, so its queries split by sequence) gathers the queries'
       heads over that axis to
       meet the whole K and V: one all-gather of the query activation (the
       ``act_heads`` record, followed by its K record), twice in training
       (the backward gathers the K/V-shaped gradient terms).  Payload: the
       queries' bytes over the batch axes.  The JAX package's step on a
       (2, 4) host mesh gathers exactly this in the forward of reduced
       gemma3-4b (f32[4,64,4,16] over the model axis, one a layer).

    An activation's payload is its bytes over the mesh axes of its spec
    and ``batch_axes`` (every recorded activation carries the whole
    batch's tokens).  Link bytes are the JAX package's: an all-reduce
    2(g-1)/g * S, the others (g-1)/g * S, g the group's size."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    bmesh = _batch_mesh_axes(rules)
    batch_axes = set(batch_axes)
    coll_bytes: collections.Counter = collections.Counter()
    coll_count: collections.Counter = collections.Counter()
    link = 0.0

    def add(kind, payload, group, times=1):
        nonlocal link
        g = math.prod(sizes[a] for a in group)
        if g <= 1 or payload <= 0:
            return
        frac = (g - 1) / g
        coll_bytes[kind] += times * payload
        coll_count[kind] += times
        link += times * payload * frac * (2 if kind == "all-reduce" else 1)

    for s in sh._leaves(weights):
        ps = sh.resolve_pspec(s.shape, s.axes, mesh, rules)
        used = {a for e in ps for a in sh.spec_axes(e)}
        shard = math.prod(sh.shard_shape(s, mesh, rules)) * s.dtype.itemsize
        gather = used & bmesh
        if gather:
            full = shard * math.prod(sizes[a] for a in gather)
            add("all-gather", full, gather, 2 if train else 1)
            if train:
                add("reduce-scatter", full, gather)
        if train:
            add("all-reduce", shard, batch_axes - used)

    def split_dim(w, i) -> set:
        ps = sh.resolve_pspec(w.shape, w.axes, mesh, rules)
        return set(sh.spec_axes(ps[i])) if i < len(ps) else set()

    for r, nxt in zip(records, list(records[1:]) + [None]):
        if (r.weight is not None and "act_heads" in r.axes
                and r.axes[1] == "seq" and nxt is not None
                and nxt.weight is not None and "act_kv_heads" in nxt.axes):
            wq, wk = r.weight, nxt.weight
            group = (split_dim(wq, wq.axes.index("heads"))
                     - split_dim(wk, wk.axes.index("kv_heads")) - bmesh)
            add("all-gather", math.prod(r.shape) * r.dtype.itemsize
                / math.prod(sizes[a] for a in batch_axes), group,
                2 if train else 1)

    for r in records:
        spec = sh.resolve_pspec(r.shape, r.axes, mesh, rules)
        used = {a for e in spec for a in sh.spec_axes(e)} | batch_axes
        payload = (math.prod(r.shape) * r.dtype.itemsize
                   / math.prod(sizes[a] for a in used))
        times = 2 if train else 1
        if r.weight is not None:
            w = r.weight
            wps = sh.resolve_pspec(w.shape, w.axes, mesh, rules)
            group = {a for d in contracted_dims(w.axes, r.axes)
                     if d < len(wps) for a in sh.spec_axes(wps[d])} - bmesh
            add("all-reduce", payload, group, times)
        elif "expert" in r.axes:
            i = r.axes.index("expert")
            e = spec[i] if i < len(spec) else None
            add("all-to-all", payload, set(sh.spec_axes(e)) - bmesh,
                2 * times)
    return {"coll_bytes": dict(coll_bytes), "coll_link_bytes": link,
            "coll_count": dict(coll_count)}


def roofline_terms(costs: dict, hw: dict) -> dict:
    """Per-device seconds per term (HLO shapes are already per-shard)."""
    compute_s = costs["flops"] / hw["peak_bf16_flops"]
    memory_s = costs["hbm_bytes"] / hw["hbm_bw"]
    coll_s = costs["coll_link_bytes"] / hw["ici_bw"]
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", coll_s)), key=lambda kv: kv[1])[0]
    bound = max(compute_s, memory_s, coll_s)
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": coll_s, "dominant": dominant,
            "step_lower_bound_s": bound}
