"""Dry-run: trace every (arch x shape) cell's step on the meta device, lay
it on the production meshes, and take the roofline's inputs from the
trace.

  python -m repro_torch.launch.dryrun --arch llama3.2-1b \
      --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all               # both meshes
  python -m repro_torch.launch.dryrun --all --mesh multi  # the pod axis

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers and
compiles each cell on 512 placeholder CPU devices and reads the compiled
artifact.  The port has no compiler: it runs the cell's real step once,
at the cell's global batch, on ``meta`` tensors (nothing is allocated and
no card is needed) under ``cost_analysis.CostTrace`` and
``sharding.sharding_ctx``, with the hand-written kernels' meta routes
standing in for them.  The trace is per step, for the whole batch; each
mesh's rules then split it:

* per-device compute is the traced total over the product of the mesh
  axes the rules use for "batch" (on the batch's leading dimension) and
  for the weights' heads / mlp / expert / ssm / vocab dimensions; axes
  neither uses replicate the compute.  gemma3-4b's 8 heads on a 16-wide
  "model" axis shard the query sequence over it instead (the JAX
  package's choice in its ``attention``): ``attention_split`` records
  which;
* per-device traffic is every tensor's bytes over its own split
  (``CostTrace(meshes=...)``): a weight at its shard after the gather
  over the batch axes, the optimizer's state at its shard, the batch and
  caches as their specs say, an activation as its inputs and the
  ``constrain`` sites split it (the residual stream is split over the
  batch alone);
* ``memory.argument_bytes`` is one device's shard of the parameters (or
  train state), the batch and the caches (``sharding.shard_bytes``), and
  ``memory.temp_bytes`` the most bytes of the tensors the step made that
  a device holds at once, each over its split;
* the collectives are ``cost_analysis.model_collectives``: a model from
  the specs and the recorded constraints, not a measurement.

``tests/test_torch_dryrun_mesh.py`` holds the split against the JAX
package's partitioner on a (2, 4) host mesh.

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>[__tag].json, with
the JAX package's record keys (``trace_s`` where it has ``lower_s`` and
``compile_s``); incremental, ``--force`` recomputes.  A failure is recorded
with an "error" field: such failures are bugs and must be fixed, not
skipped.  ``--save-ops`` writes the per-operation table beside the record
(where the JAX package's ``--save-hlo`` writes its HLO).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.dist import sharding as sh
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.models.model import model_specs
from repro_torch.train.optimizer import OptCfg
from repro_torch.train.step import (StepCfg, batch_specs, cache_specs_for,
                                    make_decode_step, make_prefill_step,
                                    make_train_step, train_state_specs)

ART_DIR = str(Path(__file__).resolve().parents[3] / "artifacts"
              / "dryrun_torch")

# weight dimensions whose mesh axes split the compute (with "batch")
SPLIT_AXES = ("heads", "kv_heads", "mlp", "expert", "expert_mlp",
              "ssm_inner", "ssm_heads", "conv_dim", "vocab")


def _float_params_to(dtype):
    def f(s: sh.TensorSpec):
        if s.dtype.is_floating_point:
            return sh.TensorSpec(s.shape, s.axes, dtype, s.init, s.scale)
        return s
    return f


def _is_expert(s: sh.TensorSpec) -> bool:
    """An expert leaf: "expert" its first axis after the stacked
    "layers"."""
    axes = s.axes[1:] if s.axes[:1] == ("layers",) else s.axes
    return axes[:1] == ("expert",)


def model_flops(cfg: ModelCfg, shape: ShapeCfg) -> float:
    """Global MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N =
    active: the JAX package's formula, with one repair.  It takes an
    expert leaf by "expert" as its first axis, but a stack's leaves lead
    with "layers", so it counts every expert as active (mixtral's and
    arctic's model FLOPs at their total parameters, 3.6x and 31x the
    active); the port looks past "layers" (``_is_expert``)."""
    leaves = sh._leaves(model_specs(cfg))
    total = sum(s.size for s in leaves)
    expert = sum(s.size for s in leaves if _is_expert(s))
    frac = 1.0
    for lc in cfg.stack.pattern + cfg.stack.tail:
        if lc.moe is not None:
            frac = lc.moe.top_k / lc.moe.n_experts
            break
    active = total - expert + expert * frac
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch  # decode: one token / sequence


def build_cell(cfg: ModelCfg, shape: ShapeCfg, step_cfg: StepCfg):
    """-> (step, the spec trees of its arguments, the weights' specs):
    serving parameters in bf16, the batch and caches from ``batch_specs``
    / ``cache_specs_for``, train states from ``train_state_specs``."""
    if shape.kind == "train":
        opt = OptCfg()
        st = train_state_specs(cfg, opt)
        return (make_train_step(cfg, opt, step_cfg),
                (st, batch_specs(cfg, shape)), st["params"])
    pspecs = sh.map_specs(_float_params_to(torch.bfloat16), model_specs(cfg))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, step_cfg),
                (pspecs, batch_specs(cfg, shape)), pspecs)
    return (make_decode_step(cfg, step_cfg),
            (pspecs, cache_specs_for(cfg, shape), batch_specs(cfg, shape)),
            pspecs)


def empty_args(spec_trees):
    """A meta tensor of every spec: nothing allocated."""
    return tuple(sh.map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), t)
        for t in spec_trees)


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _tensors(v)]
    return [tree] if torch.is_tensor(tree) else []


def arg_roles(kind: str, spec_trees, args):
    """(tensor, spec, role) of every argument of a cell's step: the
    parameters are "weight" in a serving step and "param" in a training
    one, the optimizer's moments and count "state", the batch and the
    caches "data" (``CostTrace.seed``)."""
    out = []

    def walk(spec, arg, role):
        if isinstance(spec, dict):
            for key in spec:
                walk(spec[key], arg[key], role)
        elif sh.is_spec(spec):
            out.append((arg, spec, role))

    for i, (spec, arg) in enumerate(zip(spec_trees, args)):
        if i == 0 and kind == "train":
            for key in spec:
                walk(spec[key], arg[key],
                     "param" if key == "params" else "state")
        else:
            walk(spec, arg, "weight" if i == 0 else "data")
    return out


def trace_step(step, args, spec_trees, kind: str, *, meshes, rules,
               device="meta", keep_ops: bool = False) -> dict:
    """Run ``step(*args)`` once under a ``CostTrace`` of ``device`` laid
    on ``meshes`` (the arguments seeded from ``spec_trees``) and a
    ``sharding_ctx`` of the first mesh -> {"trace": the CostTrace,
    "records": the constraints, "output_bytes", "alias_bytes": one
    device's bytes of the outputs' storages, and of those that are
    arguments' (a decode cache written in place), a mesh each,
    "trace_s"}."""
    t0 = time.time()
    arg_keys = {t.untyped_storage()._cdata for t in _tensors(args)}
    trace = ca.CostTrace(device=device, keep_ops=keep_ops, meshes=meshes,
                         rules=rules)
    for t, spec, role in arg_roles(kind, spec_trees, args):
        trace.seed(t, spec, role)
    with sh.sharding_ctx(meshes[0], rules, observer=trace) as records, \
            trace:
        out = step(*args)
    seen = set()
    out_bytes, alias = [0.0] * len(meshes), [0.0] * len(meshes)
    for t in _tensors(out):
        st = t.untyped_storage()
        if st._cdata in seen:
            continue
        seen.add(st._cdata)
        for j, (b, m) in enumerate(trace.split_of(t)):
            out_bytes[j] += st.nbytes() / (b * m)
            if st._cdata in arg_keys:
                alias[j] += st.nbytes() / (b * m)
    del out
    return {"trace": trace, "records": records, "output_bytes": out_bytes,
            "alias_bytes": alias, "trace_s": time.time() - t0}


def split_axes(weights, shape: ShapeCfg, mesh, rules) -> tuple:
    """(batch axes, weight axes): the mesh axes the rules give the batch's
    leading dimension, and those they give the weights' ``SPLIT_AXES``
    dimensions."""
    bps = sh.resolve_pspec((shape.global_batch,), ("batch",), mesh, rules)
    batch = sh.spec_axes(bps[0]) if bps else ()
    model = set()
    for s in sh._leaves(weights):
        ps = sh.resolve_pspec(s.shape, s.axes, mesh, rules)
        for name, entry in zip(s.axes, ps):
            if name in SPLIT_AXES:
                model.update(sh.spec_axes(entry))
    return tuple(batch), tuple(sorted(model - set(batch)))


def lay_out(traced: dict, spec_trees, weights, cfg: ModelCfg,
            shape: ShapeCfg, mesh, rules, index: int = 0) -> dict:
    """A traced step on ``mesh``, the trace's ``index``-th -> the
    record's fields: per-device costs, memory, roofline and model FLOPs
    (see the module doc)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_dev = math.prod(mesh.devices.shape)
    trace = traced["trace"]
    batch_axes, model_axes = split_axes(weights, shape, mesh, rules)
    div = math.prod(sizes[a] for a in batch_axes + model_axes)
    costs = {"flops": trace.flops / div, "dot_flops": trace.dot_flops / div,
             "hbm_bytes": trace.dev_bytes[index],
             "peak_live_bytes": trace.dev_peak_live_bytes[index],
             **ca.model_collectives(weights, traced["records"], mesh, rules,
                                    train=shape.kind == "train",
                                    batch_axes=batch_axes)}
    q_axes = [r.axes for r in traced["records"]
              if len(r.axes) == 4 and r.axes[2] == "act_heads"]
    rec = {
        "split": {"batch_axes": list(batch_axes),
                  "model_axes": list(model_axes), "divisor": div},
        "attention_split": (None if not q_axes else "sequence"
                            if q_axes[0][1] == "act_seq_tp" else "heads"),
        "memory": {
            "argument_bytes": sum(sh.shard_bytes(t, mesh, rules)
                                  for t in spec_trees),
            "output_bytes": traced["output_bytes"][index],
            "temp_bytes": trace.dev_peak_live_bytes[index],
            "alias_bytes": traced["alias_bytes"][index]},
        "traced": trace.to_dict(),
        "constraints": len(traced["records"]),
        "hlo": costs,
        "roofline": ca.roofline_terms(costs, HW),
    }
    mf = model_flops(cfg, shape)
    rec["model_flops"] = mf
    hw_total = costs["flops"] * n_dev
    rec["model_over_hlo_flops"] = mf / hw_total if hw_total else None
    bound = rec["roofline"]["step_lower_bound_s"]
    rec["roofline_fraction"] = (
        (mf / n_dev / HW["peak_bf16_flops"]) / bound if bound > 0 else None)
    return rec


def run_cells(arch: str, shape_name: str, mesh_kinds, *,
              step_cfg: StepCfg | None = None, rules=None, tag: str = "",
              save_ops: bool = False, out_dir: str = ART_DIR) -> list:
    """Trace (arch, shape) once and write one record per mesh kind
    ("single", "multi")."""
    step_cfg = step_cfg or StepCfg()
    rules = rules or sh.DEFAULT_RULES
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    meshes = {m: make_production_mesh(multi_pod=(m == "multi"))
              for m in mesh_kinds}
    t0 = time.time()
    recs = {m: {"arch": arch, "shape": shape_name, "mesh": m,
                "devices": int(meshes[m].devices.size), "tag": tag,
                "step_cfg": {"remat": step_cfg.remat, "loss": step_cfg.loss},
                "rules": [k for k, v in sh.RULE_PRESETS.items()
                          if v is rules][:1] or ["custom"]}
            for m in mesh_kinds}
    try:
        step, spec_trees, weights = build_cell(cfg, shape, step_cfg)
        traced = trace_step(step, empty_args(spec_trees), spec_trees,
                            shape.kind, meshes=list(meshes.values()),
                            rules=rules, keep_ops=save_ops)
        for j, (m, mesh) in enumerate(meshes.items()):
            recs[m]["trace_s"] = traced["trace_s"]
            recs[m].update(lay_out(traced, spec_trees, weights, cfg, shape,
                                   mesh, rules, j))
        if save_ops:
            os.makedirs(out_dir, exist_ok=True)
            table = traced["trace"].op_table
            with open(os.path.join(out_dir, _name(arch, shape_name, "ops",
                                                  tag) + ".json"), "w") as f:
                json.dump({"ops": dict(sorted(
                    table.items(), key=lambda kv: -kv[1][1])),
                    "kernels": traced["trace"].kernels,
                    "columns": ["calls", "flops", "bytes"]}, f, indent=1)
    except Exception as e:  # noqa: BLE001 - record and surface
        for rec in recs.values():
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"FAILED {arch} {shape_name}: {type(e).__name__}: {e}")
    total = time.time() - t0
    os.makedirs(out_dir, exist_ok=True)
    for m, rec in recs.items():
        rec["total_s"] = total
        path = os.path.join(out_dir, _name(arch, shape_name, m, tag) + ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1, default=str)
        status = "ERROR" if "error" in rec else "ok"
        print(f"[{status}] {arch} {shape_name} {m} tag={tag!r} "
              f"({total:.1f}s) -> {path}", flush=True)
    return [recs[m] for m in mesh_kinds]


def run_cell(arch: str, shape_name: str, mesh_kind: str, **kw) -> dict:
    return run_cells(arch, shape_name, [mesh_kind], **kw)[0]


def _name(arch, shape, mesh, tag):
    n = f"{arch}__{shape}__{mesh}"
    return n + (f"__{tag}" if tag else "")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--loss", default="plain", choices=["plain", "chunked"])
    ap.add_argument("--rules", default="baseline",
                    choices=sorted(sh.RULE_PRESETS))
    ap.add_argument("--save-ops", action="store_true")
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args()

    step_cfg = StepCfg(remat=args.remat, loss=args.loss)
    rules = sh.RULE_PRESETS[args.rules]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.all:
        todo = [(arch, s) for arch in ARCHS for s in SHAPES
                if s not in get_config(arch).skip_shapes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]

    t0 = time.time()
    done = failed = 0
    for arch, s in todo:
        left = []
        for m in meshes:
            path = os.path.join(args.out,
                                _name(arch, s, m, args.tag) + ".json")
            if not args.force and os.path.exists(path):
                with open(path) as f:
                    if "error" not in json.load(f):
                        continue
            left.append(m)
        if not left:
            continue
        recs = run_cells(arch, s, left, step_cfg=step_cfg, rules=rules,
                         tag=args.tag, save_ops=args.save_ops,
                         out_dir=args.out)
        done += len(recs)
        failed += sum("error" in r for r in recs)
    print(f"dry-run complete: {done} cells run, {failed} failures, "
          f"{time.time() - t0:.1f}s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
