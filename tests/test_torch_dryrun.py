"""The port's dry-run (``repro_torch.launch.dryrun``, ``cost_analysis``,
``dryrun_hail``, the full resolver of ``dist/sharding.py``) against the
JAX package's (``repro.launch.dryrun``, ``hlo_analysis``,
``repro.dist.sharding``).

* ``resolve_pspec`` equals the JAX package's exactly for every leaf of
  every arch's parameter, train-state, decode-cache and batch specs,
  under all three presets, on both production meshes (duck-typed, as
  ``tests/test_sharding.py``'s);
* ``model_flops`` equals the JAX package's for every cell of ``cells()``,
  and ``roofline_terms`` its on ``test_roofline_terms_and_dominance``'s
  dict;
* the meta trace's dot FLOPs equal ``analyze_hlo_text`` of the JAX
  package's one-device compile of the same reduced step (B = 2, T = 16,
  both packages on their plain routes, the train step at remat "none"):
  exactly for llama3.2-1b and mixtral-8x22b (prefill and train) and
  gemma3-4b's prefill; falcon-mamba-7b's prefill within 3%, because the
  JAX package's Mamba1 scan makes products (``einsum``s of delta x and B,
  and of h and C) that the port's plain scan computes as a multiply and
  a sum, which count as elementwise work;
* ``CostTrace``'s dot FLOPs equal ``FlopCounterMode``'s on real CPU
  tensors;
* the kernels' meta routes give the CPU route's shapes and dtypes, and
  the flash wrapper notes 4 flops a head dim and unmasked pair, the pairs
  counted here by brute force;
* the collective model on a hand-worked spec tree and a (2, 4) mesh;
* ``run_cell`` and ``dryrun_hail.run`` complete on meta with the JAX
  package's keys.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` for 512 host
devices; jax's backend is initialised first and the variable restored, so
nothing later in this worker sees it.
"""
import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.dist import sharding as jsh
from repro.kernels import ops as jops
from repro.launch import hlo_analysis as ha
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import ARCHS, SHAPES, cells, get_config, get_reduced
from repro_torch.configs.base import ShapeCfg
from repro_torch.dist import sharding as sh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import selective_scan as ss
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun as dr
from repro_torch.launch import dryrun_hail
from repro_torch.models import model as pmodel
from repro_torch.train import step as pstep
from repro_torch.train.optimizer import OptCfg


def _jax_dryrun():
    """``repro.launch.dryrun`` imported with jax's backend already up and
    ``XLA_FLAGS`` as it was."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdr
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return jdr


@dataclasses.dataclass
class FakeMesh:
    axis_names: tuple
    devices: np.ndarray


SINGLE = FakeMesh(("data", "model"), np.zeros((16, 16)))
MULTI = FakeMesh(("pod", "data", "model"), np.zeros((2, 16, 16)))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _spec_trees(arch):
    """(name, the JAX package's tree, the port's) of every spec tree the
    dry-run resolves for ``arch``."""
    jcfg, pcfg = jax_config(arch), get_config(arch)
    trees = [("params", jstep.model_mod.model_specs(jcfg),
              pmodel.model_specs(pcfg)),
             ("train_state",
              jstep.train_state_specs(jcfg, jopt.OptCfg()),
              pstep.train_state_specs(pcfg, OptCfg()))]
    from repro.configs import SHAPES as JSHAPES
    for name, shape in SHAPES.items():
        if name in pcfg.skip_shapes:
            continue
        trees.append((f"batch {name}",
                      jstep.batch_specs(jcfg, JSHAPES[name]),
                      pstep.batch_specs(pcfg, shape)))
        if shape.kind == "decode":
            trees.append((f"cache {name}",
                          jstep.cache_specs_for(jcfg, JSHAPES[name]),
                          pstep.cache_specs_for(pcfg, shape)))
    return trees


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_resolve_pspec_matches_reference(arch):
    n = 0
    for name, jtree, ptree in _spec_trees(arch):
        jflat, pflat = _flat(jtree), _flat(ptree)
        assert sorted(jflat) == sorted(pflat), name
        for path, js in jflat.items():
            ps = pflat[path]
            assert (tuple(js.shape), tuple(js.axes)) == (ps.shape, ps.axes)
            for preset in jsh.RULE_PRESETS:
                for mesh in (SINGLE, MULTI):
                    want = tuple(jsh.resolve_pspec(
                        js.shape, js.axes, mesh, jsh.RULE_PRESETS[preset]))
                    got = sh.resolve_pspec(ps.shape, ps.axes, mesh,
                                           sh.RULE_PRESETS[preset])
                    assert got == want, (name, path, preset)
                    n += 1
    assert n > 100
    assert sh.RULE_PRESETS.keys() == jsh.RULE_PRESETS.keys()


def test_presets_differ_from_baseline_on_production_mesh():
    witnesses = [((4096, 4096), ("embed", "mlp")),
                 ((262144, 2560), ("vocab", "embed")),
                 ((256, 4096), ("batch", "seq"))]
    for name, rules in sh.RULE_PRESETS.items():
        if name == "baseline":
            continue
        assert any(
            sh.resolve_pspec(shape, axes, SINGLE, rules)
            != sh.resolve_pspec(shape, axes, SINGLE) for shape, axes in
            witnesses), f"preset {name!r} is a no-op on the production mesh"
    assert sh.resolve_pspec((4096, 4096), ("embed", "mlp"), SINGLE,
                            sh.RULE_PRESETS["fsdp"]) == (("data", "model"),)


def test_shard_shape_and_constrain_outside_and_inside_a_context():
    spec = sh.tspec((256, 32768, 8, 128),
                    ("batch", "kv_seq", "act_kv_heads", "head_dim"),
                    torch.bfloat16)
    assert sh.shard_shape(spec, SINGLE) == (16, 2048, 8, 128)
    assert sh.shard_bytes({"a": spec}, MULTI) == 8 * 2048 * 8 * 128 * 2
    x = torch.zeros(4, 6)
    assert sh.constrain(x, ("batch", "seq")) is x
    assert sh.ctx_axis_size("model") == 1
    with sh.sharding_ctx(SINGLE) as records:
        assert sh.ctx_axis_size("model") == 16
        assert sh.constrain(x, ("batch", "act_mlp")) is x
    assert records == [sh.Constraint(("batch", "act_mlp"), (4, 6),
                                     torch.float32, (), None)]


def test_cost_trace_splits_weights_at_their_gathered_shard():
    """One product x @ w on a (2, 4) mesh, by hand: the batch-split x is
    read at a half, the weight (embed on "data", mlp on "model") at its
    quarter after the gather over "data", the product's output at an
    eighth; ``constrain`` pins an activation's split, and the bytes
    already written of it follow the pin."""
    mesh = FakeMesh(("data", "model"), np.zeros((2, 4)))
    wspec = sh.tspec((16, 32), ("embed", "mlp"), torch.bfloat16)
    x = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((16, 32), dtype=torch.bfloat16, device="meta")
    trace = ca.CostTrace(meshes=[mesh])
    trace.seed(x, sh.tspec((8, 16), ("batch", "embed"), torch.bfloat16),
               "data")
    trace.seed(w, wspec, "weight")
    with sh.sharding_ctx(mesh, observer=trace) as records, trace:
        h = x @ w
        y = h @ w.T
        y = sh.constrain(y, ("batch", "act_embed"), weight=w.T)
    x_b, w_b, h_b, y_b = 8 * 16 * 2, 16 * 32 * 2, 8 * 32 * 2, 8 * 16 * 2
    assert trace.hbm_bytes == x_b + w_b + h_b + h_b + w_b + y_b
    assert trace.dev_bytes == [x_b / 2 + w_b / 4 + h_b / 8
                               + h_b / 8 + w_b / 4 + y_b / 2]
    assert trace.split_of(y) == ((2, 1),) and trace.split_of(h) == ((2, 4),)
    # the record names the weight as the product read it: mlp contracted
    assert records[0].weight == sh.tspec((16, 32), ("embed", "mlp"),
                                         torch.bfloat16)
    assert ca.contracted_dims(records[0].weight.axes, records[0].axes) == [1]
    del h, y
    assert trace.dev_peak_live_bytes == [h_b / 8 + y_b / 2]


def test_cost_trace_training_reads_parameters_gathered_and_updates_shards():
    """A training state's parameter: the copy the step differentiates
    (``detach``) is read at its gathered split, the optimizer's update at
    its shard."""
    mesh = FakeMesh(("data", "model"), np.zeros((2, 4)))
    spec = sh.tspec((16, 32), ("embed", "mlp"))
    p, m = (torch.empty((16, 32), device="meta") for _ in range(2))
    trace = ca.CostTrace(meshes=[mesh])
    trace.seed(p, spec, "param")
    trace.seed(m, spec, "state")
    n = 16 * 32 * 4
    with trace:
        w = p.detach().to(torch.bfloat16)          # read at 1/4, written
        new_m = m * 0.9 + p                        # the update: at 1/8
    assert trace.split_of(w) == ((1, 4),)
    assert trace.split_of(new_m) == ((2, 4),)
    assert trace.dev_bytes == [n / 4 + n / 2 / 4 + 2 * n / 8 + 3 * n / 8]


MOE = ("arctic-480b", "mixtral-8x22b")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_match_reference(arch):
    """Equal to the JAX package's for every cell, but for the MoE archs:
    there the JAX package counts every expert as active (it takes an
    expert leaf by "expert" as its first axis, and a stack's leaves lead
    with "layers"), and the port's differs from it by exactly the
    inactive experts' share."""
    jdr = _jax_dryrun()
    from repro.configs import SHAPES as JSHAPES
    jcfg = jax_config(arch)
    leaves = jsh._leaves(jstep.model_mod.model_specs(jcfg))
    total = sum(s.size for s in leaves)
    expert = sum(s.size for s in leaves if s.axes[:2] == ("layers",
                                                           "expert"))
    frac = next((lc.moe.top_k / lc.moe.n_experts
                 for lc in jcfg.stack.pattern if lc.moe is not None), 1.0)
    assert (expert > 0) == (arch in MOE)
    assert not any(s.axes[:1] == ("expert",) for s in leaves)
    n = 0
    for a, shape in cells():
        if a != arch:
            continue
        js = JSHAPES[shape]
        tokens = js.global_batch * (js.seq_len if js.kind != "decode" else 1)
        per_param = (6.0 if js.kind == "train" else 2.0) * tokens
        want = jdr.model_flops(jcfg, js)
        assert want == per_param * total         # every parameter active
        got = dr.model_flops(get_config(arch), SHAPES[shape])
        if arch not in MOE:
            assert got == want
        assert got == pytest.approx(want - per_param * expert * (1 - frac),
                                    rel=1e-12)
        n += 1
    assert n >= 3


def test_roofline_terms_match_reference():
    hw = {"peak_bf16_flops": 1e12, "hbm_bw": 1e9, "ici_bw": 1e9}
    costs = {"flops": 1e12, "hbm_bytes": 5e9, "coll_link_bytes": 1e9}
    assert ca.roofline_terms(costs, hw) == ha.roofline_terms(costs, hw)
    assert ca.roofline_terms(costs, hw)["dominant"] == "memory"


# ---------------------------------------------------------------------------
# dot FLOPs: the meta trace against the JAX package's HLO analysis
# ---------------------------------------------------------------------------

B, T = 2, 16


def _jax_dot_flops(arch, kind):
    cfg = jax_reduced(arch)
    jshape = jstep.ShapeCfg("cut", T, B, kind)

    def structs(tree):
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype),
                            tree, is_leaf=jsh.is_spec)
    if kind == "train":
        fn = jstep.make_train_step(cfg, jopt.OptCfg(),
                                   jstep.StepCfg(remat="none"))
        args = (structs(jstep.train_state_specs(cfg, jopt.OptCfg())),
                structs(jstep.batch_specs(cfg, jshape)))
    else:
        fn = jstep.make_prefill_step(cfg)
        params = jsh.map_specs(
            lambda s: jsh.TensorSpec(s.shape, s.axes, jnp.bfloat16, s.init,
                                     s.scale)
            if jnp.issubdtype(s.dtype, jnp.floating) else s,
            jstep.model_mod.model_specs(cfg))
        args = (structs(params), structs(jstep.batch_specs(cfg, jshape)))
    jops.use_kernels(False)
    try:
        txt = jax.jit(fn).lower(*args).compile().as_text()
    finally:
        jops.use_kernels(True)
    return ha.analyze_hlo_text(txt)["dot_flops"]


def _port_dot_flops(arch, kind):
    cfg = get_reduced(arch)
    step, trees, _ = dr.build_cell(cfg, ShapeCfg("cut", T, B, kind),
                                   pstep.StepCfg(remat="none"))
    ops.use_kernels(False)
    try:
        traced = dr.trace_step(step, dr.empty_args(trees), trees, kind,
                               meshes=[SINGLE], rules=sh.DEFAULT_RULES)
    finally:
        ops.use_kernels(True)
    return traced["trace"].dot_flops


@pytest.mark.parametrize("arch,kind", [
    ("llama3.2-1b", "prefill"), ("llama3.2-1b", "train"),
    ("mixtral-8x22b", "prefill"), ("mixtral-8x22b", "train"),
    ("gemma3-4b", "prefill")])
def test_dot_flops_equal_reference_hlo(arch, kind):
    assert _port_dot_flops(arch, kind) == _jax_dot_flops(arch, kind)


def test_mamba1_dot_flops_within_3_percent():
    got = _port_dot_flops("falcon-mamba-7b", "prefill")
    want = _jax_dot_flops("falcon-mamba-7b", "prefill")
    assert 0.97 <= got / want <= 1.0, got / want


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_cost_trace_dot_flops_equal_flop_counter(kind):
    cfg = get_reduced("llama3.2-1b")
    step, trees, _ = dr.build_cell(cfg, ShapeCfg("cut", T, B, kind),
                                   pstep.StepCfg(remat="none"))
    gen = torch.Generator().manual_seed(0)
    args = tuple(sh.map_specs(
        lambda s: (torch.randn(s.shape, generator=gen).to(s.dtype)
                   if s.dtype.is_floating_point else
                   torch.randint(0, cfg.vocab, s.shape, generator=gen,
                                 dtype=s.dtype)), t) for t in trees)
    ops.use_kernels(False)
    try:
        traced = dr.trace_step(step, args, trees, kind, meshes=[SINGLE],
                               rules=sh.DEFAULT_RULES, device="cpu")
        with FlopCounterMode(display=False) as counter:
            step(*args)
    finally:
        ops.use_kernels(True)
    assert traced["trace"].dot_flops == counter.get_total_flops() > 0


# ---------------------------------------------------------------------------
# the kernels' meta routes
# ---------------------------------------------------------------------------


def _like(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert [(tuple(g.shape), g.dtype, g.device.type) for g in got] == \
        [(tuple(w.shape), w.dtype, "meta") for w in want]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_meta_route_shapes_and_noted_flops(dtype):
    b, t, s, h, kv, d, window = 2, 11, 11, 4, 2, 16, 5
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype)
               for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d)))
    do = torch.randn(q.shape, generator=gen).to(dtype)
    meta = [x.to("meta") for x in (q, k, v, do)]
    kw = dict(causal=True, window=window)
    _like(fa.flash_attention(*meta[:3], **kw), fa.flash_attention(q, k, v,
                                                                 **kw))
    out, lse, o32 = fa.flash_attention_fwd(q, k, v, **kw)
    _like(fa.flash_attention_fwd(*meta[:3], **kw), (out, lse, o32))
    m_out = fa.flash_attention_fwd(*meta[:3], **kw)
    _like(fa.flash_attention_bwd(*meta[:3], m_out[2], m_out[1], meta[3],
                                 **kw),
          fa.flash_attention_bwd(q, k, v, o32, lse, do, **kw))
    # brute force: unmasked (query, key) pairs of the causal window
    qi, kj = np.meshgrid(np.arange(t), np.arange(s), indexing="ij")
    pairs = int(((kj <= qi) & (kj > qi - window)).sum())
    with ca.CostTrace() as trace:
        fa.flash_attention(*meta[:3], **kw)
        fa.flash_attention_bwd(*meta[:3], m_out[2], m_out[1], meta[3], **kw)
    assert trace.kernels["flash_attention"]["flops"] == 4 * b * h * d * pairs
    assert trace.kernels["flash_attention_bwd"]["flops"] == \
        10 * b * h * d * pairs
    assert trace.op_counts == {}          # nothing counted inside
    # the forward's output is dropped at once; then dq, dk and dv live
    assert trace.peak_live_bytes == (q.numel() + 2 * k.numel()) \
        * q.element_size()


def test_scan_meta_route_shapes():
    b, t, d, n = 2, 9, 6, 4
    gen = torch.Generator().manual_seed(2)
    delta = torch.rand((b, t, d), generator=gen)
    x, bm, cm = (torch.randn(shape, generator=gen)
                 for shape in ((b, t, d), (b, t, n), (b, t, n)))
    a = -torch.rand((d, n), generator=gen)
    dy, dh = torch.randn((b, t, d), generator=gen), torch.randn((b, d, n))
    cpu = (delta, x, bm, cm, a)
    meta = [y.to("meta") for y in cpu]
    _like(ss.selective_scan(*meta), ss.selective_scan(*cpu))
    _like(ss.selective_scan_bwd(*meta, dy.to("meta"), dh.to("meta")),
          ss.selective_scan_bwd(*cpu, dy, dh))
    # the training forward: y, h_final and the checkpoints, one at the
    # start of every CKPT_STEPS steps, which the backward takes
    n_int = -(-t // ss.CKPT_STEPS)
    train_meta = ss.selective_scan_train(*meta)
    train_cpu = ss.selective_scan_train(*cpu)
    _like(train_meta, train_cpu)
    assert train_meta[2].shape == (b, n_int, d, n)
    _like(ss.selective_scan_bwd(*meta, dy.to("meta"), dh.to("meta"),
                                train_meta[2]),
          ss.selective_scan_bwd(*cpu, dy, dh, train_cpu[2]))
    with ca.CostTrace() as trace:
        ss.selective_scan(*meta)
        ss.selective_scan_train(*meta)
    assert trace.kernels["selective_scan"]["flops"] == 7 * b * t * d * n
    assert trace.kernels["selective_scan"]["dot_flops"] == 0
    assert trace.kernels["selective_scan_train"]["flops"] == \
        7 * b * t * d * n
    assert trace.kernels["selective_scan_train"]["bytes"] == \
        trace.kernels["selective_scan"]["bytes"] + 4 * b * n_int * d * n


# ---------------------------------------------------------------------------
# the collective model
# ---------------------------------------------------------------------------


def test_synthetic_collectives():
    mesh = FakeMesh(("data", "model"), np.zeros((2, 4)))
    bf16 = torch.bfloat16
    weights = {"w1": sh.tspec((8, 16), ("embed", "mlp")),
               "w2": sh.tspec((16, 8), ("mlp", "embed")),
               "w3": sh.tspec((16,), ("ssm_state",))}
    records = [
        # after w2's product, its "mlp" dimension (model) contracted
        sh.Constraint(("batch", "seq", "act_embed"), (4, 8, 8), bf16, (),
                      sh.tspec((16, 8), ("mlp", "embed"))),
        # an MoE dispatch buffer, experts over model
        sh.Constraint(("moe_group", "expert", "moe_cap", "act_embed"),
                      (2, 8, 4, 8), bf16, (), None),
        # after a product over embed (data: the weight is gathered first)
        sh.Constraint(("batch", "seq", "act_mlp"), (4, 8, 16), bf16, (),
                      sh.tspec((8, 16), ("embed", "mlp")))]
    got = ca.model_collectives(weights, records, mesh, sh.DEFAULT_RULES,
                               train=True, batch_axes=("data",))
    # w1, w2: a (4, 4) float32 shard of 64 B, 128 B gathered over data
    # (g = 2): all-gathered twice (forward and backward) and
    # reduce-scattered once, 128 B each, link 64 each; w3 replicated: its
    # 64 B gradient all-reduced over data, link 64; the activation: 512 B
    # over data = 256 B all-reduced over model (g = 4), twice, link
    # 2 * 3/4 * 256 = 384 each; the dispatch buffer: 1,024 B over model
    # and data = 128 B, two all-to-alls twice, link 3/4 * 128 = 96 each
    assert got["coll_bytes"] == {"all-gather": 512, "reduce-scatter": 256,
                                 "all-reduce": 64 + 2 * 256,
                                 "all-to-all": 4 * 128}
    assert got["coll_count"] == {"all-gather": 4, "reduce-scatter": 2,
                                 "all-reduce": 3, "all-to-all": 4}
    assert got["coll_link_bytes"] == pytest.approx(
        4 * 64 + 2 * 64 + 64 + 2 * 384 + 4 * 96)
    serve = ca.model_collectives(weights, records, mesh, sh.DEFAULT_RULES,
                                 train=False, batch_axes=("data",))
    assert serve["coll_count"] == {"all-gather": 2, "all-reduce": 1,
                                   "all-to-all": 2}


# ---------------------------------------------------------------------------
# whole cells on meta
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "devices", "tag", "step_cfg", "memory",
            "hlo", "roofline", "model_flops", "model_over_hlo_flops",
            "roofline_fraction", "total_s"}


def test_run_cell_llama_train_on_meta(tmp_path):
    rec = dr.run_cell("llama3.2-1b", "train_4k", "single",
                      out_dir=str(tmp_path))
    assert "error" not in rec, rec.get("traceback")
    assert REF_KEYS <= rec.keys() and "trace_s" in rec
    assert (tmp_path / "llama3.2-1b__train_4k__single.json").exists()
    assert rec["devices"] == 256 and rec["split"]["divisor"] == 256
    assert {"argument_bytes", "temp_bytes"} <= rec["memory"].keys()
    for key in ("flops", "dot_flops", "hbm_bytes", "coll_bytes",
                "coll_link_bytes", "coll_count"):
        assert key in rec["hlo"]
    # remat "full": each layer's flash forward twice, its backward once
    assert rec["traced"]["kernels"]["flash_attention"]["calls"] == 32
    assert rec["traced"]["kernels"]["flash_attention_bwd"]["calls"] == 16
    assert rec["model_flops"] <= 1.05 * rec["traced"]["flops"]
    assert 0 < rec["roofline"]["step_lower_bound_s"] < math.inf


def test_dryrun_hail_on_meta(tmp_path):
    for multi in (False, True):
        rec = dryrun_hail.run(multi, out_dir=str(tmp_path))
        assert {"kind", "multi_pod", "devices", "blocks", "rows",
                "temp_bytes", "all_to_all_ops", "trace_s"} <= rec.keys()
        assert rec["devices"] == (512 if multi else 256)
        assert rec["modelled"] == ["all_to_all_ops", "shuffle_bytes"]
        # each of the 16 "data" slots combines its sums and its counts
        assert rec["combiner_ops"] == 2 * 16 and rec["temp_bytes"] > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "hail_mapreduce__multi.json", "hail_mapreduce__single.json"]


def test_decode_positions_from_a_tensor_equal_an_int():
    for mrope in (False, True):
        got = pmodel.decode_positions(torch.tensor(7, dtype=torch.int32), 3,
                                      "cpu", mrope)
        want = pmodel.decode_positions(7, 3, "cpu", mrope)
        assert torch.equal(got, want)
    meta = pmodel.decode_positions(torch.empty((), dtype=torch.int32,
                                               device="meta"), 3, "meta")
    assert meta.shape == (3, 1) and meta.device.type == "meta"
