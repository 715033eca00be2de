"""The dry-run's per-device split against the JAX package's partitioner.

``repro_torch.launch.dryrun`` traces a step once and lays it on a mesh:
compute over the batch and model axes, each tensor's bytes over its own
split (a weight at its shard after the gather over the batch axes, an
activation as its inputs and the ``constrain`` sites split it), and the
collectives by ``cost_analysis.model_collectives``.  Here reduced
llama3.2-1b's decode and training steps (B = 8, T = 64, plain routes, the
training step at remat "none") are laid on a (2, 4) ("data", "model") mesh
and held against ``analyze_hlo_text`` of the JAX package's step compiled
on 8 forced host devices (in a subprocess: the device count is fixed when
jax starts) and on one:

* dot FLOPs on one device equal exactly; per device on (2, 4) the port's
  are 0.85-1.0 of XLA's (1.0 in decode, 0.90 in training, where XLA
  leaves some products unsplit);
* the bytes split (one device's bytes on (1, 1) over those on (2, 4))
  within 0.8-1.5 of XLA's (read: 0.98 in decode, 1.34 in training).
  Dividing every byte by the 8 devices, as the dry-run once did, reads
  1.66 and 2.01 and fails: weights are read gathered, at a quarter;
* link bytes of the collectives 0.25-1.0 of XLA's (read: 0.48 and 0.37):
  XLA's CPU backend gathers float32 copies of bfloat16 weights,
  all-reduces the gradients where the model reduce-scatters them, and
  moves the embedding lookup; the model counts none of these.  The
  query heads' gather (``model_collectives`` item 5: the 2 KV heads
  stay whole on the 4-wide "model" axis) is counted, in bfloat16.

A weight's gradient is written at the weight's split as the product
read it (``CostTrace``'s "G" class), not at the activations' widest, and
then held at the parameter's split (the reduce-scatter): the training
split read 1.35 before, 1.34 now (1.32 with the gradient held at the
gathered split, which over-counts arctic-480b's train_4k peak 2.5x).
The gradient's product is known by an input storage that met the weight
in a product, not by its shape alone, which square weights of two splits
share (``test_square_weight_gradients_are_told_apart``).

Reduced gemma3-4b (H = 4, KV = 2, windows of 8; local, local, global
twice and a local tail) and mixtral-8x22b (4 experts, top 2) are held
the same way (``test_gemma3_and_mixtral_against_the_partitioner``), at
the limits of ``LIMITS``, readings beside them:

* one device's dot FLOPs: gemma3's training step counts 1.10 of XLA's
  (the JAX package's banded local attention, ``_sdpa_banded``, scores
  2W keys a query, the port's plain route every key), mixtral's 1.03
  (the port's experts run each group's whole capacity, dropped slots
  included, as XLA's do; the router and the combine differ); decode
  equal;
* per device on (2, 4): gemma3 1.0 and 0.97, mixtral 1.0 and 0.84 (XLA
  leaves more of the training step's products unsplit);
* the bytes split: gemma3 1.05 and 1.55, mixtral 0.94 and 1.92.  XLA
  keeps mixtral's MoE dispatch groups whole on every "data" shard (its
  rules name no "moe_group"), so its per-device expert traffic splits
  less than the port's, which splits the groups with the batch: that
  explains mixtral's training reading of 1.92;
* link bytes: gemma3 0.48 and 0.37, mixtral 0.79 and 0.41.  gemma3's
  training floor of 0.35 holds the K/V item: without it the reading
  is 0.32.

``python tests/test_torch_dryrun_mesh.py`` prints these readings for
llama3.2-1b, gemma3-4b and mixtral-8x22b, decode, prefill and training, on the
(2, 4) and (4, 2) meshes.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import get_reduced
from repro_torch.configs.base import ShapeCfg
from repro_torch.dist import sharding as sh
from repro_torch.kernels import ops
from repro_torch.launch import dryrun as dr
from repro_torch.train.step import StepCfg

ROOT = Path(__file__).resolve().parents[1]
B, T = 8, 64
MESHES = ((1, 1), (2, 4))
KINDS = ("decode", "train")
ARCH = "llama3.2-1b"

# the JAX package's side, run with 8 host devices
_JAX_SIDE = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.configs import get_reduced
from repro.dist import sharding as sh
from repro.kernels import ops
from repro.launch import hlo_analysis as ha
from repro.launch.mesh import make_mesh
from repro.train import step as st
from repro.train.optimizer import OptCfg

ARCH, B, T, MESHES, KINDS = json.loads(sys.argv[1])
cfg = get_reduced(ARCH)
rules = sh.DEFAULT_RULES
ops.use_kernels(False)
out = {}
for kind in KINDS:
    shape = st.ShapeCfg("cut", T, B, kind)
    for dims in MESHES:
        mesh = make_mesh(tuple(dims), ("data", "model"))
        def structs(tree):
            return sh.shape_structs(tree, mesh, rules)
        if kind == "train":
            spec = st.train_state_specs(cfg, OptCfg())
            fn = st.make_train_step(cfg, OptCfg(), st.StepCfg(remat="none"),
                                    mesh, rules)
            args = (structs(spec), structs(st.batch_specs(cfg, shape)))
            outs, donate = (sh.shardings(spec, mesh, rules), None), (0,)
        else:
            params = sh.map_specs(
                lambda s: sh.TensorSpec(s.shape, s.axes, jnp.bfloat16,
                                        s.init, s.scale)
                if jnp.issubdtype(s.dtype, jnp.floating) else s,
                st.model_mod.model_specs(cfg))
            batch = structs(st.batch_specs(cfg, shape))
            if kind == "prefill":
                fn = st.make_prefill_step(cfg, st.StepCfg(), mesh, rules)
                args, outs, donate = (structs(params), batch), None, ()
            else:
                caches = st.cache_specs_for(cfg, shape)
                fn = st.make_decode_step(cfg, st.StepCfg(), mesh, rules)
                args = (structs(params), structs(caches), batch)
                outs = (None, sh.shardings(caches, mesh, rules))
                donate = (1,)
        with mesh:
            txt = jax.jit(fn, out_shardings=outs,
                          donate_argnums=donate).lower(*args).compile(
                          ).as_text()
        out[f"{kind} {dims[0]}x{dims[1]}"] = ha.analyze_hlo_text(txt)
print(json.dumps(out))
"""


@dataclasses.dataclass
class FakeMesh:
    axis_names: tuple
    devices: np.ndarray


def _xla(arch, meshes, kinds) -> dict:
    """``analyze_hlo_text`` of the JAX package's steps, "<kind> <d>x<m>"
    -> its costs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE,
         json.dumps([arch, B, T, meshes, kinds])],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def xla():
    return _xla(ARCH, MESHES, KINDS)


def _port(kind, arch=ARCH, mesh_dims=MESHES):
    cfg = get_reduced(arch)
    shape = ShapeCfg("cut", T, B, kind)
    step, trees, weights = dr.build_cell(cfg, shape, StepCfg(remat="none"))
    meshes = [FakeMesh(("data", "model"), np.zeros(d)) for d in mesh_dims]
    ops.use_kernels(False)
    try:
        traced = dr.trace_step(step, dr.empty_args(trees), trees, kind,
                               meshes=meshes, rules=sh.DEFAULT_RULES)
    finally:
        ops.use_kernels(True)
    return [dr.lay_out(traced, trees, weights, cfg, shape, m,
                       sh.DEFAULT_RULES, j) for j, m in enumerate(meshes)]


# arch -> reading -> (low, high), the readings in the module doc
LIMITS = {
    "gemma3-4b": {"dot_one": {"decode": (1.0, 1.0), "train": (1.0, 1.15)},
                  "dot": (0.85, 1.0), "split": (0.8, 1.6),
                  "link": (0.35, 1.0)},
    "mixtral-8x22b": {"dot_one": {"decode": (1.0, 1.0),
                                  "train": (1.0, 1.05)},
                      "dot": (0.8, 1.0), "split": (0.8, 2.0),
                      "link": (0.3, 1.0)},
}
_XLA: dict = {}


def _xla_of(arch) -> dict:
    if arch not in _XLA:
        _XLA[arch] = _xla(arch, MESHES, KINDS)
    return _XLA[arch]


@pytest.mark.parametrize("arch", list(LIMITS))
@pytest.mark.parametrize("kind", KINDS)
def test_gemma3_and_mixtral_against_the_partitioner(arch, kind):
    x = _xla_of(arch)
    one, mesh = _port(kind, arch)
    x_one, x_mesh = x[f"{kind} 1x1"], x[f"{kind} 2x4"]
    lim = LIMITS[arch]
    readings = {
        "dot_one": one["hlo"]["dot_flops"] / x_one["dot_flops"],
        "dot": mesh["hlo"]["dot_flops"] / x_mesh["dot_flops"],
        "split": (one["hlo"]["hbm_bytes"] / mesh["hlo"]["hbm_bytes"])
        / (x_one["hbm_bytes"] / x_mesh["hbm_bytes"]),
        "link": mesh["hlo"]["coll_link_bytes"] / x_mesh["coll_link_bytes"],
    }
    for name, value in readings.items():
        lo, hi = lim[name][kind] if name == "dot_one" else lim[name]
        assert lo <= value <= hi, (arch, kind, name, value)
    assert one["hlo"]["coll_link_bytes"] == 0 == x_one["coll_link_bytes"]


@pytest.mark.parametrize("kind", KINDS)
def test_split_against_the_partitioner(xla, kind):
    one, mesh = _port(kind)
    x_one, x_mesh = xla[f"{kind} 1x1"], xla[f"{kind} 2x4"]
    assert one["hlo"]["dot_flops"] == x_one["dot_flops"]
    dot = mesh["hlo"]["dot_flops"] / x_mesh["dot_flops"]
    assert 0.85 <= dot <= 1.0, dot
    x_split = x_one["hbm_bytes"] / x_mesh["hbm_bytes"]
    split = one["hlo"]["hbm_bytes"] / mesh["hlo"]["hbm_bytes"]
    assert 0.8 <= split / x_split <= 1.5, (split, x_split)
    # every byte over all 8 devices: what the split must not be
    assert mesh["split"]["divisor"] == 8
    assert mesh["split"]["divisor"] / x_split > 1.5
    link = mesh["hlo"]["coll_link_bytes"] / x_mesh["coll_link_bytes"]
    assert 0.25 <= link <= 1.0, link
    assert one["hlo"]["coll_link_bytes"] == 0 == x_one["coll_link_bytes"]


def test_weight_gradient_takes_the_weights_split():
    """The product that makes a weight's gradient writes it at the
    weight's split as products read it (over "model"), not at the
    activations' (batch x model); then it is held at the parameter's
    split (the reduce-scatter over "data")."""
    import torch

    from repro_torch.launch import cost_analysis as ca

    mesh = FakeMesh(("data", "model"), np.zeros((2, 4)))
    wspec = sh.tspec((64, 128), ("embed", "mlp"))
    xspec = sh.tspec((8, 64), ("batch", "act_embed"))
    with ca.CostTrace(meshes=[mesh], rules=sh.DEFAULT_RULES) as tr:
        p = torch.zeros(64, 128, device="meta")
        x = torch.zeros(8, 64, device="meta")
        tr.seed(p, wspec, "param")
        tr.seed(x, xspec, "data")
        w = p.detach().requires_grad_(True)
        before = tr.dev_bytes[0]
        g = torch.autograd.grad((x @ w).sum(), w)[0]
        cls = tr._class(g)
    assert (cls.kind, cls.pairs) == ("P", ((2, 4),))
    # the gradient product's write: 64 x 128 float32 over "model" alone
    assert tr.dev_bytes[0] - before >= 64 * 128 * 4 / 4



def test_square_weight_gradients_are_told_apart():
    """Two square weights of different splits, one after the other (as
    llama's wq and wo are both 2,048 x 2,048): each gradient takes its own
    weight's split, found by the storage that met the weight in a product
    and not by the shape alone; a product of activations with a weight's
    shape whose inputs met no weight stays an activation."""
    import torch

    from repro_torch.launch import cost_analysis as ca

    mesh = FakeMesh(("data", "model"), np.zeros((2, 4)))
    with ca.CostTrace(meshes=[mesh], rules=sh.DEFAULT_RULES) as tr:
        p1 = torch.zeros(64, 64, device="meta")
        p2 = torch.zeros(64, 64, device="meta")
        x = torch.zeros(8, 64, device="meta")
        tr.seed(p1, sh.tspec((64, 64), ("embed", "mlp")), "param")
        tr.seed(p2, sh.tspec((64, 64), ("embed", None)), "param")
        tr.seed(x, sh.tspec((8, 64), ("batch", "act_embed")), "data")
        w1 = p1.detach().requires_grad_(True)
        w2 = p2.detach().requires_grad_(True)
        h0 = x * 1.0
        h = h0 @ w1
        y = h @ w2
        a = h * 2.0
        z = a.t() @ a
        g1, g2 = torch.autograd.grad(y.sum(), (w1, w2))
        cz, c1, c2 = tr._class(z), tr._class(g1), tr._class(g2)
    assert cz.kind == "A"
    assert (c1.kind, c1.pairs) == ("P", ((2, 4),))
    assert (c2.kind, c2.pairs) == ("P", ((2, 1),))

def main():
    meshes = ((1, 1), (2, 4), (4, 2))
    kinds = ("decode", "prefill", "train")
    for arch in (ARCH, "gemma3-4b", "mixtral-8x22b"):
        x = _xla(arch, meshes, kinds)
        for kind in kinds:
            port = _port(kind, arch, meshes)
            x_one = x[f"{kind} 1x1"]
            for dims, rec in zip(meshes[1:], port[1:]):
                x_m = x[f"{kind} {dims[0]}x{dims[1]}"]
                x_split = x_one["hbm_bytes"] / x_m["hbm_bytes"]
                split = port[0]["hlo"]["hbm_bytes"] / rec["hlo"]["hbm_bytes"]
                div = rec["split"]["divisor"]
                dot = rec["hlo"]["dot_flops"] / x_m["dot_flops"]
                dot_one = port[0]["hlo"]["dot_flops"] / x_one["dot_flops"]
                link = rec["hlo"]["coll_link_bytes"] / x_m["coll_link_bytes"]
                print(f"{arch} {kind} {dims}: dot port / XLA {dot:.3f} "
                      f"(one device {dot_one:.3f}); bytes split XLA "
                      f"{x_split:.2f}, port {split:.2f} "
                      f"({split / x_split:.2f}), all over {div} "
                      f"({div / x_split:.2f}); link bytes port / XLA "
                      f"{link:.2f}", flush=True)

if __name__ == "__main__":
    main()
