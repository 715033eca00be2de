"""Sharded serving of the PyTorch port over a ("data", "model") mesh of
"cpu" slots: llama3.2-1b and falcon-mamba-7b, reduced, in float32
compute, on meshes (1, 2), (2, 1) and (2, 2) (``make_mesh(...,
devices=["cpu"] * n)``; a CPU slot takes the kernels' plain versions).

* **Layout.**  Every shard of every parameter leaf (``dist.sharding.place``)
  and of every cache leaf the sharded prefill writes equals, bit for bit,
  the numpy slice that the JAX package's own ``resolve_pspec`` gives for
  that mesh position (it takes a duck-typed mesh); ``gather(place(x))``
  is ``x``.
* **Against the port on one device.**  Prefill logits, every cache leaf
  after prefill and after the last of 9 decode steps, and the logits of
  every step: rtol 1e-5 and atol 1e-5 times the leaf's largest magnitude
  (only the order of sums differs); cache positions exactly.
* **Against the JAX package.**  The same run against the JAX package's
  reduced model through its prefill and decode steps, as
  ``tests/_torch_parity.py`` runs them: rtol 1e-4 and atol 1e-4 times the
  leaf's largest magnitude.
* **Both cache layouts.**  llama's cache of 26 slots divides by "model"
  and is split by sequence (split-KV decode); one of 25 is split by heads.
* **Mamba1's pairing**, **determinism** (two calls, the same bits),
  **refusals** (a layout the sharded steps do not run raises when the
  step is made), **thread failures** (an exception in one slot reaches
  the caller at once, well inside the turn's timeout), the collectives
  and the counters under contention.
* **Published width.**  llama3.2-1b at its published widths, one layer,
  1 x 64 tokens: the sharded prefill on (2, 2) against the JAX package at
  ``fullwidth.LIMITS["prefill_logits"]``; its batch of 1 does not divide
  by "data", which ``resolve_pspec`` leaves whole.
"""
import dataclasses
import math
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_fullwidth as fw_helper
import _torch_parity as parity
from repro.dist import sharding as jsh
from repro.train import step as jstep
from repro_torch.configs import get_config, get_reduced
from repro_torch.dist import sharding as sh
from repro_torch.kernels import _build
from repro_torch.launch import fullwidth as fw
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import mamba
from repro_torch.models import model as pmodel
from repro_torch.train import step as st

ARCHS = ("llama3.2-1b", "falcon-mamba-7b")
MESHES = ((1, 2), (2, 1), (2, 2))
T, STEPS = parity.T, parity.DECODE_STEPS
# llama: 26 slots divide by "model" (split by sequence), 25 do not (by
# heads); falcon-mamba has no KV cache
RUNS = [("llama3.2-1b", 26), ("llama3.2-1b", 25), ("falcon-mamba-7b", 25)]
TOL, JAX_TOL = 1e-5, 1e-4


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"), ["cpu"] * math.prod(shape))


def jax_slices(shape, axes, mesh_shape, pos):
    """The numpy slices of a leaf of ``shape`` and logical ``axes`` that
    the JAX package's ``resolve_pspec`` gives mesh position ``pos``."""
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty(mesh_shape))
    spec = tuple(jsh.resolve_pspec(shape, axes, fake))
    coords = dict(zip(fake.axis_names, pos))
    sizes = dict(zip(fake.axis_names, mesh_shape))
    out = []
    for i, dim in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        names = () if e is None else (e,) if isinstance(e, str) else e
        k, n = 0, 1
        for a in names:
            k, n = k * sizes[a] + coords[a], n * sizes[a]
        out.append(slice(k * dim // n, (k + 1) * dim // n))
    return tuple(out)


def assert_jax_layout(placed, specs, mesh_shape):
    """Every shard of every leaf equals the JAX package's slice of the
    leaf gathered whole, bit for bit."""
    flat_p, flat_s = fw.flat(placed), fw.flat(specs)
    assert sorted(flat_p) == sorted(flat_s)
    for path, leaf in flat_p.items():
        spec = flat_s[path]
        whole = sh.gather(leaf)
        assert tuple(whole.shape) == spec.shape, path
        for pos in np.ndindex(mesh_shape):
            want = whole[jax_slices(spec.shape, spec.axes, mesh_shape, pos)]
            got = leaf.shards[pos]
            assert got.shape == want.shape and torch.equal(got, want), \
                (path, pos)


def port_cfg(arch):
    return dataclasses.replace(get_reduced(arch), compute_dtype=torch.float32)


_REF: dict = {}


def jax_ref(arch, cache_len):
    """The JAX package's prefill + decode logits and caches (numpy)."""
    if (arch, cache_len) not in _REF:
        s = parity.setup(arch)
        pre = jax.jit(jstep.make_prefill_step(s["cfg"], max_len=cache_len))
        dec = jax.jit(jstep.make_decode_step(s["cfg"]))
        logits, cache = pre(s["params"], {"tokens": jnp.asarray(s["tokens"])})
        lg = [np.asarray(logits)]
        caches = [fw.flat(jax.tree.map(np.asarray, cache))]
        for i, tok in enumerate(s["steps"]):
            logits, cache = dec(s["params"], cache,
                                {"tokens": jnp.asarray(tok),
                                 "pos": jnp.asarray(T + i, jnp.int32)})
            lg.append(np.asarray(logits))
        caches.append(fw.flat(jax.tree.map(np.asarray, cache)))
        _REF[arch, cache_len] = {"logits": lg, "caches": caches}
    return _REF[arch, cache_len]


_RUN: dict = {}


def port_run(arch, cache_len, shape=None):
    """The port's prefill + decode, on one device (``shape`` None) or
    sharded over a mesh of "cpu" slots: the logits, the caches after
    prefill and after the last step (flat numpy, gathered whole) and,
    sharded, the placed prefill cache."""
    key = (arch, cache_len, shape)
    if key not in _RUN:
        s = parity.setup(arch)
        cfg = port_cfg(arch)
        params = pmodel.params_from_numpy(s["np_params"], "cpu")
        mesh = None if shape is None else cpu_mesh(shape)
        if mesh is not None:
            params = sh.place(params, pmodel.model_specs(cfg), mesh)
        pre = st.make_prefill_step(cfg, mesh=mesh, max_len=cache_len)
        dec = st.make_decode_step(cfg, mesh=mesh)

        def snap(c):
            return {k: v.copy() for k, v in fw.flat(pmodel.cache_to_numpy(
                c if mesh is None else sh.gather(c))).items()}

        logits, cache = pre(params, {"tokens": torch.from_numpy(s["tokens"])})
        out = {"logits": [logits.numpy().copy()], "caches": [snap(cache)],
               "placed": cache if mesh is not None else None}
        if mesh is not None:
            out["prefill_shards"] = {p: [x.clone() for x in c.shards.flat]
                                     for p, c in fw.flat(cache).items()}
        for i, tok in enumerate(s["steps"]):
            logits, cache = dec(params, cache,
                                {"tokens": torch.from_numpy(tok),
                                 "pos": T + i})
            out["logits"].append(logits.numpy().copy())
        out["caches"].append(snap(cache))
        _RUN[key] = out
    return _RUN[key]


def same_run(got, want, tol):
    for g, w in zip(got["logits"], want["logits"]):
        parity.close(g, w, tol, tol)
    for gflat, wflat in zip(got["caches"], want["caches"]):
        assert sorted(gflat) == sorted(wflat)
        for path, leaf in wflat.items():
            if path.endswith("pos"):
                assert np.array_equal(gflat[path], leaf), path
            else:
                parity.close(gflat[path], leaf, tol, tol)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_params_placed_where_jax_resolve_pspec_puts_them(arch, shape):
    cfg = port_cfg(arch)
    specs = pmodel.model_specs(cfg)
    params = pmodel.draw_params(specs, 3)
    mesh = cpu_mesh(shape)
    placed = sh.place(params, specs, mesh)
    assert_jax_layout(placed, specs, shape)
    for path, whole in fw.flat(sh.gather(placed)).items():
        assert torch.equal(whole, fw.flat(params)[path]), path
    # each slot holds shard_bytes of the tree, no leaf whole that splits
    for pos in np.ndindex(shape):
        held = sum(x.shards[pos].numel() * x.shards[pos].element_size()
                   for x in fw.flat(placed).values())
        assert held == sh.shard_bytes(specs, mesh)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch,cache_len", RUNS)
def test_prefill_cache_laid_out_as_jax_resolve_pspec(arch, cache_len, shape):
    run = port_run(arch, cache_len, shape)
    cfg = port_cfg(arch)
    specs = pmodel.model_cache_specs(cfg, parity.B, cache_len)
    placed = run["placed"]
    flat_specs = fw.flat(specs)
    # the shards as prefill wrote them (decode writes the cache in place)
    for path, shards in run["prefill_shards"].items():
        spec = flat_specs[path]
        whole = run["caches"][0][path]
        for pos, got in zip(np.ndindex(shape), shards):
            want = whole[jax_slices(spec.shape, spec.axes, shape, pos)]
            got = got.float().numpy() if got.is_floating_point() \
                else got.numpy()
            assert got.shape == want.shape and np.array_equal(got, want), \
                (path, pos)
    assert_jax_layout(placed, specs, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch,cache_len", RUNS)
def test_sharded_steps_match_one_device(arch, cache_len, shape):
    same_run(port_run(arch, cache_len, shape), port_run(arch, cache_len),
             TOL)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("arch,cache_len", RUNS)
def test_sharded_steps_match_jax(arch, cache_len, shape):
    same_run(port_run(arch, cache_len, shape), jax_ref(arch, cache_len),
             JAX_TOL)


@pytest.mark.parametrize("cache_len,split", [(26, "kv_seq"),
                                             (25, "act_kv_heads")])
def test_cache_split_by_sequence_or_heads(cache_len, split):
    """On (1, 2) and (2, 2) a cache whose length divides by "model" is
    split by sequence there, else by heads."""
    for shape in ((1, 2), (2, 2)):
        k = fw.flat(port_run("llama3.2-1b", cache_len, shape)["placed"])[
            "groups/p0/self/k"]
        axes = ("layers", "batch", "kv_seq", "act_kv_heads", "head_dim")
        assert k.layout[axes.index(split)] == ("model",), k.layout
        assert ("data",) in k.layout if shape[0] > 1 else True


def test_mamba1_pairs_xa_and_z_of_one_channel_range(monkeypatch):
    """A Mamba1 layer on (1, 2): slot 0's columns of in_proj are all of xa
    and slot 1's all of z, so without the exchange each slot would pair
    xa of one channel range with z of another: the layer then differs
    from one device, and with it matches."""
    cfg = port_cfg("falcon-mamba-7b")
    lc = cfg.stack.pattern[0]
    specs = mamba.mamba1_specs(lc.ssm, cfg.d_model)
    params = pmodel.draw_params(specs, 5)
    half = lc.ssm.d_inner
    assert not torch.equal(params["in_proj"][:, :half],
                           params["in_proj"][:, half:])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 12, cfg.d_model), dtype=np.float32))
    want, _ = mamba.mamba1(params, x, lc.ssm, mode="prefill", cache=None)
    mesh = cpu_mesh((1, 2))
    placed = sh.place(params, specs, mesh)

    def layer(coords):
        with sh.slot_ctx(mesh, None, ()):
            return mamba.mamba1(sh.shard_tree(placed, coords), x, lc.ssm,
                                mode="prefill", cache=None)[0]

    got = mesh.run_spmd(layer)
    for y in got.flat:
        parity.close(y, want, TOL, TOL)
    monkeypatch.setattr(mamba, "_pair_halves", lambda xz, axes: xz)
    wrong = mesh.run_spmd(layer)
    err = float((wrong[0, 0] - want).abs().max() / want.abs().max())
    assert err > 1e-2, err


@pytest.mark.parametrize("arch", ARCHS)
def test_two_calls_give_the_same_bits(arch):
    runs = [port_run(arch, 25, (2, 2))]
    _RUN.pop((arch, 25, (2, 2)))
    runs.append(port_run(arch, 25, (2, 2)))
    for a, b in zip(runs[0]["logits"], runs[1]["logits"]):
        assert np.array_equal(a.view(np.int32), b.view(np.int32))
    for ca, cb in zip(runs[0]["caches"], runs[1]["caches"]):
        for path in ca:
            assert np.array_equal(ca[path], cb[path]), path


@pytest.mark.parametrize("arch,shape,match", [
    ("h2o-danube-1.8b", (2, 2), "ring caches"),
    ("mixtral-8x22b", (1, 2), "MoE"),
    ("whisper-medium", (1, 2), "cross-attention"),
    ("zamba2-2.7b", (1, 2), "shared block|mamba2"),
    ("gemma3-4b", (1, 16), "act_seq_tp"),
])
def test_unsupported_layouts_raise_before_any_work(arch, shape, match):
    """The step is refused when it is made: no parameter is read and no
    slot runs."""
    cfg = get_config(arch) if arch == "gemma3-4b" else get_reduced(arch)
    mesh = cpu_mesh(shape)
    mesh_mod.clear_collectives()
    for make in (lambda: st.make_prefill_step(cfg, mesh=mesh, max_len=32),
                 lambda: st.make_decode_step(cfg, mesh=mesh)):
        with pytest.raises(NotImplementedError, match=match):
            make()
    assert mesh_mod.collective_counts() == {}


def test_unsupported_rules_and_training_raise():
    cfg = port_cfg("llama3.2-1b")
    mesh = cpu_mesh((2, 2))
    with pytest.raises(NotImplementedError, match="'embed' axis"):
        st.make_prefill_step(cfg, mesh=mesh, rules=sh.RULE_PRESETS["fsdp"])
    with pytest.raises(NotImplementedError, match="sharded training"):
        st.make_train_step(cfg, parity.popt.OptCfg(), mesh=mesh)
    # the host mesh and no mesh take the one-device steps
    host = mesh_mod.make_host_mesh("cpu")
    assert st.make_prefill_step(cfg, mesh=host).__name__ == "prefill_step"
    st.make_train_step(cfg, parity.popt.OptCfg(), mesh=host)
    with pytest.raises(ValueError, match="not placed"):
        st.make_prefill_step(cfg, mesh=mesh)(
            pmodel.draw_params(pmodel.model_specs(cfg), 0),
            {"tokens": torch.zeros((2, 4), dtype=torch.int32)})


def test_a_slot_failure_reaches_the_caller(monkeypatch):
    """Slot (0, 1) raises while the others wait at an all-reduce: the
    caller gets its exception at once, not after the turn's timeout; a
    slot that leaves without a collective the others reach fails the
    call, and so does a turn that does not come within the timeout."""
    mesh = cpu_mesh((2, 2))
    monkeypatch.setattr(mesh_mod, "SPMD_TIMEOUT_S", 30.0)

    def body(coords):
        if coords == {"data": 0, "model": 1}:
            time.sleep(0.2)
            raise ValueError("slot (0, 1) failed")
        return mesh_mod.all_reduce(torch.ones(3), ("data", "model"))

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match=r"slot \(0, 1\) failed"):
        mesh.run_spmd(body)
    assert time.perf_counter() - t0 < 10.0

    def skips(coords):
        if coords["model"] == 0:
            return mesh_mod.all_gather(torch.ones(2), ("model",))
        return None

    t0 = time.perf_counter()
    with pytest.raises(mesh_mod.SpmdAbort, match="left without"):
        mesh.run_spmd(skips)
    assert time.perf_counter() - t0 < 10.0

    def stalls(coords):
        if coords == {"data": 1, "model": 1}:
            time.sleep(1.5)
        return mesh_mod.all_gather(torch.ones(2), ("data",))

    monkeypatch.setattr(mesh_mod, "SPMD_TIMEOUT_S", 0.5)
    t0 = time.perf_counter()
    with pytest.raises(mesh_mod.SpmdAbort, match="waited"):
        mesh.run_spmd(stalls)
    assert time.perf_counter() - t0 < 10.0
    assert not [t for t in threading.enumerate()
                if t.name.startswith("spmd-slot-")]


def test_collectives_in_slot_order():
    """all_reduce (sum, max), all_gather and all_to_all over each axis and
    both, on (2, 2): values, group order, the same bits on every member,
    and the counters' calls and bytes."""
    mesh = cpu_mesh((2, 2))
    mesh_mod.clear_collectives()

    def body(c):
        me = torch.full((2,), float(1 + 10 * c["data"] + c["model"]))
        return {"sum_m": mesh_mod.all_reduce(me, ("model",)),
                "max_all": mesh_mod.all_reduce(me, ("data", "model"), "max"),
                "gather_d": torch.stack(mesh_mod.all_gather(me, ("data",))),
                "a2a": torch.stack(mesh_mod.all_to_all(
                    [me * 100 + j for j in range(2)], ("model",)))}

    out = mesh.run_spmd(body)
    for d, m in np.ndindex(2, 2):
        r = out[d, m]
        assert r["sum_m"].tolist() == [2 + 20 * d + 1] * 2
        assert r["max_all"].tolist() == [12.0, 12.0]
        assert r["gather_d"][:, 0].tolist() == [1 + m, 11 + m]
        assert r["a2a"][:, 0].tolist() == [(1 + 10 * d) * 100 + m,
                                           (2 + 10 * d) * 100 + m]
    counts = mesh_mod.collective_counts()
    assert counts["all_reduce_sum over model"] == {"calls": 1, "bytes": 32}
    assert counts["all_reduce_max over data,model"] == {"calls": 1,
                                                       "bytes": 96}
    assert counts["all_to_all over model"] == {"calls": 1, "bytes": 32}


def test_counters_under_contention():
    """Launch and collective counters from 16 slot threads at once, with
    a short switch interval: no update lost."""
    mesh = cpu_mesh((4, 4))
    before = _build.KERNEL_LAUNCHES["contention_probe"]
    mesh_mod.clear_collectives()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(c):
            for _ in range(200):
                _build.check("contention_probe", 0, "probe")
            for _ in range(20):
                mesh_mod.all_gather(torch.ones(1), ("data",))
            return None
        mesh.run_spmd(body)
    finally:
        sys.setswitchinterval(old)
    assert _build.KERNEL_LAUNCHES.pop("contention_probe") - before == 3200
    _build.SHAPE_LAUNCHES.pop(("contention_probe", "probe"))
    assert mesh_mod.collective_counts()["all_gather over data"] == {
        "calls": 20, "bytes": 20 * 16 * 3 * 4}


def test_fullwidth_run_over_a_mesh():
    """``fullwidth.run`` over (2, 2) takes the serving readings alone and
    holds to the one-device run's at ``fullwidth.LIMITS``."""
    one = fw.serving(fw.run("llama3.2-1b", "cpu", reduced=True))
    got = fw.run("llama3.2-1b", "cpu", one, reduced=True,
                 mesh=cpu_mesh((2, 2)))
    assert not [k for k in got if "/train/" in k]
    readings, fails = fw.compare("llama3.2-1b", got, one)
    assert not fails, fails
    assert set(readings) == {"prefill_logits", "prefill_top", "cache",
                             "decode_logits"}


def test_llama_published_width_sharded_prefill():
    """llama3.2-1b at its published widths, one layer, 1 x 64 tokens:
    the sharded prefill on (2, 2) against the JAX package directly."""
    from repro.kernels import ops as jops
    from repro.models.model import forward as jforward

    arch, cut = "llama3.2-1b", fw.Cut(1, 1, 64)
    jcfg = fw.cut_config(fw_helper.jax_config(arch)[0], cut, jnp.float32)
    cfg = fw.cut_config(get_config(arch), cut, torch.float32)
    specs = pmodel.model_specs(cfg)
    np_params = {path: fw_helper.np_draw_leaf(spec, fw.SEED, i).reshape(
        spec.shape) for i, (path, spec) in
        enumerate(fw_helper.spec_leaves(specs))}
    tokens = fw.draw_inputs(cfg, cut)["tokens"]

    def tree(fn):
        out: dict = {}
        for path, a in np_params.items():
            node = out
            keys = path.split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = fn(a)
        return out

    jops.use_kernels(False)
    want = np.asarray(jax.jit(lambda p, x: jforward(
        p, jcfg, x, mode="prefill", cache_len=64)[0])(
            tree(jnp.asarray), tokens.numpy()))
    mesh = cpu_mesh((2, 2))
    placed = sh.place(tree(torch.from_numpy), specs, mesh)
    del np_params
    with torch.no_grad():
        logits, cache = st.sharded_forward(placed, cfg, mesh, None, tokens,
                                           mode="prefill", cache_len=64)
    assert fw._share(logits.numpy(), want) <= fw.LIMITS["prefill_logits"]
    k = fw.flat(cache)["groups/p0/self/k"]
    assert k.layout == ((), (), ("data",), ("model",), ()), k.layout
