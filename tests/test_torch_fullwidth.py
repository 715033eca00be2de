"""Full-width parity machinery (``repro_torch.launch.fullwidth``,
``tests/_torch_fullwidth.py``) on the CPU.

* The port's counter-based draw (``models.model.draw_leaf``) equals its
  numpy twin bit for bit, on slices of the largest leaf of every arch's
  published config (drawn by element offset; the leaf is never
  allocated).
* The fixture's metadata (arch, cut, token shape, seed, config digest)
  matches the port's configs, so a config edit that stales the fixture
  fails here; the fixture holds every arch of ``fullwidth.CUTS`` (all
  but arctic-480b, whose one layer is 27 GB in bf16) and stays under
  4 MB.
* The machinery end to end on three reduced configs (a dense, an MoE and
  a hybrid stack): the JAX package's readings made here, the port held
  to them by ``fullwidth.compare`` (the function the card's phase uses),
  at ``fullwidth.LIMITS``; ``compare`` fails a reading pushed past its
  limit.
* llama3.2-1b at its published widths cut to one layer (d 2,048, 32
  heads, 8 KV, head dim 64, vocabulary 128,256), 1 x 64 tokens, the
  JAX package against the port directly: the prefill logits within 1e-4
  of their scale (rtol = atol share, as ``tests/_torch_parity.py``), the
  loss within rtol 1e-5 and every gradient within 1e-3 of its leaf's
  scale.
"""
import json

import numpy as np
import pytest
import torch

import _torch_fullwidth as helper
from repro_torch.configs import ARCHS, get_config
from repro_torch.dist.sharding import _leaves
from repro_torch.launch import fullwidth as fw
from repro_torch.models import model as pmodel

SLICE = 4096


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_draw_matches_numpy_twin(arch):
    specs = _leaves(pmodel.model_specs(get_config(arch)))
    i = max(range(len(specs)), key=lambda j: specs[j].size)
    spec = specs[i]
    for start in (0, spec.size // 2 + 12345, spec.size - SLICE):
        got = pmodel.draw_leaf(spec, fw.SEED, i, start=start, count=SLICE)
        want = helper.np_draw_leaf(spec, fw.SEED, i, start=start,
                                   count=SLICE)
        assert got.dtype == torch.float32
        assert np.array_equal(got.numpy().view(np.int32),
                              want.view(np.int32)), (arch, start)
    offset, half = pmodel.draw_recipe(spec)
    assert offset == 0.0 and 0 < half < 1


def test_draw_recipes():
    """Zeros and ones leaves are perturbed, the rest at the recipes'
    deviations, fan-in past the stacking and expert axes."""
    from repro_torch.dist.sharding import tspec
    w = tspec((4, 8, 64, 32), ("layers", "expert", "embed", "expert_mlp"))
    assert pmodel.fan_in(w) == 64
    wo = tspec((4, 16, 8, 64), ("layers", "heads", "head_dim", "embed"))
    assert pmodel.fan_in(wo) == 128
    ones = pmodel.draw_leaf(tspec((1000,), ("act_embed",), init="ones"), 0, 0)
    assert 0.9 <= float(ones.min()) < 1 < float(ones.max()) <= 1.1
    x = pmodel.draw_leaf(w, 0, 1)
    assert abs(float(x.std()) - 64 ** -0.5) < 0.01 * 64 ** -0.5
    assert pmodel.draw_leaf(w, 0, 1, start=100, count=50).equal(x[100:150])


@pytest.fixture(scope="module")
def fixture():
    return fw.load_fixture()


def test_fixture_metadata_matches_configs(fixture):
    archs = fw.fixture_archs(fixture)
    assert set(archs) == set(fw.CUTS)
    assert fw.FIXTURE.stat().st_size < 4 << 20
    for arch in archs:
        cfg, cut = fw.port_config(arch)
        want = fw.meta(arch, cfg, cut)
        got = {k: v for k, v in fixture[f"{arch}/meta"].items()
               if k != "made"}
        assert got == json.loads(json.dumps(want)), arch


@pytest.mark.parametrize("arch", sorted(fw.REDUCED_CUTS))
def test_machinery_on_reduced_configs(arch):
    ref = helper.jax_run(arch, reduced=True)
    got = fw.run(arch, "cpu", ref, reduced=True)
    readings, fails = fw.compare(arch, got, ref)
    assert not fails, fails
    kinds = {"prefill_logits", "prefill_top", "cache", "decode_logits",
             "loss", "grad_norm", "grad_dot"}
    if fw.is_moe(fw.port_config(arch, True)[0]):
        kinds |= {"route_flips", "route_gap"}
    assert set(readings) >= kinds, readings
    # a reading past its limit fails
    bad = dict(got)
    key = f"{arch}/prefill/proj"
    bad[key] = got[key] * (1 + 3 * fw.LIMITS["prefill_logits"])
    assert any("prefill_logits" in f for f in fw.compare(arch, bad, ref)[1])


def test_llama_published_width_one_layer():
    """JAX against the port directly at llama3.2-1b's published widths."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.models.losses import xent as jxent
    from repro.models.model import forward as jforward
    from repro_torch.train.step import StepCfg, loss_and_grads

    arch, cut = "llama3.2-1b", fw.Cut(1, 1, 64)
    jcfg = fw.cut_config(helper.jax_config(arch)[0], cut, jnp.float32)
    cfg = fw.cut_config(get_config(arch), cut, torch.float32)
    assert cfg.d_model == 2048 and cfg.vocab == 128256
    specs = helper.spec_leaves(pmodel.model_specs(cfg))
    np_params = {}
    for i, (path, spec) in enumerate(specs):
        np_params[path] = helper.np_draw_leaf(spec, fw.SEED, i).reshape(
            spec.shape)
    inp = fw.draw_inputs(cfg, cut)
    tokens, labels = inp["tokens"].numpy(), inp["labels"].numpy()

    def tree(flat_tree, fn):
        out: dict = {}
        for path, a in flat_tree.items():
            node = out
            keys = path.split("/")
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = fn(a)
        return out

    jops.use_kernels(False)
    jparams = tree(np_params, jnp.asarray)
    want_logits = np.asarray(jax.jit(lambda p, x: jforward(
        p, jcfg, x, mode="prefill", cache_len=64)[0])(jparams, tokens))
    want_loss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jxent(jforward(p, jcfg, jnp.asarray(tokens),
                                 mode="train"), jnp.asarray(labels))))(jparams)
    want_grads = {k: np.asarray(v) for k, v in
                  fw.flat(jax.tree.map(np.asarray, jgrads)).items()}
    del jparams, jgrads

    params = tree(np_params, torch.from_numpy)
    with torch.no_grad():
        logits, _ = pmodel.forward(params, cfg, inp["tokens"],
                                   mode="prefill", cache_len=64)
    assert fw._share(logits.numpy(), want_logits) <= fw.LIMITS[
        "prefill_logits"]
    del logits
    loss, grads = loss_and_grads(cfg, StepCfg(remat="none"), params,
                                 {"tokens": inp["tokens"],
                                  "labels": inp["labels"]})
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * float(want_loss)
    got = fw.flat(grads)
    assert sorted(got) == sorted(want_grads)
    for path, w in want_grads.items():
        g = got[path].numpy()
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * scale,
                                   err_msg=path)


def test_reference_init_takes_the_stack_depth_as_fan_in():
    """A fault of the reference, pinned: the JAX package's ``init_params``
    takes a stacked leaf's leading axis ("layers", the number of groups)
    as its fan-in, so reduced llama's wq (3 groups of (64, 4, 16)) is
    drawn at 3^-1/2, not 64^-1/2; the counter-based draw takes the fan-in
    past the stacking axis (``models.model.fan_in``)."""
    import jax

    from repro.configs import get_reduced
    from repro.dist.sharding import init_params
    from repro.models.model import model_specs

    specs = model_specs(get_reduced("llama3.2-1b"))
    wq = specs["stack"]["groups"]["p0"]["attn"]["wq"]
    assert wq.shape == (3, 64, 4, 16)
    got = np.asarray(init_params(specs, jax.random.PRNGKey(0))
                     ["stack"]["groups"]["p0"]["attn"]["wq"])
    assert abs(got.std() - 3 ** -0.5) < 0.05 * 3 ** -0.5
    pspec = pmodel.model_specs(fw.port_config("llama3.2-1b", True)[0])
    pwq = pspec["stack"]["groups"]["p0"]["attn"]["wq"]
    assert pmodel.draw_recipe(pwq)[1] == pytest.approx(3 ** 0.5 / 8)


def test_rope_frequencies_are_rounded_once():
    """RoPE's frequencies theta^(-i / half) are the float32 exponent (the
    correctly rounded quotient) raised in float64 and rounded once
    (``models.common._freqs``), at every head dim and M-RoPE section in
    use: the bits ``chip_smoke.py``'s ``rope_bits`` finds on the card too.
    A float32 ``pow`` is an ulp off for some of them in one library or
    another (on the jax 0.9 this was written against, XLA's on the CPU for
    7 of head dim 80's 40), and at position 4,607 an ulp of a frequency
    near 1 turns the angle by up to ~3e-4 rad: the full-width cache
    readings showed it (PERF.md section 6).  The ladder is made on the
    device asked for, with no operation on another (a host copy to the
    card waits for its queue at every attention call)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models.common import _freqs

    for half, theta, lo, hi in ((8, 1e4, 0, 8), (32, 5e5, 0, 32),
                                (40, 1e4, 0, 40), (64, 1e6, 0, 64),
                                (64, 1e6, 16, 40), (128, 1e6, 0, 128)):
        i = np.arange(lo, hi, dtype=np.float64)
        e = (-i / half).astype(np.float32)
        want = (theta ** e.astype(np.float64)).astype(np.float32)
        got = _freqs(lo, hi, half, theta, "cpu").numpy()
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), half

    class Devices(TorchDispatchMode):
        seen: set = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in torch.utils._pytree.tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.seen.add(t.device.type)
            return out

    with Devices() as mode:
        f = _freqs(0, 40, 40, 1e4, "meta")
    assert f.device.type == "meta" and f.dtype == torch.float32
    assert mode.seen == {"meta"}, mode.seen


def test_routing_records_and_forces():
    """``launch.routing.Routing``, the one context behind the fixture's
    MoE runs and ``chip_smoke.py``'s MoE checks: recorded on one input,
    forced on another, the second run takes the first's top_idx and pos,
    and ``flips`` counts exactly the tokens whose own choice differs, with
    the first run's margins over its logits' scale; a call past the
    reference's raises."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.routing import Routing, margins
    from repro_torch.models import moe

    cfg = next(lc.moe for lc in get_reduced("mixtral-8x22b").stack.pattern
               if lc.moe is not None)
    d = 64
    params = pmodel.draw_params(moe.moe_specs(cfg, d), 3)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 32, d, generator=g)
    x2 = x + 0.3 * torch.randn(2, 32, d, generator=g)
    with Routing() as ref:
        moe.moe(params, x, cfg)
    with Routing() as free:
        _, own = moe.moe(params, x2, cfg, return_aux=True)
    with Routing(ref.records) as forced:
        _, aux = moe.moe(params, x2, cfg, return_aux=True)
    want = ref.records[0]
    k = cfg.top_k
    assert torch.equal(aux["top_idx"], want["top_idx"].reshape(-1, k))
    assert torch.equal(aux["pos"], want["pos"].reshape(-1, k))
    moved = (own["top_idx"] != want["top_idx"].reshape(-1, k)).any(-1)
    rec = forced.flips()
    assert rec["flips"] == int(moved.sum()) > 0
    margin, scale = margins(want["logits"], k)
    assert rec["gap_shares"] == (margin[moved] / scale).tolist()
    assert torch.equal(forced.records[0]["own"][0],
                       free.records[0]["top_idx"])
    with pytest.raises(RuntimeError):
        with Routing(ref.records):
            moe.moe(params, x2, cfg)
            moe.moe(params, x2, cfg)
