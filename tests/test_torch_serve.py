"""The PyTorch port's LM serving slice against the JAX package: specs,
layers, and prefill + decode of the reduced llama3.2-1b and falcon-mamba-7b
from the same parameters and tokens, on the CPU (so through the kernels'
plain versions).

Tolerances, with their reasons:

* float32 layers: rtol 1e-5 and atol 1e-5 times the output's largest
  magnitude — the same arithmetic summed in another order.
* float32 whole model: rtol 1e-4 and atol 1e-4 times the leaf's largest
  magnitude.  The JAX init draws the stacked weights at fan-in^-1/2 over
  the leading (group) axis, 0.58 here for 64-wide inputs, so scores reach
  tens and softmax rows are near one-hot, and the layers amplify rounding
  differences of one ulp well past 1e-5 of the logits' scale — in either
  package alike, so an absolute 1e-5 would test the summation order, not
  the port.
* bfloat16 whole model: max |port - JAX| <= 0.1 times the leaf's largest
  magnitude.  The JAX package rounds prefill scores and softmax weights to
  bfloat16 (``models/attention.py:96-103``) where the port's attention
  keeps float32.  With scores of tens, bfloat16's step there is 1/8 or
  more, which moves a softmax weight by several percent, and the layers
  carry that on.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.dist.sharding import init_params as jax_init  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models.model import model_cache_specs as jax_cache_specs  # noqa: E402
from repro.models.model import model_specs as jax_specs  # noqa: E402
from repro.train.step import make_decode_step as jax_decode_step  # noqa: E402
from repro.train.step import make_prefill_step as jax_prefill_step  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.dist.sharding import (init_params, param_bytes,  # noqa: E402
                                       param_count)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention, common, mamba, mlp  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.train.step import make_decode_step, make_prefill_step  # noqa: E402

ARCHS = ["llama3.2-1b", "falcon-mamba-7b"]
FULL_PARAMS = {"llama3.2-1b": 1_235_814_400, "falcon-mamba-7b": 7_006_326_784}
B, T, MAX_LEN, DECODE_STEPS = 2, 32, 36, 4


def _flat(tree, prefix=""):
    """{"a/b/c": leaf} for a tree of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close(got, want, rtol, atol_scale):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# 1. specs at full size: the JAX tree's paths, shapes and axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_full_specs_match_jax_and_count_params(arch):
    jspec, pspec = _flat(jax_specs(jax_config(arch))), \
        _flat(pmodel.model_specs(get_config(arch)))
    assert sorted(jspec) == sorted(pspec)
    for path, js in jspec.items():
        ps = pspec[path]
        assert (ps.shape, ps.axes, ps.init, ps.scale) == \
            (js.shape, js.axes, js.init, js.scale), path
        assert str(ps.dtype).split(".")[-1] == np.dtype(js.dtype).name, path
    assert param_count(pmodel.model_specs(get_config(arch))) == \
        FULL_PARAMS[arch]
    assert param_bytes(pmodel.model_specs(get_config(arch))) == \
        4 * FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_cache_specs_match_jax(arch):
    jc = _flat(jax_cache_specs(jax_config(arch), 4, 544))
    pc = _flat(pmodel.model_cache_specs(get_config(arch), 4, 544))
    assert sorted(jc) == sorted(pc)
    for path, js in jc.items():
        assert (pc[path].shape, pc[path].axes) == (js.shape, js.axes), path
        assert str(pc[path].dtype).split(".")[-1] == \
            np.dtype(js.dtype).name, path


def test_init_params_recipes():
    """The JAX package's recipes from a seeded generator: zeros, ones,
    embed N(0, (0.5 d^-1/2)^2), normal at spec.scale or fan-in^-1/2 over
    the leading axis; ``dtype`` replaces floating dtypes; the same seed
    gives the same tree."""
    cfg = get_reduced("falcon-mamba-7b")
    specs = pmodel.model_specs(cfg)

    def draw(seed, dtype=None):
        g = torch.Generator().manual_seed(seed)
        return init_params(specs, g, "cpu", dtype=dtype)

    p = draw(0)
    ssm = p["stack"]["groups"]["p0"]["ssm"]
    assert torch.equal(ssm["conv_b"], torch.zeros(3, 128))
    assert torch.equal(ssm["D"], torch.ones(3, 128))
    assert abs(float(p["embed"].std()) / (0.5 * 64 ** -0.5) - 1) < 0.05
    assert abs(float(ssm["in_proj"].std()) / 3 ** -0.5 - 1) < 0.05
    assert abs(float(ssm["conv_w"].std()) / 0.2 - 1) < 0.05
    same = _flat(draw(0))
    for path, leaf in _flat(p).items():
        assert torch.equal(leaf, same[path]), path
    low = _flat(draw(0, torch.bfloat16))
    assert all(v.dtype == torch.bfloat16 for v in low.values())
    assert param_count(specs) == sum(v.numel() for v in low.values())


def test_lm_module_owns_the_tree_under_its_paths():
    cfg = dataclasses.replace(get_reduced("llama3.2-1b"),
                              compute_dtype=torch.float32)
    tree = init_params(pmodel.model_specs(cfg), torch.Generator().manual_seed(0),
                       "cpu")
    lm = pmodel.LM(cfg, tree)
    names = {n.replace(".", "/") for n, _ in lm.named_parameters()}
    assert names == set(_flat(tree))
    assert not any(p.requires_grad for p in lm.parameters())
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 8)))
    with torch.no_grad():
        got, cache = lm(tokens, mode="prefill", cache_len=10)
        want, _ = pmodel.forward(tree, cfg, tokens, mode="prefill",
                                 cache_len=10)
    assert torch.equal(got, want)
    assert cache["groups"]["p0"]["self"]["k"].shape == (3, 2, 10, 2, 16)


# ---------------------------------------------------------------------------
# 2. layers in float32 from shared numpy inputs
# ---------------------------------------------------------------------------

LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-5


def _layer_params(arch, part):
    """One layer's parameters (group 0) of the reduced config from the JAX
    init, as numpy, and its config."""
    cfg = dataclasses.replace(jax_reduced(arch), compute_dtype=jnp.float32)
    params = jax_init(jax_specs(cfg), jax.random.PRNGKey(0))
    layer = jax.tree.map(lambda a: np.asarray(a[0]),
                         params["stack"]["groups"]["p0"][part])
    return layer, cfg.stack.pattern[0]


def test_rmsnorm_and_rope_match_jax():
    r = np.random.default_rng(0)
    x = r.normal(size=(2, 9, 3, 16)).astype(np.float32) * 3
    scale = r.normal(size=(16,)).astype(np.float32)
    _close(common.rmsnorm(_t(x), _t(scale), 1e-6).numpy(),
           jcommon.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
           LAYER_RTOL, LAYER_ATOL)
    pos = np.broadcast_to(np.arange(40, 49, dtype=np.int32), (2, 9)).copy()
    for theta in (10_000.0, 500_000.0):
        _close(common.apply_rope(_t(x), torch.from_numpy(pos), theta).numpy(),
               jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               LAYER_RTOL, LAYER_ATOL)


@pytest.mark.parametrize("gated", [True, False])
def test_mlp_matches_jax(gated):
    r = np.random.default_rng(1)
    cfg = jmlp.MlpCfg(d_ff=48, gated=gated)
    specs = jmlp.mlp_specs(cfg, 32)
    params = {k: r.normal(size=s.shape).astype(np.float32) * 0.2
              for k, s in specs.items()}
    assert {k: s.shape for k, s in mlp.mlp_specs(
        mlp.MlpCfg(d_ff=48, gated=gated), 32).items()} == \
        {k: s.shape for k, s in specs.items()}
    x = r.normal(size=(2, 5, 32)).astype(np.float32)
    got = mlp.mlp({k: _t(v) for k, v in params.items()}, _t(x),
                  mlp.MlpCfg(d_ff=48, gated=gated))
    want = jmlp.mlp({k: jnp.asarray(v) for k, v in params.items()},
                    jnp.asarray(x), cfg)
    _close(got.numpy(), want, LAYER_RTOL, LAYER_ATOL)


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv_matches_jax(with_tail):
    r = np.random.default_rng(2)
    x, w, b = (r.normal(size=s).astype(np.float32)
               for s in ((2, 7, 12), (4, 12), (12,)))
    tail = r.normal(size=(2, 3, 12)).astype(np.float32) if with_tail else None
    got = mamba.causal_conv(_t(x), _t(w), _t(b),
                            None if tail is None else _t(tail))
    want = jmamba.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if tail is None else jnp.asarray(tail))
    _close(got.numpy(), want, LAYER_RTOL, LAYER_ATOL)


def test_attention_layer_prefill_and_decode_match_jax():
    layer, lc = _layer_params("llama3.2-1b", "attn")
    acfg = lc.attn
    pcfg = get_reduced("llama3.2-1b").stack.pattern[0].attn
    r = np.random.default_rng(3)
    x = r.normal(size=(2, 12, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    jp = jax.tree.map(jnp.asarray, layer)
    pp = {k: _t(v) for k, v in layer.items()}
    jout, jcache = jattn.attention(jp, jnp.asarray(x), acfg,
                                   positions=jnp.asarray(pos), mode="prefill",
                                   cache=None, cache_len=16)
    pout, pcache = attention.attention(pp, _t(x), pcfg,
                                       positions=torch.from_numpy(pos),
                                       mode="prefill", cache=None,
                                       cache_len=16)
    _close(pout.numpy(), jout, LAYER_RTOL, LAYER_ATOL)
    for k in ("k", "v"):
        _close(pcache[k].numpy(), jcache[k], LAYER_RTOL, LAYER_ATOL)
    assert np.array_equal(pcache["pos"].numpy(), np.asarray(jcache["pos"]))
    # one decode step from the same (JAX) cache; the port writes in place
    x1 = r.normal(size=(2, 1, 64)).astype(np.float32)
    p1 = np.full((2, 1), 12, np.int32)
    cache_in = pmodel.cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                       "cpu")
    jout, jcache = jattn.attention(jp, jnp.asarray(x1), acfg,
                                   positions=jnp.asarray(p1), mode="decode",
                                   cache=jcache)
    pout, pcache = attention.attention(pp, _t(x1), pcfg,
                                       positions=torch.from_numpy(p1),
                                       mode="decode", cache=cache_in)
    assert pcache is cache_in
    _close(pout.numpy(), jout, LAYER_RTOL, LAYER_ATOL)
    for k in ("k", "v"):
        _close(pcache[k].numpy(), jcache[k], LAYER_RTOL, LAYER_ATOL)
    assert np.array_equal(pcache["pos"].numpy(), np.asarray(jcache["pos"]))


def test_mamba1_layer_prefill_and_decode_match_jax():
    layer, lc = _layer_params("falcon-mamba-7b", "ssm")
    pcfg = get_reduced("falcon-mamba-7b").stack.pattern[0].ssm
    r = np.random.default_rng(4)
    x = r.normal(size=(2, 20, 64)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, layer)
    pp = {k: _t(v) for k, v in layer.items()}
    jout, jcache = jmamba.mamba1(jp, jnp.asarray(x), lc.ssm, mode="prefill",
                                 cache=None)
    with ops.stats_scope() as s:
        pout, pcache = mamba.mamba1(pp, _t(x), pcfg, mode="prefill",
                                    cache=None)
    assert s.dispatches["selective_scan"] == 1
    _close(pout.numpy(), jout, LAYER_RTOL, LAYER_ATOL)
    for k in ("conv", "state"):
        _close(pcache[k].numpy(), jcache[k], LAYER_RTOL, LAYER_ATOL)
    x1 = r.normal(size=(2, 1, 64)).astype(np.float32)
    jout, jcache2 = jmamba.mamba1(jp, jnp.asarray(x1), lc.ssm, mode="decode",
                                  cache=jcache)
    cache_in = pmodel.cache_from_numpy(jax.tree.map(np.asarray, jcache),
                                       "cpu")
    with ops.stats_scope() as s:
        pout, pcache = mamba.mamba1(pp, _t(x1), pcfg, mode="decode",
                                    cache=cache_in)
    assert pcache is cache_in and not s.dispatches
    _close(pout.numpy(), jout, LAYER_RTOL, LAYER_ATOL)
    for k in ("conv", "state"):
        _close(pcache[k].numpy(), jcache2[k], LAYER_RTOL, LAYER_ATOL)


def test_unported_features_raise():
    """Every layer kind of the JAX package is ported: a ``mamba2`` layer
    gives the JAX package's spec keys, a ``shared`` position owns none (its
    parameters are the stack's shared tree) and an unknown kind raises
    ``ValueError``, as in the JAX package.  Softcap and qk-norm are ported
    (gemma3): a softcap config gives the plain specs, qk-norm adds
    ``q_norm`` and ``k_norm`` of the head dim.  Ring caches (a window
    shorter than the cache) are ported: a 6-token prefill under a window
    of 8 with capacity 12 leaves 8 slots, the last two empty, for decode
    to wrap."""
    from repro.configs.base import LayerCfg as JaxLayerCfg
    from repro.configs.base import Mamba2Cfg as JaxMamba2Cfg
    from repro.models import stack as jax_stack
    from repro_torch.configs.base import Mamba2Cfg
    from repro_torch.models import stack

    m2 = stack.layer_specs(stack.LayerCfg(
        kind="mamba2", ssm=Mamba2Cfg(d_inner=64, d_state=8, head_dim=16)), 32)
    jm2 = jax_stack.layer_specs(JaxLayerCfg(
        kind="mamba2", ssm=JaxMamba2Cfg(d_inner=64, d_state=8, head_dim=16)),
        32)
    assert sorted(m2) == sorted(jm2) == ["ln", "ssm"]
    assert sorted(m2["ssm"]) == sorted(jm2["ssm"])
    for k, spec in jm2["ssm"].items():
        assert m2["ssm"][k].shape == spec.shape, k
    assert stack.layer_specs(stack.LayerCfg(kind="shared"), 32) == {} == \
        jax_stack.layer_specs(JaxLayerCfg(kind="shared"), 32)
    for kind in ("moe", "mamba3"):
        with pytest.raises(ValueError, match=kind):
            stack.layer_specs(stack.LayerCfg(kind=kind), 32)
    capped = attention.AttnCfg(n_heads=2, n_kv=1, head_dim=16, softcap=30.0)
    assert sorted(attention.attn_specs(capped, 32)) == ["wk", "wo", "wq",
                                                        "wv"]
    normed = attention.AttnCfg(n_heads=2, n_kv=1, head_dim=16, qk_norm=True)
    specs = attention.attn_specs(normed, 32)
    assert specs["q_norm"].shape == specs["k_norm"].shape == (16,)
    windowed = attention.AttnCfg(n_heads=2, n_kv=1, head_dim=16, window=8)
    params = {k: torch.zeros(s.shape)
              for k, s in attention.attn_specs(windowed, 32).items()}
    x = torch.zeros((1, 6, 32))
    _, cache = attention.attention(params, x, windowed,
                                   positions=common.default_positions(1, 6),
                                   mode="prefill", cache=None, cache_len=12)
    assert cache["k"].shape == (1, 8, 1, 16)
    assert cache["pos"].tolist() == [[0, 1, 2, 3, 4, 5, -1, -1]]


# ---------------------------------------------------------------------------
# 3-4. the whole model: prefill + decode from the same parameters
# ---------------------------------------------------------------------------


def _run_jax(cfg, params, tokens, steps):
    prefill = jax.jit(jax_prefill_step(cfg, max_len=MAX_LEN))
    decode = jax.jit(jax_decode_step(cfg))
    logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)})
    out = [np.asarray(logits, np.float32)]
    for i, tok in enumerate(steps):
        logits, cache = decode(params, cache,
                               {"tokens": jnp.asarray(tok),
                                "pos": jnp.asarray(T + i, jnp.int32)})
        out.append(np.asarray(logits, np.float32))
    return out, jax.tree.map(lambda a: np.asarray(a, np.float32), cache)


def _run_port(cfg, params, tokens, steps):
    prefill = make_prefill_step(cfg, max_len=MAX_LEN)
    decode = make_decode_step(cfg)
    with ops.stats_scope() as s:
        logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)})
    kernel = "attention" if cfg.family == "dense" else "selective_scan"
    assert s.dispatches[kernel] == cfg.n_layers     # one per layer
    out = [logits.float().numpy()]
    for i, tok in enumerate(steps):
        with ops.stats_scope() as s:
            logits, cache = decode(params, cache,
                                   {"tokens": torch.from_numpy(tok),
                                    "pos": T + i})
        assert not s.dispatches                        # decode stays plain
        out.append(logits.float().numpy())
    return out, pmodel.cache_to_numpy(cache)


def _whole_model(arch, f32: bool):
    jcfg, pcfg = jax_reduced(arch), get_reduced(arch)
    if f32:
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        pcfg = dataclasses.replace(pcfg, compute_dtype=torch.float32)
    params = jax_init(jax_specs(jcfg), jax.random.PRNGKey(0))
    ported = pmodel.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    r = np.random.default_rng(0)
    tokens = r.integers(0, jcfg.vocab, (B, T)).astype(np.int32)
    steps = r.integers(0, jcfg.vocab, (DECODE_STEPS, B)).astype(np.int32)
    return (_run_jax(jcfg, params, tokens, steps),
            _run_port(pcfg, ported, tokens, steps))


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_float32_matches_jax(arch):
    (jlogits, jcache), (plogits, pcache) = _whole_model(arch, f32=True)
    for j, p in zip(jlogits, plogits):
        _close(p, j, 1e-4, 1e-4)
    jflat, pflat = _flat(jcache), _flat(pcache)
    assert sorted(jflat) == sorted(pflat)
    for path, leaf in jflat.items():
        if path.endswith("pos"):
            assert np.array_equal(pflat[path], leaf), path
        else:
            _close(pflat[path], leaf, 1e-4, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_whole_model_bfloat16_matches_jax(arch):
    (jlogits, jcache), (plogits, pcache) = _whole_model(arch, f32=False)
    for j, p in zip(jlogits, plogits):
        _close(p, j, 0.0, 0.1)
    jflat, pflat = _flat(jcache), _flat(pcache)
    assert sorted(jflat) == sorted(pflat)
    for path, leaf in jflat.items():
        if path.endswith("pos"):
            assert np.array_equal(pflat[path], leaf), path
        else:
            _close(pflat[path], leaf, 0.0, 0.1)


# ---------------------------------------------------------------------------
# 5. the serve entry point
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_runs_on_the_cpu_when_asked(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out["tokens"].shape == (2, 3)
    assert out["device"] == "cpu" and out["prefill_tok_s"] > 0
    printed = capsys.readouterr().out
    assert "prefill:" in printed and "decode:" in printed


def test_serve_defaults_to_the_card(monkeypatch):
    """Without --device the launcher asks for the card and raises where
    there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--gen", "2"])
