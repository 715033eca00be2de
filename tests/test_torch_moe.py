"""The PyTorch port's MoE family (mixtral-8x22b, arctic-480b) and the full
config registry, against the JAX package, on the CPU.

* ``moe()`` on the reduced mixtral and arctic layers (d 64, 4 experts, top
  2, arctic's dense residual MLP), on 2 x 512 numpy tokens: 4 groups of
  256, at the configs' capacity factor of 4.0 (no drops) and at 0.5
  (capacity 64: a quarter of the assignments dropped, among them slots of
  the last expert whose destinations lie past E * cap).  ``top_idx``,
  ``pos`` and ``keep`` equal exactly; the data's smallest gap between the
  k-th and (k+1)-th logit exceeds 1e-4, so no near-tie decides a route.
  The gates within 1e-6: the router's float32 product sums in another
  order in XLA than in PyTorch (~1e-7 of a logit), and the two softmaxes
  differ by an ulp even on equal logits.  ``y`` within rtol 1e-5 and 1e-5
  of its largest magnitude; ``load_balance_loss`` within 1e-6.
* ``group_count`` and ``capacity`` equal over a sweep of token counts.
* The JAX package's own MoE properties (``tests/test_models.py``) on the
  port: distinct experts and gates summing to 1, the per-token dense
  oracle with no drops (atol 1e-4, rtol 1e-3 as there), the uniform and
  collapsed load-balance losses, and drops within capacity.
* The reduced models (mixtral's window of 8, rings wrapping; arctic's
  dense residual): train logits, prefill + decode with every cache leaf,
  and one train step under remat none and full, at the tolerances of
  ``tests/_torch_parity.py``.
* The registry: all ten archs, ``cells()`` equal to the JAX package's,
  every arch's parameter specs and count equal (mixtral 140.63 B, arctic
  476.85 B); the full configs' MoE widths.
* Both entry points on the reduced MoE models with ``--device cpu``.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import _torch_parity as par  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist.sharding import init_params as jax_init  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import model_cache_specs as jax_cache_specs  # noqa: E402
from repro.models.model import model_specs as jax_specs  # noqa: E402
from repro_torch import configs as pconfigs  # noqa: E402
from repro_torch.configs.base import MoECfg  # noqa: E402
from repro_torch.dist.sharding import init_params, param_count  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402

ARCHS = ("mixtral-8x22b", "arctic-480b")
D = 64


def _moe_cfg(arch, cf):
    return dataclasses.replace(
        pconfigs.get_reduced(arch).stack.pattern[0].moe, capacity_factor=cf)


def _jax_moe_cfg(arch, cf):
    return dataclasses.replace(
        jconfigs.get_reduced(arch).stack.pattern[0].moe, capacity_factor=cf)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_routing_and_output_match_jax(arch, cf):
    jcfg, pcfg = _jax_moe_cfg(arch, cf), _moe_cfg(arch, cf)
    params = jax_init(jmoe.moe_specs(jcfg, D), jax.random.PRNGKey(1))
    x = np.random.default_rng(0).standard_normal((2, 512, D)).astype(
        np.float32)
    want_y, want = jmoe.moe(params, jnp.asarray(x), jcfg, return_aux=True)
    pp = pmodel.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    got_y, got = pmoe.moe(pp, torch.from_numpy(x), pcfg, return_aux=True)

    e, k = pcfg.n_experts, pcfg.top_k
    g = pmoe.group_count(1024)
    cap = pmoe.capacity(pcfg, 1024 // g)
    logits = pmoe.route(pp, torch.from_numpy(x).reshape(g, -1, D), pcfg)[0]
    top = np.sort(logits.reshape(-1, e).numpy(), -1)[:, ::-1]
    assert (top[:, k - 1] - top[:, k]).min() > 1e-4
    assert g == 4
    for name in ("top_idx", "pos"):
        assert np.array_equal(got[name].numpy(), np.asarray(want[name])), name
    keep = np.asarray(want["pos"]) < cap
    assert float(got["kept_fraction"]) == keep.mean()
    if cf < 1:
        last = (np.asarray(want["top_idx"]) == e - 1) & ~keep
        assert last.any() and (~keep).mean() > 0.1
        # a dropped slot of the last expert indexes past E * cap
        past = np.asarray(want["top_idx"]) * cap + np.asarray(want["pos"])
        assert (past[last] >= e * cap).any()
    else:
        assert keep.all()
    np.testing.assert_allclose(got["gates"].numpy(),
                               np.asarray(want["gates"]), rtol=0, atol=1e-6)
    par.close(got_y, want_y, 1e-5, 1e-5)
    assert float(got["kept_fraction"]) == float(want["kept_fraction"])
    np.testing.assert_allclose(float(got["load_balance_loss"]),
                               float(want["load_balance_loss"]), atol=1e-6)
    np.testing.assert_allclose(float(got["router_entropy"]),
                               float(want["router_entropy"]), rtol=1e-5)


def test_group_count_and_capacity_match_jax():
    cfgs = [_moe_cfg(a, cf) for a in ARCHS for cf in (4.0, 1.25, 0.5)]
    cfgs += [pconfigs.get_config(a).stack.pattern[0].moe for a in ARCHS]
    for n in (1, 2, 3, 4, 7, 100, 255, 256, 257, 512, 999, 1024, 4096,
              6144, 8192, 12288, 32768, 65536, 131072):
        g = pmoe.group_count(n)
        assert g == jmoe.group_count(n), n
        for want_g in (1, 5, 32):
            assert pmoe.group_count(n, want_g) == jmoe.group_count(n, want_g)
        for cfg in cfgs:
            jcfg = jconfigs.base.MoECfg(**dataclasses.asdict(cfg))
            assert pmoe.capacity(cfg, n // g) == jmoe.capacity(jcfg, n // g)
    # the prefill shapes on the card: mixtral 4 x 8,192, arctic 4 x 4,096
    assert pmoe.group_count(4 * 8192) == 32
    assert pmoe.capacity(pconfigs.get_config(ARCHS[0]).stack.pattern[0].moe,
                         1024) == 320
    assert pmoe.capacity(pconfigs.get_config(ARCHS[1]).stack.pattern[0].moe,
                         512) == 12


# ---------------------------------------------------------------------------
# the JAX package's MoE properties, on the port
# ---------------------------------------------------------------------------


def _port_moe(cfg, d=16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return init_params(pmoe.moe_specs(cfg, d), gen, "cpu")


def test_moe_conservation_and_gates():
    cfg = MoECfg(n_experts=8, top_k=2, d_ff=32, capacity_factor=8.0)
    p = _port_moe(cfg)
    x = torch.randn((2, 16, 16), generator=torch.Generator().manual_seed(1))
    y, aux = pmoe.moe(p, x, cfg, return_aux=True)
    assert float(aux["kept_fraction"]) == 1.0
    idx = aux["top_idx"].numpy()
    assert (idx[:, 0] != idx[:, 1]).all()
    np.testing.assert_allclose(aux["gates"].sum(-1).numpy(), 1.0, atol=1e-5)


def test_moe_matches_dense_oracle():
    cfg = MoECfg(n_experts=4, top_k=2, d_ff=8, capacity_factor=16.0)
    d = 8
    p = _port_moe(cfg, d)
    x = torch.randn((1, 8, d), generator=torch.Generator().manual_seed(2))
    y = pmoe.moe(p, x, cfg)
    logits = (x @ p["router"])[0].numpy()
    xf = x[0].numpy()
    wg, wu, wd = (p[k].numpy() for k in ("w_gate", "w_up", "w_down"))
    want = np.zeros_like(xf)
    for t in range(8):
        top = np.argsort(-logits[t])[:2]
        gate = np.exp(logits[t][top] - logits[t][top].max())
        gate = gate / gate.sum()
        for gi, e in zip(gate, top):
            h = xf[t] @ wg[e]
            h = h / (1 + np.exp(-h)) * (xf[t] @ wu[e])
            want[t] += gi * (h @ wd[e])
    np.testing.assert_allclose(y[0].numpy(), want, atol=1e-4, rtol=1e-3)


def test_load_balance_loss_minimized_at_uniform():
    e = 8
    lg = torch.zeros((2, 16, e))
    ti = torch.stack([torch.arange(16) % e, (torch.arange(16) + 1) % e],
                     -1)[None].repeat(2, 1, 1)
    uniform = float(pmoe.load_balance_loss(lg, ti))
    assert abs(uniform - 1.0) < 1e-5
    assert uniform == pytest.approx(float(jmoe.load_balance_loss(
        jnp.asarray(lg.numpy()), jnp.asarray(ti.numpy()))), abs=1e-6)
    ti_bad = torch.zeros((2, 16, 2), dtype=torch.int64)
    lg_bad = torch.zeros((2, 16, e))
    lg_bad[..., 0] = 5.0
    assert float(pmoe.load_balance_loss(lg_bad, ti_bad)) > 3.0


@pytest.mark.parametrize("seed,cf", [(0, 0.25), (1, 0.6), (2, 1.0),
                                     (3, 1.4), (4, 2.0)])
def test_moe_capacity_drops_bounded(seed, cf):
    cfg = MoECfg(n_experts=4, top_k=2, d_ff=8, capacity_factor=cf)
    p = _port_moe(cfg, 8, seed)
    x = torch.randn((1, 32, 8), generator=torch.Generator().manual_seed(seed))
    y, aux = pmoe.moe(p, x, cfg, return_aux=True)
    kept = float(aux["kept_fraction"])
    assert 0.0 < kept <= 1.0
    cap = pmoe.capacity(cfg, 32)
    kmask = aux["pos"].numpy() < cap
    assert kept == pytest.approx(kmask.mean(), abs=1e-6)
    assert torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_holds_every_arch_and_cell():
    assert list(pconfigs.ARCHS) == list(jconfigs.ARCHS)
    assert len(pconfigs.ARCHS) == 10
    for inc in (False, True):
        assert list(pconfigs.cells(inc)) == list(jconfigs.cells(inc))
    assert ("arctic-480b", "long_500k") not in list(pconfigs.cells())


@pytest.mark.parametrize("arch", list(jconfigs.ARCHS))
def test_param_specs_and_counts_match_jax(arch):
    jcfg, pcfg = jconfigs.get_config(arch), pconfigs.get_config(arch)
    assert (pcfg.family, pcfg.n_layers) == (jcfg.family, jcfg.n_layers)
    specs = pmodel.model_specs(pcfg)
    par.same_specs(jax_specs(jcfg), specs)
    from repro.dist.sharding import param_count as jax_count
    assert param_count(specs) == jax_count(jax_specs(jcfg))
    rj, rp = jconfigs.get_reduced(arch), pconfigs.get_reduced(arch)
    par.same_specs(jax_specs(rj), pmodel.model_specs(rp))


@pytest.mark.parametrize("arch,d,h,kv,ff,e,window,res,n", [
    ("mixtral-8x22b", 6144, 48, 8, 16384, 8, 4096, None, 140_630_071_296),
    ("arctic-480b", 7168, 56, 8, 4864, 128, None, 4864, 476_850_275_328)])
def test_full_moe_configs(arch, d, h, kv, ff, e, window, res, n):
    cfg = pconfigs.get_config(arch)
    lc = cfg.stack.pattern[0]
    assert (cfg.d_model, lc.attn.n_heads, lc.attn.n_kv, lc.attn.head_dim,
            lc.attn.window) == (d, h, kv, 128, window)
    assert (lc.moe.d_ff, lc.moe.n_experts, lc.moe.top_k,
            lc.moe.dense_residual_ff) == (ff, e, 2, res)
    assert not cfg.tie_embeddings
    specs = pmodel.model_specs(cfg)
    assert param_count(specs) == n
    w = specs["stack"]["groups"]["p0"]["ffn"]["w_gate"]
    assert w.shape == (cfg.stack.n_groups, e, d, ff)
    par.same_specs(jax_cache_specs(jconfigs.get_config(arch), 4, 8224),
                   pmodel.model_cache_specs(cfg, 4, 8224))


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_logits_match_jax(arch):
    par.check_train_logits(arch)


@pytest.mark.parametrize("arch,t,cache_len", [
    ("mixtral-8x22b", 16, 16 + par.DECODE_STEPS),
    ("arctic-480b", 16, 16 + par.DECODE_STEPS)])
def test_prefill_and_decode_caches_match_jax(arch, t, cache_len):
    """mixtral's window of 8: prefill leaves rings of 8 slots (slot p % 8
    holds position p), which the 9 decode steps wrap; arctic keeps full
    caches of ``cache_len``."""
    pre, last = par.check_prefill_decode(arch, t, cache_len)
    window = 8 if arch.startswith("mixtral") else None
    slots = window or cache_len
    for caches, upto in ((pre, t - 1), (last, t + par.DECODE_STEPS - 1)):
        pos = caches["groups/p0/self/pos"]
        assert pos.shape == (2, par.B, slots)
        live = np.arange(max(0, upto - slots + 1), upto + 1)
        want = np.full(slots, -1)
        want[live % slots] = live
        assert (pos == want).all()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_jax(arch, remat):
    """Loss, every gradient (the router's and each expert's among them,
    arctic's residual MLP's too) and one AdamW step."""
    grads = par.check_train_step(arch, remat)
    assert "stack/groups/p0/ffn/router" in grads
    assert ("stack/groups/p0/ffn/res_w_down" in grads) == \
        arch.startswith("arctic")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_numpy(arch):
    """params_to_numpy and params_from_numpy carry the MoE tree across and
    back bit for bit, bfloat16 included."""
    s = par.setup(arch)
    for dtype in (None, torch.bfloat16):
        p = pmodel.params_from_numpy(s["np_params"], "cpu", dtype)
        back = pmodel.params_to_numpy(p)
        again = pmodel.params_from_numpy(back, "cpu")
        fp, fa = par.flat(p), par.flat(again)
        assert sorted(fp) == sorted(par.flat(s["np_params"]))
        for path, t in fp.items():
            assert t.dtype == fa[path].dtype and torch.equal(t, fa[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_run_moe_on_the_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "13", "--gen", "12"])
    assert out["tokens"].shape == (2, 12) and out["device"] == "cpu"
    assert "decode:" in capsys.readouterr().out
    out = train_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    assert sorted(out["losses"]) == [1, 2]
    assert np.isfinite(list(out["losses"].values())).all()
