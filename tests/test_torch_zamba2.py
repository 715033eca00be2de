"""The PyTorch port's hybrid family (zamba2-2.7b: Mamba2 layers and a shared
attention block) against the JAX package, on the CPU.

* The full config: 54 layers = 9 x (5 Mamba2 + 1 shared block), its
  parameter specs and count (1.98 B) and its caches equal to the JAX
  package's; the shared block's parameters sit once under
  ``stack/shared``, its KV cache once per occurrence.
* One Mamba2 layer (d_inner 128, state 16, head dim 16, chunk 16, d 64)
  in train mode over 2 chunks, prefill over a prompt of 20 (chunks of
  10), and 6 decode steps, outputs and caches, within rtol 1e-4 and 1e-4
  of each leaf's largest magnitude (float32; the chunked sums run in
  another order).
* The reference's fault pinned: at chunk 128 (zamba2's) the JAX
  package's gradient of sum(y^2) over 1 x 128 tokens holds NaN (its decay
  matrix overflows to inf above the diagonal, and the backward multiplies
  a zero cotangent by it); the port's is finite and matches the JAX
  gradient at chunk 16, the same function summed in other chunks, within
  rtol 1e-4 and 1e-4 of each leaf's scale (3.6e-6 measured); the losses
  within 1e-5.
* The chunked scan (``_ssd``) in slabs of 1, 2 and 3 chunks against one
  slab: outputs, final state and, under checkpoint, the gradients,
  within rtol 1e-5 and 1e-6 of each tensor's scale.
* The reduced model (two groups of Mamba2, Mamba2, shared block): train
  logits, prefill + decode with every cache leaf (the shared block's
  per-occurrence KV caches and the Mamba2 conv and state caches), one
  train step under remat none and full, at the tolerances of
  ``tests/_torch_parity.py``; the port's remat "dots" step gives the
  "none" step's loss and gradients (1e-6 of each leaf's scale), the
  shared block's included.
* Both entry points on the reduced model with ``--device cpu``.
"""
import pytest

torch = pytest.importorskip("torch")

import _torch_parity as par  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs.base import Mamba2Cfg as JaxMamba2Cfg  # noqa: E402
from repro.dist.sharding import init_params as jax_init  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models.model import model_cache_specs as jax_cache_specs  # noqa: E402
from repro.models.model import model_specs as jax_specs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import Mamba2Cfg  # noqa: E402
from repro_torch.dist.sharding import param_count  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import mamba as pmamba  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.train.step import StepCfg, loss_and_grads  # noqa: E402

ARCH = "zamba2-2.7b"


def test_full_config_specs_and_caches_match_jax():
    cfg = get_config(ARCH)
    st = cfg.stack
    assert (cfg.n_layers, st.n_groups, cfg.d_model, cfg.vocab,
            cfg.family) == (54, 9, 2560, 32000, "hybrid")
    assert [lc.kind for lc in st.pattern] == ["mamba2"] * 5 + ["shared"]
    ssm = st.pattern[0].ssm
    assert (ssm.d_inner, ssm.d_state, ssm.head_dim, ssm.chunk) == \
        (5120, 64, 64, 128)
    a = st.shared.attn
    assert (a.n_heads, a.n_kv, a.head_dim, st.shared.mlp.d_ff) == \
        (32, 32, 80, 10240)
    specs = pmodel.model_specs(cfg)
    par.same_specs(jax_specs(jax_config(ARCH)), specs)
    assert sorted(specs["stack"]["groups"]) == [f"p{i}" for i in range(5)]
    assert specs["stack"]["shared"]["attn"]["wq"].shape == (2560, 32, 80)
    assert round(param_count(specs) / 1e9, 2) == 1.98
    js = jax_cache_specs(jax_config(ARCH), 4, 4127)
    ps = pmodel.model_cache_specs(cfg, 4, 4127)
    par.same_specs(js, ps)
    assert ps["groups"]["p5"]["self"]["k"].shape == (9, 4, 4127, 32, 80)
    assert ps["groups"]["p0"]["ssm"]["state"].shape == (9, 4, 80, 64, 64)
    assert ps["groups"]["p0"]["ssm"]["conv"].shape == (9, 4, 3, 5248)


def _layer(chunk=16, d_inner=128, d_state=16, head_dim=16, d=64, seed=0):
    jcfg = JaxMamba2Cfg(d_inner=d_inner, d_state=d_state, head_dim=head_dim,
                        chunk=chunk)
    pcfg = Mamba2Cfg(d_inner=d_inner, d_state=d_state, head_dim=head_dim,
                     chunk=chunk)
    params = jax_init(jmamba.mamba2_specs(jcfg, d), jax.random.PRNGKey(seed))
    return jcfg, pcfg, params, pmodel.params_from_numpy(
        jax.tree.map(np.asarray, params), "cpu")


def test_mamba2_layer_matches_jax():
    """Train over 32 steps (2 chunks); prefill of 20 (chunks of 10), its
    conv tail and state; 6 decode steps from that cache, every output and
    the cache after them."""
    jcfg, pcfg, jp, pp = _layer()
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 32, 64)).astype(np.float32)
    want, _ = jmamba.mamba2(jp, jnp.asarray(x), jcfg, mode="train",
                            cache=None)
    got, none = pmamba.mamba2(pp, torch.from_numpy(x), pcfg, mode="train",
                              cache=None)
    assert none is None
    par.close(got, want)

    want, jc = jmamba.mamba2(jp, jnp.asarray(x[:, :20]), jcfg,
                             mode="prefill", cache=None)
    got, pc = pmamba.mamba2(pp, torch.from_numpy(x[:, :20]), pcfg,
                            mode="prefill", cache=None)
    par.close(got, want)
    assert sorted(pc) == ["conv", "state"] and pc["conv"].shape == (2, 3, 160)
    for k in pc:
        par.close(pc[k], jc[k])
    for i in range(20, 26):
        want, jc = jmamba.mamba2(jp, jnp.asarray(x[:, i:i + 1]), jcfg,
                                 mode="decode", cache=jc)
        got, pc = pmamba.mamba2(pp, torch.from_numpy(x[:, i:i + 1]), pcfg,
                                mode="decode", cache=pc)
        par.close(got, want)
    for k in pc:
        par.close(pc[k], jc[k])


def _sum_sq_grads_jax(cfg, params, x):
    return jax.value_and_grad(lambda p: (jmamba.mamba2(
        p, x, cfg, mode="train", cache=None)[0] ** 2).sum())(params)


def test_mamba2_gradient_finite_at_full_chunk():
    """The JAX package's NaN at chunk 128, pinned; the port's repair."""
    jcfg, pcfg, jp, pp = _layer(128, 32, 8, 8, 16)
    x = np.random.default_rng(0).standard_normal((1, 128, 16)).astype(
        np.float32)
    loss_128, g_128 = _sum_sq_grads_jax(jcfg, jp, jnp.asarray(x))
    assert np.isfinite(float(loss_128))
    nan = {k for k, v in g_128.items() if not np.isfinite(v).all()}
    assert {"A_log", "dt_bias", "in_proj"} <= nan
    loss_16, g_16 = _sum_sq_grads_jax(JaxMamba2Cfg(
        d_inner=32, d_state=8, head_dim=8, chunk=16), jp, jnp.asarray(x))
    assert all(np.isfinite(v).all() for v in g_16.values())

    live = {k: v.requires_grad_(True) for k, v in pp.items()}
    y, _ = pmamba.mamba2(live, torch.from_numpy(x), pcfg, mode="train",
                         cache=None)
    loss = (y ** 2).sum()
    grads = dict(zip(live, torch.autograd.grad(loss, list(live.values()))))
    assert all(torch.isfinite(g).all() for g in grads.values())
    par.close(loss.detach(), loss_16, 1e-5, 0)
    par.close(loss.detach(), loss_128, 1e-5, 0)
    for k, g in grads.items():
        par.close(g, g_16[k])


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------


def _ssd_inputs(bsz=2, t=80, nh=3, p=4, n=5):
    r = np.random.default_rng(2)

    def f(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(r.uniform(lo, hi, shape).astype(np.float32))

    delta = f(bsz, t, nh, lo=0.05, hi=1.0)
    da = delta * -f(nh, lo=0.5, hi=1.5)
    return [f(bsz, nh, p, n), da, f(bsz, t, nh, p), f(bsz, t, n),
            f(bsz, t, n), delta]


@pytest.mark.parametrize("chunks_a_slab", [1, 2, 3])
def test_mamba2_slabs_match_one_slab(chunks_a_slab):
    """``_ssd`` over 8 chunks of 10 from a nonzero state, in slabs of 1, 2
    and 3 chunks (the last one short), against the whole sequence in one
    slab: y and the final state, and with ``grad`` (each slab under
    checkpoint) the gradients of sum(y^2) + sum(s^2) with respect to every
    input, within rtol 1e-5 and 1e-6 of each tensor's scale."""
    ins = _ssd_inputs()
    bsz, nh, tc = 2, 3, 10
    slab = chunks_a_slab * bsz * tc * tc * nh

    def run(slab_elems, grad):
        xs = [a.clone().requires_grad_(grad) for a in ins]
        s, y = pmamba._ssd(*xs, tc, grad=grad, slab_elems=slab_elems)
        if not grad:
            return [s, y]
        loss = (y ** 2).sum() + (s ** 2).sum()
        return [s, y, *torch.autograd.grad(loss, xs)]

    for grad in (False, True):
        whole, slabbed = run(1 << 40, grad), run(slab, grad)
        for a, b in zip(slabbed, whole):
            a, b = a.detach(), b.detach()
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-6 * float(b.abs().max()))


def test_train_logits_match_jax():
    par.check_train_logits(ARCH)


@pytest.mark.parametrize("t", [16, 13])
def test_prefill_and_decode_caches_match_jax(t):
    """The shared block's KV cache per occurrence (p2 of each group: full
    caches of T + 9 slots, different in each group), the Mamba2 layers'
    conv tails and states; 9 decode steps."""
    cache_len = t + par.DECODE_STEPS
    pre, last = par.check_prefill_decode(ARCH, t, cache_len)
    for caches, upto in ((pre, t - 1), (last, cache_len - 1)):
        k = caches["groups/p2/self/k"]
        assert k.shape == (2, par.B, cache_len, 4, 16)
        assert not np.allclose(k[0, :, :upto + 1], k[1, :, :upto + 1])
        want = np.full(cache_len, -1)
        want[:upto + 1] = np.arange(upto + 1)
        assert (caches["groups/p2/self/pos"] == want).all()
        assert caches["groups/p0/ssm/state"].shape == (2, par.B, 8, 16, 16)
    assert "shared" not in {p.split("/")[0] for p in pre}


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_jax(remat):
    """Loss, every gradient (the shared block's, summed over its two
    occurrences, and the Mamba2 layers') and one AdamW step."""
    grads = par.check_train_step(ARCH, remat)
    assert "stack/shared/attn/wq" in grads
    assert "stack/groups/p0/ssm/A_log" in grads


def test_remat_dots_sees_the_shared_parameters():
    ref = par.jax_step(ARCH)
    cfg = par.port_cfg(ARCH)
    params = pmodel.params_from_numpy(ref["state"]["params"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, grads = loss_and_grads(cfg, StepCfg(remat="none"), params, batch)
    d_loss, d_grads = loss_and_grads(cfg, StepCfg(remat="dots"), params,
                                     batch)
    par.close(d_loss, loss, 1e-6, 0)
    want, got = par.flat(grads), par.flat(d_grads)
    assert float(want["stack/shared/ffn/w_up"].abs().max()) > 0
    for path, w in want.items():
        par.close(got[path], w, 1e-6, 1e-6)


def test_entry_points_run_zamba2_on_the_cpu(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "13", "--gen", "12"])
    assert out["tokens"].shape == (2, 12) and out["device"] == "cpu"
    assert "decode:" in capsys.readouterr().out
    out = train_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    assert sorted(out["losses"]) == [1, 2]
    assert np.isfinite(list(out["losses"].values())).all()
