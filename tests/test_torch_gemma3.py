"""The PyTorch port's gemma3 slice (gemma3-4b, gemma3-12b) against the JAX
package, on the CPU: the full configs' specs (qk-norm's ``q_norm`` and
``k_norm``), parameter counts and caches (rings at the local positions,
full caches at the global ones, the 4b's tail); the reduced models' (head
dim 16, window 8, the pattern local, local, global) train-mode logits, as
configured, with the global layers' RoPE theta at 10^6 and with a softcap
of 30 on every layer; prefill + decode through the mixed ring and full
caches slot by slot; one train step under remat none and full; and both
entry points.  Each from the JAX package's parameters carried across and
the same numpy tokens.  On the CPU attention takes the plain versions
(with grad ``ops.AttentionFn`` and its explicit plain backward), the
formula the card's flash kernels compute, windowed or causal, capped or
not.

The three prefill cases reach the JAX package's ways of attending over a
prompt and both of its cache rules, at the local layers:

* T = 16 = 2 windows: ``_sdpa_banded``; the ring of the last 8 positions
  (``_ring_tail``);
* T = 13: ``_sdpa_full``; a ring tail rolled by 13 - 8 = 5 slots;
* T = 6 with ``cache_len`` 20: ``_sdpa_full``; the prompt padded to 8
  slots (the window), which decode fills and then wraps.

The global layers keep full caches of ``cache_len`` slots (T + 9 for the
first two).  Each case runs DECODE_STEPS = 9 decode steps, more than the
ring's 8 slots, so every ring wraps at least once.

Tolerances, with their reasons (as ``tests/test_torch_danube.py``):

* float32 logits and caches: rtol 1e-4 and atol 1e-4 times the leaf's
  largest magnitude (the JAX init's fan-in^-1/2 weights over the group
  axis make softmax rows near one-hot, which carries one-ulp differences
  of summation order well past 1e-5 of a leaf's scale); cache positions
  exactly.
* float32 gradients: rtol 1e-3 and atol 1e-3 times the leaf's largest
  magnitude; loss rtol 1e-5; after one AdamW step m within atol 2e-3 and
  v 4e-3 times the leaf's scale, parameters in units of lr as whisper's
  test bounds them.  A wrong or missing gradient term, a missing norm or
  cap, or a mask that lets a key outside the window in, is an order-one
  error.
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
from repro.models.losses import xent as jax_xent  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import model_cache_specs as jax_cache_specs  # noqa: E402
from repro.models.model import model_specs as jax_specs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.dist.sharding import param_count  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train.step import (StepCfg, loss_and_grads,  # noqa: E402
                                    make_decode_step, make_prefill_step,
                                    make_train_step)

ARCHS = ("gemma3-4b", "gemma3-12b")
B, T, W, DECODE_STEPS = 2, 16, 8, 9
LR, EPS = 1e-3, 1e-8
TOL, GRAD_TOL = 1e-4, 1e-3
SOFTCAP, GLOBAL_THETA = 30.0, 1_000_000.0


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=TOL, atol_scale=TOL):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want),
                                                             np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale)


def _same_specs(jtree, ptree):
    js, ps = _flat(jtree), _flat(ptree)
    assert sorted(js) == sorted(ps)
    for path, s in js.items():
        assert (ps[path].shape, ps[path].axes) == (s.shape, s.axes), path
        assert str(ps[path].dtype).split(".")[-1] == \
            np.dtype(s.dtype).name, path
        assert ps[path].init == s.init, path


def _vary(cfg, variant):
    """``cfg`` (either package's) with the global layers' theta at 10^6
    ("theta") or a softcap on every layer ("softcap"); as is for None."""
    def layer(lc):
        a = lc.attn
        if variant == "theta" and a.window is None:
            a = dataclasses.replace(a, rope_theta=GLOBAL_THETA)
        if variant == "softcap":
            a = dataclasses.replace(a, softcap=SOFTCAP)
        return dataclasses.replace(lc, attn=a)

    st = cfg.stack
    return dataclasses.replace(cfg, stack=dataclasses.replace(
        st, pattern=tuple(map(layer, st.pattern)),
        tail=tuple(map(layer, st.tail))))


@pytest.mark.parametrize("arch,layers,groups,tail,d,h,kv,ff,n_lo,n_hi", [
    ("gemma3-4b", 34, 5, 4, 2560, 8, 4, 10240, 3.8e9, 4.0e9),
    ("gemma3-12b", 48, 8, 0, 3840, 16, 8, 15360, 11.7e9, 11.9e9)])
def test_full_specs_and_caches_match_jax(arch, layers, groups, tail, d, h,
                                         kv, ff, n_lo, n_hi):
    """gemma3 at full size (hf:google/gemma-3-*-pt): five local layers
    (window 1,024, theta 10^4) and one global (no window, theta 10^6) a
    group, head dim 256, qk-norm, tied embeddings scaled by sqrt(d); a
    cache for 4,128 positions is a ring of 1,024 slots at each local
    position and 4,128 slots at each global one, as the JAX package's."""
    jcfg, pcfg = jax_config(arch), get_config(arch)
    st = pcfg.stack
    assert (pcfg.n_layers, st.n_groups, len(st.tail), pcfg.d_model,
            pcfg.vocab) == (layers, groups, tail, d, 262144)
    assert pcfg.tie_embeddings and pcfg.embed_scale
    for i, lc in enumerate(st.pattern + st.tail):
        a = lc.attn
        local = i % 6 != 5
        assert (a.n_heads, a.n_kv, a.head_dim, a.qk_norm) == (h, kv, 256,
                                                              True)
        assert (a.window, a.rope_theta) == ((1024, 1e4) if local
                                            else (None, 1e6))
        assert lc.mlp.d_ff == ff
    specs = pmodel.model_specs(pcfg)
    _same_specs(jax_specs(jcfg), specs)
    assert specs["stack"]["groups"]["p0"]["attn"]["q_norm"].shape == \
        (groups, 256)
    n = param_count(specs)
    assert n_lo < n < n_hi
    js = jax_cache_specs(jcfg, 4, 4128)
    ps = pmodel.model_cache_specs(pcfg, 4, 4128)
    _same_specs(js, ps)
    groups_c = ps["groups"]
    for i in range(6):
        slots = 4128 if i == 5 else 1024
        assert groups_c[f"p{i}"]["self"]["k"].shape == \
            (groups, 4, slots, kv, 256)
    for i in range(tail):
        assert ps["tail"][f"t{i}"]["self"]["pos"].shape == (4, 1024)


_JAX: dict = {}


def _setup(arch):
    if arch not in _JAX:
        jcfg = dataclasses.replace(jax_reduced(arch),
                                   compute_dtype=jnp.float32)
        params = jax_init(jax_specs(jcfg), jax.random.PRNGKey(0))
        r = np.random.default_rng(0)
        tok = r.integers(0, jcfg.vocab, (B, T + 1)).astype(np.int32)
        _JAX[arch] = dict(
            cfg=jcfg, params=params,
            np_params=jax.tree.map(np.asarray, params),
            tokens=tok[:, :-1], labels=tok[:, 1:],
            steps=r.integers(0, jcfg.vocab, (DECODE_STEPS, B)).astype(
                np.int32))
    return _JAX[arch]


def _pcfg(arch):
    return dataclasses.replace(get_reduced(arch), compute_dtype=torch.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("variant", [None, "theta", "softcap"])
def test_train_logits_match_jax(arch, variant):
    """T = 16 is two windows: the JAX package attends in banded form at
    the local layers and in full at the global ones, the port through the
    windowed and causal attention (the flash kernels' masks); qk-norm on
    every layer, the 4b's tail layer after the groups."""
    s = _setup(arch)
    jcfg, pcfg = _vary(s["cfg"], variant), _vary(_pcfg(arch), variant)
    assert [lc.attn.window for lc in pcfg.stack.pattern] == [W, W, None]
    fwd = jax.jit(lambda p, t: jax_forward(p, jcfg, t, mode="train"))
    want = fwd(s["params"], jnp.asarray(s["tokens"]))
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    with ops.stats_scope() as st:
        got = pmodel.forward(params, pcfg, torch.from_numpy(s["tokens"]),
                             mode="train")
    assert st.dispatches["attention"] == pcfg.n_layers
    _close(got, want)
    if variant is not None:      # the variant moves the logits past TOL
        plain = jax.jit(lambda p, t: jax_forward(p, s["cfg"], t,
                                                 mode="train"))(
            s["params"], jnp.asarray(s["tokens"]))
        assert float(jnp.abs(plain - want).max()) > \
            10 * TOL * float(jnp.abs(want).max())


@pytest.mark.parametrize("arch,t,cache_len,clen", [
    ("gemma3-4b", 16, T + DECODE_STEPS, 8),
    ("gemma3-4b", 13, 13 + DECODE_STEPS, 8),
    ("gemma3-4b", 6, 20, 8),
    ("gemma3-12b", 16, T + DECODE_STEPS, 8)])
def test_prefill_and_decode_caches_match_jax(arch, t, cache_len, clen):
    """Prefill's last logits and caches, then DECODE_STEPS decode steps
    that wrap the rings: every step's logits, and after prefill and after
    the last step every layer's k, v and pos slot by slot — the rings of
    the local positions p0 and p1 and the 4b's tail, the full caches of
    the global position p2."""
    s = _setup(arch)
    tokens = s["tokens"][:, :t]
    jpre = jax.jit(jstep.make_prefill_step(s["cfg"], max_len=cache_len))
    jdec = jax.jit(jstep.make_decode_step(s["cfg"]))
    logits, cache = jpre(s["params"], {"tokens": jnp.asarray(tokens)})
    want, want_caches = [np.asarray(logits)], [jax.tree.map(np.asarray,
                                                            cache)]
    for i, tok in enumerate(s["steps"]):
        logits, cache = jdec(s["params"], cache,
                             {"tokens": jnp.asarray(tok),
                              "pos": jnp.asarray(t + i, jnp.int32)})
        want.append(np.asarray(logits))
    want_caches.append(jax.tree.map(np.asarray, cache))

    cfg = _pcfg(arch)
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    prefill, decode = make_prefill_step(cfg, max_len=cache_len), \
        make_decode_step(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)})
    got = [logits]
    got_caches = [{k: v.copy() for k, v in _flat(pmodel.cache_to_numpy(
        cache)).items()}]
    rings = ["groups/p0/self", "groups/p1/self"] + (
        ["tail/t0/self"] if cfg.stack.tail else [])
    # a ring's layout: slot p % clen holds position p, the last clen ones;
    # a full cache holds the prompt in its first t slots
    live = np.arange(max(t - clen, 0), t)
    ring_pos = np.full(clen, -1)
    ring_pos[live % clen] = live
    full_pos = np.full(cache_len, -1)
    full_pos[:t] = np.arange(t)
    for name in rings:
        assert (got_caches[0][f"{name}/pos"] == ring_pos).all(), name
    assert (got_caches[0]["groups/p2/self/pos"] == full_pos).all()
    for i, tok in enumerate(s["steps"]):
        logits, cache = decode(params, cache, {"tokens": torch.from_numpy(
            tok), "pos": t + i})
        got.append(logits)
    got_caches.append(_flat(pmodel.cache_to_numpy(cache)))
    last = t + DECODE_STEPS - 1
    for name in rings:
        pos = got_caches[1][f"{name}/pos"]
        assert sorted(pos.reshape(-1, clen)[0]) == \
            list(range(last - clen + 1, last + 1)), name
    full_pos[:last + 1] = np.arange(last + 1)
    assert (got_caches[1]["groups/p2/self/pos"] == full_pos).all()
    for g, w in zip(got, want):
        _close(g, w)
    for gflat, wc in zip(got_caches, want_caches):
        wflat = _flat(wc)
        assert sorted(gflat) == sorted(wflat)
        assert gflat["groups/p0/self/k"].shape == (2, B, clen, 2, 16)
        assert gflat["groups/p2/self/k"].shape == (2, B, cache_len, 2, 16)
        for path, leaf in wflat.items():
            if path.endswith("pos"):
                assert np.array_equal(gflat[path], leaf), path
            else:
                _close(gflat[path], leaf)


@pytest.fixture(scope="module")
def jax_step():
    s = _setup("gemma3-4b")
    cfg = s["cfg"]
    opt = jopt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
    state = jstep.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    jb = {"tokens": jnp.asarray(s["tokens"]),
          "labels": jnp.asarray(s["labels"])}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_xent(
        jax_forward(p, cfg, jb["tokens"], mode="train"), jb["labels"])))(
        state["params"])
    out = {"state": jax.tree.map(np.asarray, state),
           "batch": {"tokens": s["tokens"], "labels": s["labels"]},
           "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}
    for remat in ("none", "full"):
        step = jax.jit(jstep.make_train_step(cfg, opt,
                                             jstep.StepCfg(remat=remat)))
        out[remat] = jax.tree.map(np.asarray, step(state, jb))
    return out


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_jax(jax_step, remat):
    """gemma3-4b-reduced: loss, gradients (q_norm and k_norm's and the
    tied, scaled embedding's among them) and one AdamW step over two
    windows of tokens."""
    ref = jax_step
    cfg = _pcfg("gemma3-4b")
    opt = popt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
    state = pmodel.train_state_from_numpy(ref["state"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    step_cfg = StepCfg(remat=remat)

    loss, grads = loss_and_grads(cfg, step_cfg, state["params"], batch)
    _close(loss, ref["loss"], 1e-5, 0)
    want_g, got_g = _flat(ref["grads"]), _flat(grads)
    assert sorted(got_g) == sorted(want_g)
    assert "stack/tail/t0/attn/k_norm" in got_g
    for path, w in want_g.items():
        _close(got_g[path], w, GRAD_TOL, GRAD_TOL)

    with ops.stats_scope() as st:
        new, metrics = make_train_step(cfg, opt, step_cfg)(state, batch)
    # 6 group layers and the tail's one; "full" runs the groups again
    assert st.dispatches["attention"] == (13 if remat == "full" else 7)
    want_st, want_m = ref[remat]
    assert int(new["step"]) == 1
    _close(metrics["loss"], want_m["loss"], 1e-5, 0)
    _close(metrics["grad_norm"], want_m["grad_norm"], GRAD_TOL, 0)
    for mom, times in (("m", 1), ("v", 2)):
        for path, w in _flat(want_st[mom]).items():
            _close(_flat(new[mom])[path], w, GRAD_TOL,
                   times * 2 * GRAD_TOL)
    lr = float(want_m["lr"])
    for path, w in _flat(want_st["params"]).items():
        vs = np.sqrt(np.asarray(_flat(want_st["v"])[path], np.float64)
                     / (1 - 0.95))
        d = GRAD_TOL * (vs + np.abs(want_g[path]).max())
        tol = lr * (1e-3 + np.minimum(2.0, 2 * d / (vs + EPS)))
        err = np.abs(_np(_flat(new["params"])[path]).astype(np.float64) - w)
        assert (err <= tol).all(), (path, float((err / tol).max()))


def test_serve_runs_gemma3_past_its_window_on_the_cpu(capsys):
    """13 prompt tokens and 12 generated: rings of 8 slots, wrapped, and
    full caches of 25 at the global layers."""
    out = serve.main(["--arch", "gemma3-4b", "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "13", "--gen", "12"])
    assert out["arch"] == "gemma3-4b-reduced"
    assert out["tokens"].shape == (2, 12) and out["device"] == "cpu"
    printed = capsys.readouterr().out
    assert "prefill:" in printed and "decode:" in printed


def test_train_launcher_trains_gemma3_on_the_cpu():
    out = train_launch.main(["--arch", "gemma3-4b", "--reduced", "--device",
                             "cpu", "--steps", "2", "--batch", "2", "--seq",
                             "16"])
    assert sorted(out["losses"]) == [1, 2]
    assert np.isfinite(list(out["losses"].values())).all()
