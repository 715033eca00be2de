"""The PyTorch port's sliding-window slice (h2o-danube-1.8b) against the
JAX package, on the CPU: the full config's specs and ring-sized caches,
the reduced model's (head dim 16, window 8) train-mode logits, one train
step under remat none and full, and prefill + decode through ring caches
slot by slot, each from the JAX package's parameters carried across and
the same numpy tokens; and both entry points.  On the CPU attention takes
the plain versions (with grad ``ops.AttentionFn`` and its explicit plain
backward), the formula the card's flash kernels compute, windowed.

The three prefill cases reach the JAX package's three ways of attending
over a prompt and both of its cache rules:

* T = 16 = 2 windows: ``_sdpa_banded``; the cache is the ring of the last
  8 positions (``_ring_tail``);
* T = 13: ``_sdpa_full``; a ring tail rolled by 13 - 8 = 5 slots;
* T = 6 with ``cache_len`` 20: ``_sdpa_full``; the prompt padded to 8
  slots (the window), which decode fills and then wraps.

Each runs DECODE_STEPS = 9 decode steps, more than the ring's 8 slots, so
every case wraps the ring at least once.

Tolerances, with their reasons (as ``tests/test_torch_whisper.py``):

* float32 logits and caches: rtol 1e-4 and atol 1e-4 times the leaf's
  largest magnitude (the JAX init's fan-in^-1/2 weights over the group
  axis make softmax rows near one-hot, which carries one-ulp differences
  of summation order well past 1e-5 of a leaf's scale); cache positions
  exactly.
* float32 gradients: rtol 1e-3 and atol 1e-3 times the leaf's largest
  magnitude; loss rtol 1e-5; after one AdamW step m within atol 2e-3 and
  v 4e-3 times the leaf's scale, parameters in units of lr as whisper's
  test bounds them.  A wrong or missing gradient term, or a mask that
  lets a key outside the window in, is an order-one error.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.dist.sharding import init_params as jax_init  # noqa: E402
from repro.models.losses import xent as jax_xent  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import model_cache_specs as jax_cache_specs  # noqa: E402
from repro.models.model import model_specs as jax_specs  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_reduced  # noqa: E402
from repro_torch.dist.sharding import param_count  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train.step import (StepCfg, batch_specs,  # noqa: E402
                                    cache_specs_for, loss_and_grads,
                                    make_decode_step, make_prefill_step,
                                    make_train_step)

ARCH = "h2o-danube-1.8b"
B, T, W, DECODE_STEPS = 2, 16, 8, 9
LR, EPS = 1e-3, 1e-8
TOL, GRAD_TOL = 1e-4, 1e-3


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


def test_full_specs_and_ring_caches_match_jax():
    """h2o-danube-1.8b at full size (arXiv:2401.16818): 24 layers of width
    2,560, 32 heads over 8 KV heads of 80, window 4,096, untied; a cache
    for 8,192 positions is a ring of 4,096 slots, as the JAX package's."""
    jcfg, pcfg = jax_config(ARCH), get_config(ARCH)
    a = pcfg.stack.pattern[0].attn
    assert (pcfg.n_layers, pcfg.d_model, pcfg.vocab, pcfg.tie_embeddings) \
        == (24, 2560, 32000, False)
    assert (a.n_heads, a.n_kv, a.head_dim, a.window) == (32, 8, 80, 4096)
    assert pcfg.stack.pattern[0].mlp.d_ff == 6912
    _same_specs(jax_specs(jcfg), pmodel.model_specs(pcfg))
    n = param_count(pmodel.model_specs(pcfg))
    assert 1.7e9 < n < 1.9e9
    for seq in (1024, 8192):
        js = jax_cache_specs(jcfg, 4, seq)
        ps = pmodel.model_cache_specs(pcfg, 4, seq)
        _same_specs(js, ps)
        assert ps["groups"]["p0"]["self"]["k"].shape == \
            (24, 4, min(seq, 4096), 8, 80)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        _same_specs(jstep.batch_specs(jcfg, JSHAPES[name]),
                    batch_specs(pcfg, SHAPES[name]))
    _same_specs(jstep.cache_specs_for(jcfg, JSHAPES["decode_32k"]),
                cache_specs_for(pcfg, SHAPES["decode_32k"]))


_JAX: dict = {}


def _setup():
    if not _JAX:
        jcfg = dataclasses.replace(jax_reduced(ARCH),
                                   compute_dtype=jnp.float32)
        params = jax_init(jax_specs(jcfg), jax.random.PRNGKey(0))
        r = np.random.default_rng(0)
        tok = r.integers(0, jcfg.vocab, (B, T + 1)).astype(np.int32)
        _JAX.update(
            cfg=jcfg, params=params,
            np_params=jax.tree.map(np.asarray, params),
            tokens=tok[:, :-1], labels=tok[:, 1:],
            steps=r.integers(0, jcfg.vocab, (DECODE_STEPS, B)).astype(
                np.int32))
    return _JAX


def _pcfg():
    return dataclasses.replace(get_reduced(ARCH), compute_dtype=torch.float32)


def test_train_logits_match_jax():
    """T = 16 is two windows: the JAX package attends in banded form, the
    port through the windowed attention (the flash kernel's mask)."""
    s = _setup()
    assert _pcfg().stack.pattern[0].attn.window == W
    want = jax.jit(lambda p, t: jax_forward(p, s["cfg"], t, mode="train"))(
        s["params"], jnp.asarray(s["tokens"]))
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    with ops.stats_scope() as st:
        got = pmodel.forward(params, _pcfg(), torch.from_numpy(s["tokens"]),
                             mode="train")
    assert st.dispatches["attention"] == 3
    _close(got, want)


@pytest.mark.parametrize("t,cache_len,clen", [(16, None, 8), (13, None, 8),
                                               (6, 20, 8)])
def test_prefill_and_decode_ring_match_jax(t, cache_len, clen):
    """Prefill's last logits and ring caches, then DECODE_STEPS decode
    steps that wrap the ring: every step's logits, and after prefill and
    after the last step every layer's k, v and pos slot by slot."""
    s = _setup()
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

    cfg = _pcfg()
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    prefill, decode = make_prefill_step(cfg, max_len=cache_len), \
        make_decode_step(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)})
    got = [logits]
    got_caches = [{k: v.copy() for k, v in _flat(pmodel.cache_to_numpy(
        cache)).items()}]
    first_pos = got_caches[0]["groups/p0/self/pos"]
    # the ring's layout: slot p % clen holds position p, the last clen ones
    live = np.arange(max(t - clen, 0), t)
    want_pos = np.full(clen, -1)
    want_pos[live % clen] = live
    assert (first_pos == want_pos).all()
    for i, tok in enumerate(s["steps"]):
        logits, cache = decode(params, cache, {"tokens": torch.from_numpy(
            tok), "pos": t + i})
        got.append(logits)
    got_caches.append(_flat(pmodel.cache_to_numpy(cache)))
    last = t + DECODE_STEPS - 1
    assert sorted(got_caches[1]["groups/p0/self/pos"][0, 0]) == \
        list(range(last - clen + 1, last + 1))
    for g, w in zip(got, want):
        _close(g, w)
    for gflat, wc in zip(got_caches, want_caches):
        wflat = _flat(wc)
        assert sorted(gflat) == sorted(wflat)
        assert gflat["groups/p0/self/k"].shape == (3, B, clen, 2, 16)
        for path, leaf in wflat.items():
            if path.endswith("pos"):
                assert np.array_equal(gflat[path], leaf), path
            else:
                _close(gflat[path], leaf)


@pytest.fixture(scope="module")
def jax_step():
    s = _setup()
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
    """Loss, gradients and one AdamW step over two windows of tokens."""
    ref = jax_step
    cfg = _pcfg()
    opt = popt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
    state = pmodel.train_state_from_numpy(ref["state"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    step_cfg = StepCfg(remat=remat)

    loss, grads = loss_and_grads(cfg, step_cfg, state["params"], batch)
    _close(loss, ref["loss"], 1e-5, 0)
    want_g, got_g = _flat(ref["grads"]), _flat(grads)
    assert sorted(got_g) == sorted(want_g)
    for path, w in want_g.items():
        _close(got_g[path], w, GRAD_TOL, GRAD_TOL)

    with ops.stats_scope() as st:
        new, metrics = make_train_step(cfg, opt, step_cfg)(state, batch)
    assert st.dispatches["attention"] == 3 * (2 if remat == "full" else 1)
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


def test_serve_runs_danube_past_its_window_on_the_cpu(capsys):
    """13 prompt tokens and 12 generated: a ring of 8 slots, wrapped."""
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "13", "--gen", "12"])
    assert out["arch"] == "h2o-danube-1.8b-reduced"
    assert out["tokens"].shape == (2, 12) and out["device"] == "cpu"
    printed = capsys.readouterr().out
    assert "prefill:" in printed and "decode:" in printed


def test_train_launcher_trains_danube_on_the_cpu():
    out = train_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    assert sorted(out["losses"]) == [1, 2]
    assert np.isfinite(list(out["losses"].values())).all()
