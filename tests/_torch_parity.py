"""Helpers of the port's whole-model parity tests (``test_torch_moe.py``,
``test_torch_zamba2.py``): a reduced model of the JAX package in float32
compute and the port's counterpart from the same parameters (carried
across as numpy) and the same numpy tokens, held together in train mode,
through prefill + decode (logits of every step, every cache leaf after
prefill and after the last step) and over one train step.

Tolerances, as ``tests/test_torch_gemma3.py`` states them:

* logits and caches: rtol 1e-4 and atol 1e-4 times the leaf's largest
  magnitude; cache positions exactly;
* gradients: rtol 1e-3 and atol 1e-3 times the leaf's largest magnitude;
  the loss rtol 1e-5; after one AdamW step m within 2e-3 and v 4e-3 times
  the leaf's scale, parameters in units of lr.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_reduced as jax_reduced
from repro.dist.sharding import init_params as jax_init
from repro.models.losses import xent as jax_xent
from repro.models.model import forward as jax_forward
from repro.models.model import model_specs as jax_specs
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.configs import get_reduced
from repro_torch.models import model as pmodel
from repro_torch.train import optimizer as popt
from repro_torch.train.step import (StepCfg, loss_and_grads,
                                    make_decode_step, make_prefill_step,
                                    make_train_step)

B, T, DECODE_STEPS = 2, 16, 9
LR, EPS = 1e-3, 1e-8
TOL, GRAD_TOL = 1e-4, 1e-3


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def as_np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, rtol=TOL, atol_scale=TOL):
    got = np.asarray(as_np(got), np.float64)
    want = np.asarray(as_np(want), np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale)


def same_specs(jtree, ptree):
    """Two spec trees with the same paths, shapes, axes, dtypes and
    inits."""
    js, ps = flat(jtree), flat(ptree)
    assert sorted(js) == sorted(ps)
    for path, s in js.items():
        assert (ps[path].shape, ps[path].axes) == (s.shape, s.axes), path
        assert str(ps[path].dtype).split(".")[-1] == \
            np.dtype(s.dtype).name, path
        assert ps[path].init == s.init, path


_SETUP: dict = {}


def setup(arch):
    """The reduced ``arch`` of the JAX package in float32 compute, its
    parameters (also as numpy), B x (T + 1) numpy tokens split into
    inputs and labels, and DECODE_STEPS x B decode tokens."""
    if arch not in _SETUP:
        jcfg = dataclasses.replace(jax_reduced(arch),
                                   compute_dtype=jnp.float32)
        params = jax_init(jax_specs(jcfg), jax.random.PRNGKey(0))
        r = np.random.default_rng(0)
        tok = r.integers(0, jcfg.vocab, (B, T + 1)).astype(np.int32)
        _SETUP[arch] = dict(
            cfg=jcfg, params=params,
            np_params=jax.tree.map(np.asarray, params),
            tokens=tok[:, :-1], labels=tok[:, 1:],
            steps=r.integers(0, jcfg.vocab, (DECODE_STEPS, B)).astype(
                np.int32))
    return _SETUP[arch]


def port_cfg(arch):
    return dataclasses.replace(get_reduced(arch), compute_dtype=torch.float32)


def check_train_logits(arch):
    s = setup(arch)
    want = jax.jit(lambda p, t: jax_forward(p, s["cfg"], t, mode="train"))(
        s["params"], jnp.asarray(s["tokens"]))
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    got = pmodel.forward(params, port_cfg(arch),
                         torch.from_numpy(s["tokens"]), mode="train")
    close(got, want)


def check_prefill_decode(arch, t, cache_len):
    """Prefill of the first ``t`` tokens with caches of ``cache_len``,
    then DECODE_STEPS decode steps: every step's logits, and every cache
    leaf after prefill and after the last step (positions exactly).
    Returns the port's caches after prefill and after the last step, as
    flat numpy trees."""
    s = setup(arch)
    tokens = s["tokens"][:, :t]
    jpre = jax.jit(jstep.make_prefill_step(s["cfg"], max_len=cache_len))
    jdec = jax.jit(jstep.make_decode_step(s["cfg"]))
    logits, cache = jpre(s["params"], {"tokens": jnp.asarray(tokens)})
    want = [np.asarray(logits)]
    want_caches = [flat(jax.tree.map(np.asarray, cache))]
    for i, tok in enumerate(s["steps"]):
        logits, cache = jdec(s["params"], cache,
                             {"tokens": jnp.asarray(tok),
                              "pos": jnp.asarray(t + i, jnp.int32)})
        want.append(np.asarray(logits))
    want_caches.append(flat(jax.tree.map(np.asarray, cache)))

    cfg = port_cfg(arch)
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    prefill = make_prefill_step(cfg, max_len=cache_len)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(tokens)})
    got = [logits]
    # decode writes the cache in place: copy the prefill's first
    got_caches = [{k: v.copy() for k, v in
                   flat(pmodel.cache_to_numpy(cache)).items()}]
    for i, tok in enumerate(s["steps"]):
        logits, cache = decode(params, cache, {
            "tokens": torch.from_numpy(tok), "pos": t + i})
        got.append(logits)
    got_caches.append(flat(pmodel.cache_to_numpy(cache)))
    for g, w in zip(got, want):
        close(g, w)
    for gflat, wflat in zip(got_caches, want_caches):
        assert sorted(gflat) == sorted(wflat)
        for path, leaf in wflat.items():
            if path.endswith("pos"):
                assert np.array_equal(gflat[path], leaf), path
            else:
                close(gflat[path], leaf)
    return got_caches


_STEP: dict = {}


def jax_step(arch):
    """The JAX package's loss, gradients and one train step (remat none),
    from its train state, as numpy.  The port's steps under every remat
    are held to this one step: remat recomputes, it does not change the
    function (the JAX package's own remat steps give the same numbers)."""
    if arch not in _STEP:
        s = setup(arch)
        cfg = s["cfg"]
        opt = jopt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
        state = jstep.init_train_state(cfg, opt, jax.random.PRNGKey(0))
        jb = {"tokens": jnp.asarray(s["tokens"]),
              "labels": jnp.asarray(s["labels"])}
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_xent(
            jax_forward(p, cfg, jb["tokens"], mode="train"),
            jb["labels"])))(state["params"])
        out = {"state": jax.tree.map(np.asarray, state),
               "batch": {"tokens": s["tokens"], "labels": s["labels"]},
               "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}
        step = jax.jit(jstep.make_train_step(cfg, opt,
                                             jstep.StepCfg(remat="none")))
        out["step"] = jax.tree.map(np.asarray, step(state, jb))
        _STEP[arch] = out
    return _STEP[arch]


def check_train_step(arch, remat):
    """Loss, every gradient and one AdamW step of the port against the JAX
    package's, from the same train state.  Returns the port's gradients
    as a flat tree."""
    ref = jax_step(arch)
    cfg = port_cfg(arch)
    opt = popt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
    state = pmodel.train_state_from_numpy(ref["state"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    step_cfg = StepCfg(remat=remat)

    loss, grads = loss_and_grads(cfg, step_cfg, state["params"], batch)
    close(loss, ref["loss"], 1e-5, 0)
    want_g, got_g = flat(ref["grads"]), flat(grads)
    assert sorted(got_g) == sorted(want_g)
    for path, w in want_g.items():
        close(got_g[path], w, GRAD_TOL, GRAD_TOL)

    new, metrics = make_train_step(cfg, opt, step_cfg)(state, batch)
    want_st, want_m = ref["step"]
    assert int(new["step"]) == 1
    close(metrics["loss"], want_m["loss"], 1e-5, 0)
    close(metrics["grad_norm"], want_m["grad_norm"], GRAD_TOL, 0)
    for mom, times in (("m", 1), ("v", 2)):
        for path, w in flat(want_st[mom]).items():
            close(flat(new[mom])[path], w, GRAD_TOL, times * 2 * GRAD_TOL)
    lr = float(want_m["lr"])
    for path, w in flat(want_st["params"]).items():
        vs = np.sqrt(np.asarray(flat(want_st["v"])[path], np.float64)
                     / (1 - 0.95))
        d = GRAD_TOL * (vs + np.abs(want_g[path]).max())
        tol = lr * (1e-3 + np.minimum(2.0, 2 * d / (vs + EPS)))
        err = np.abs(as_np(flat(new["params"])[path]).astype(np.float64)
                     - w)
        assert (err <= tol).all(), (path, float((err / tol).max()))
    return got_g
