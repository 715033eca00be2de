"""The PyTorch port's training half against the JAX package: the
optimizer (``adamw_update``, ``lr_at``, ``global_norm``) on the same numpy
trees, the ports of ``tests/test_train.py``'s five tests, and the train
step of the reduced llama3.2-1b and falcon-mamba-7b in float32 compute,
started from the JAX package's ``init_train_state`` carried across, on
one numpy batch, against the JAX package's jitted ``make_train_step`` (and
``jax.value_and_grad`` of its loss for the gradients).  The port's side is
parametrised over remat (none, full, dots) and the loss (plain, chunked)
against one JAX result.  On the CPU, attention and the scan run through the
``autograd.Function``s with their plain forward and explicit plain
backward, the formula the card's kernels compute.

Tolerances, with their reasons:

* optimizer on the same trees: rtol 1e-6 — one float32 update, the same
  operations (the bias corrections are float32 powers in both).
* loss: rtol 1e-5; gradients, every leaf: rtol 1e-4 and atol 1e-4 times
  the leaf's largest magnitude, as ``tests/test_torch_serve.py`` holds
  the whole float32 model — the random-weight models' near one-hot
  softmax rows amplify one-ulp differences of summation order well past
  1e-5 of a gradient's scale, in either package alike.
* after a step, m: atol 2e-4 times the leaf's scale, v twice that (it is
  quadratic in g).  m's new term has the gradient's error, and at the
  JAX package's states after steps one and two the llama's gradients come
  within 1e-4 of a leaf's scale of it (0.93e-4 measured), so the
  gradients' 1e-4 is doubled.  Parameters are compared in units of lr: Adam's first update
  is g / (|g| + eps) ~ +-1 times lr wherever |g| >> eps, but where |g| is
  within a few eps of 0 it turns on g / eps, and a gradient difference of
  one part in 1e4 moves it by up to eps / (sqrt(v_hat) + eps).  So each
  element may differ by lr * (1e-3 + eps / (sqrt(v_hat) + eps)), v_hat
  the JAX package's bias-corrected second moment.
* steps 2 and 3 are checked twice.  Teacher-forced, from the JAX
  package's state after the step before: the tolerances of step one.
  Free-running, from the port's own state: the parameters that moved
  apart in step one change the next gradients, and in the random-weight
  llama that amplification reaches 0.2% of the grad norm and ~0.6% of a
  moment's scale by step three (falcon-mamba ~0.003% and ~0.01%), while
  the loss stays within 1e-7.  So there: loss rtol 1e-5, grad norm rtol
  1e-2, m and v atol 2e-2 times the leaf's scale, and parameters within
  lr * sum over steps of (2e-2 + eps / (sqrt(v_hat_t) + eps)) after the
  first.  A wrong sign, scale or order of any update is an order-one
  error in lr units.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.models.losses import xent as jax_xent  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.models.model import train_state_from_numpy  # noqa: E402
from repro_torch.train import optimizer as popt  # noqa: E402
from repro_torch.train.step import (StepCfg, batch_specs,  # noqa: E402
                                    cache_specs_for, init_train_state,
                                    loss_and_grads, make_train_step,
                                    train_state_specs)

ARCHS = ["llama3.2-1b", "falcon-mamba-7b"]
LR, EPS = 1e-3, 1e-8
B, T = 2, 32


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    if torch.is_tensor(x):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.name == \
        "bfloat16" else np.asarray(x)


def _close(got, want, rtol, atol_scale):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want),
                                                             np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_scale * scale)


# ---------------------------------------------------------------------------
# 1. the optimizer against the JAX package on the same numpy trees
# ---------------------------------------------------------------------------


def _opt_trees(seed):
    r = np.random.default_rng(seed)
    p = {"w": r.normal(size=(6, 5)).astype(np.float32),
         "sub": {"b": r.normal(size=(5,)).astype(np.float32),
                 "k": r.normal(size=(2, 3, 4)).astype(np.float32)}}
    g = jax.tree.map(lambda a: r.normal(size=a.shape).astype(np.float32), p)
    m = jax.tree.map(lambda a: 0.1 * r.normal(size=a.shape).astype(
        np.float32), p)
    v = jax.tree.map(lambda a: 0.01 * np.abs(r.normal(size=a.shape)).astype(
        np.float32), p)
    return p, g, m, v


def _tt(tree, dtype=None):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)).to(
        dtype or torch.float32), tree)


@pytest.mark.parametrize("clip,step", [(1e9, 0), (0.5, 0), (0.5, 7),
                                       (2.0, 150)])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(clip, step, state):
    """Warmup and cosine steps, clipping on and off, weight decay on
    matrices only, float32 and bfloat16 moments."""
    jcfg = jopt.OptCfg(lr=1e-2, clip_norm=clip, warmup_steps=10,
                       total_steps=200, state_dtype=getattr(jnp, state))
    pcfg = popt.OptCfg(lr=1e-2, clip_norm=clip, warmup_steps=10,
                       total_steps=200, state_dtype=getattr(torch, state))
    p, g, m, v = _opt_trees(step + int(clip))
    jm = jax.tree.map(lambda a: jnp.asarray(a, jcfg.state_dtype), m)
    jv = jax.tree.map(lambda a: jnp.asarray(a, jcfg.state_dtype), v)
    want = jopt.adamw_update(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g),
        {"m": jm, "v": jv, "step": jnp.asarray(step, jnp.int32)}, jcfg)
    got = popt.adamw_update(
        _tt(p), _tt(g), {"m": _tt(m, pcfg.state_dtype),
                         "v": _tt(v, pcfg.state_dtype),
                         "step": torch.tensor(step, dtype=torch.int32)},
        pcfg)
    for k in ("grad_norm", "lr"):
        _close(got[2][k], want[2][k], 1e-6, 0)
    assert int(got[1]["step"]) == step + 1
    for path, w in _flat(want[0]).items():
        _close(_flat(got[0])[path], w, 1e-6, 1e-7)
    for mom in ("m", "v"):
        for path, w in _flat(want[1][mom]).items():
            gm = _flat(got[1][mom])[path]
            assert gm.dtype == pcfg.state_dtype
            # bfloat16 moments: one rounding of the same float32 value
            tol = 1e-6 if state == "float32" else 2 ** -8
            _close(gm, w, tol, 1e-7)


def test_lr_at_and_global_norm_match_jax():
    jcfg = jopt.OptCfg(lr=3e-4, warmup_steps=100, total_steps=10000)
    pcfg = popt.OptCfg(lr=3e-4, warmup_steps=100, total_steps=10000)
    for s in (0, 1, 50, 99, 100, 101, 5000, 9999, 10000, 20000):
        _close(popt.lr_at(pcfg, torch.tensor(s, dtype=torch.int32)),
               jopt.lr_at(jcfg, jnp.asarray(s, jnp.int32)), 1e-6, 0)
        _close(popt.lr_at(pcfg, s), jopt.lr_at(jcfg, s), 1e-6, 0)
    p, g, _, _ = _opt_trees(3)
    _close(popt.global_norm(_tt(g)),
           jopt.global_norm(jax.tree.map(jnp.asarray, g)), 1e-6, 0)


# ---------------------------------------------------------------------------
# 2. tests/test_train.py, ported
# ---------------------------------------------------------------------------


def test_adamw_matches_numpy_reference():
    cfg = popt.OptCfg(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
                      clip_norm=1e9, warmup_steps=0, total_steps=10,
                      min_lr_frac=1.0)
    p = {"w": torch.tensor([[1.0, -2.0], [0.5, 3.0]])}
    g = {"w": torch.tensor([[0.1, 0.2], [-0.3, 0.4]])}
    st = popt.init_opt_state(p, cfg)
    new_p, st2, _ = popt.adamw_update(p, g, st, cfg)
    gn = g["w"].numpy()
    m = 0.1 * gn
    v = 0.01 * gn * gn
    mhat = m / (1 - 0.9)
    vhat = v / (1 - 0.99)
    upd = mhat / (np.sqrt(vhat) + 1e-8)
    want = p["w"].numpy() - 1e-2 * (upd + 0.1 * p["w"].numpy())
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert int(st2["step"]) == 1


def test_grad_clip_scales_update():
    cfg = popt.OptCfg(lr=1.0, clip_norm=0.1, warmup_steps=0, total_steps=2,
                      weight_decay=0.0, min_lr_frac=1.0)
    p = {"w": torch.zeros((4,))}
    g = {"w": torch.full((4,), 100.0)}
    assert float(popt.global_norm(g)) == 200.0
    _, _, metrics = popt.adamw_update(p, g, popt.init_opt_state(p, cfg), cfg)
    assert float(metrics["grad_norm"]) == 200.0


def test_lr_schedule_shape():
    cfg = popt.OptCfg(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(popt.lr_at(cfg, torch.tensor(s))) for s in (0, 5, 10, 50,
                                                             99)]
    assert lrs[0] < lrs[1] < lrs[2]          # warmup rises
    assert lrs[2] >= lrs[3] >= lrs[4]        # cosine decays
    assert lrs[4] >= 0.1 * 0.99              # floors at min_lr_frac


def test_bf16_optimizer_state_halves_memory():
    p = {"w": torch.zeros((128, 128))}
    m32 = popt.init_opt_state(p, popt.OptCfg())["m"]["w"]
    m16 = popt.init_opt_state(
        p, popt.OptCfg(state_dtype=torch.bfloat16))["m"]["w"]
    assert m32.dtype == torch.float32 and m16.dtype == torch.bfloat16
    assert m16.element_size() * 2 == m32.element_size()


def test_tiny_model_memorizes():
    """30 steps on one repeated batch must cut the loss sharply."""
    cfg = get_reduced("llama3.2-1b")
    opt = popt.OptCfg(lr=3e-3, warmup_steps=5, total_steps=30,
                      weight_decay=0.0)
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             "cpu")
    step = make_train_step(cfg, opt)
    r = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab, (4, 32))),
             "labels": torch.from_numpy(r.integers(0, cfg.vocab, (4, 32)))}
    losses = []
    for _ in range(30):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.5, losses[::6]
    assert np.isfinite(losses).all()


# ---------------------------------------------------------------------------
# 3. specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_and_batch_specs_match_jax(arch):
    from repro.configs import SHAPES as JSHAPES
    from repro_torch.configs import SHAPES
    jcfg, pcfg = jax_reduced(arch), get_reduced(arch)
    for sd_j, sd_p in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        js = _flat(jstep.train_state_specs(jcfg, jopt.OptCfg(
            state_dtype=sd_j)))
        ps = _flat(train_state_specs(pcfg, popt.OptCfg(state_dtype=sd_p)))
        assert sorted(js) == sorted(ps)
        for k, s in js.items():
            assert (ps[k].shape, ps[k].axes, ps[k].init) == \
                (s.shape, s.axes, s.init), k
            assert str(ps[k].dtype).split(".")[-1] == np.dtype(s.dtype).name
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        jb = _flat(jstep.batch_specs(jcfg, JSHAPES[name]))
        pb = _flat(batch_specs(pcfg, SHAPES[name]))
        assert {k: (s.shape, s.axes) for k, s in jb.items()} == \
            {k: (s.shape, s.axes) for k, s in pb.items()}
    jc = _flat(jstep.cache_specs_for(jcfg, JSHAPES["decode_32k"]))
    pc = _flat(cache_specs_for(pcfg, SHAPES["decode_32k"]))
    assert {k: s.shape for k, s in jc.items()} == \
        {k: s.shape for k, s in pc.items()}


def test_train_step_rejects_embedding_inputs():
    """A token model (``embed_inputs``) given embeddings and no tokens is
    refused before any forward."""
    cfg = get_reduced("llama3.2-1b")
    opt = popt.OptCfg()
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(0),
                             "cpu")
    with pytest.raises(ValueError, match="tokens"):
        make_train_step(cfg, opt)(state, {"inputs": torch.zeros((1, 4, 64)),
                                          "labels": torch.zeros((1, 4))})


# ---------------------------------------------------------------------------
# 4. the train step against the JAX package's
# ---------------------------------------------------------------------------

_JAX: dict = {}


def _jax_run(arch):
    """The JAX package's state, batch, loss and gradients at the start,
    and its state and metrics after steps 1, 2 and 3 (remat none, plain
    loss), computed once per arch."""
    if arch in _JAX:
        return _JAX[arch]
    cfg = dataclasses.replace(jax_reduced(arch), compute_dtype=jnp.float32)
    opt = jopt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
    state = jstep.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    tok = r.integers(0, cfg.vocab, (B, T + 1)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_xent(
        jax_forward(p, cfg, jb["tokens"], mode="train"), jb["labels"])))(
        state["params"])
    step = jax.jit(jstep.make_train_step(cfg, opt, jstep.StepCfg(
        remat="none")))
    after, st = [], state
    for _ in range(3):
        st, metrics = step(st, jb)
        after.append(jax.tree.map(np.asarray, (st, metrics)))
    _JAX[arch] = {"state": jax.tree.map(np.asarray, state), "batch": batch,
                  "loss": float(loss),
                  "grads": jax.tree.map(np.asarray, grads), "after": after}
    return _JAX[arch]


def _vhat_sqrt(v, step):
    """sqrt of the bias-corrected second moment after ``step`` steps."""
    return np.sqrt(np.asarray(v, np.float64) / (1 - 0.95 ** step))


@pytest.mark.parametrize("loss", ["plain", "chunked"])
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, remat, loss):
    ref = _jax_run(arch)
    cfg = dataclasses.replace(get_reduced(arch),
                              compute_dtype=torch.float32)
    opt = popt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
    step_cfg = StepCfg(remat=remat, loss=loss, loss_chunks=4)
    state = train_state_from_numpy(ref["state"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}

    got_loss, grads = loss_and_grads(cfg, step_cfg, state["params"], batch)
    _close(got_loss, ref["loss"], 1e-5, 0)
    want_g = _flat(ref["grads"])
    got_g = _flat(grads)
    assert sorted(got_g) == sorted(want_g)
    for path, w in want_g.items():
        assert got_g[path].dtype == torch.float32
        _close(got_g[path], w, 1e-4, 1e-4)

    step = make_train_step(cfg, opt, step_cfg)
    starts = [ref["state"]] + [st for st, _ in ref["after"][:2]]
    free = state
    free_tol = {path: 0.0 for path in want_g}
    for i, (want_st, want_m) in enumerate(ref["after"]):
        # teacher-forced: step i + 1 from the JAX package's state after i
        got_st, got_m = step(train_state_from_numpy(starts[i], "cpu"), batch)
        _check_step(got_st, got_m, want_st, want_m, i + 1,
                    {p: 0.0 for p in want_g}, 1e-4, 2e-4, 1e-3)
        # free-running: step i + 1 from the port's own state after i
        free, free_m = step(free, batch)
        _check_step(free, free_m, want_st, want_m, i + 1, free_tol,
                    1e-4 if i == 0 else 1e-2, 2e-4 if i == 0 else 2e-2,
                    1e-3 if i == 0 else 2e-2)


def _check_step(got_st, got_m, want_st, want_m, n, p_tol, rtol, mom_atol,
                lr_units):
    """One step's state and metrics against the JAX package's; ``p_tol``
    accumulates each parameter's tolerance over the steps (in place)."""
    assert int(got_st["step"]) == n
    _close(got_m["loss"], want_m["loss"], 1e-5, 0)
    _close(got_m["grad_norm"], want_m["grad_norm"], rtol, 0)
    _close(got_m["lr"], want_m["lr"], 1e-6, 0)
    for mom, times in (("m", 1), ("v", 2)):      # v is quadratic in g
        for path, w in _flat(want_st[mom]).items():
            _close(_flat(got_st[mom])[path], w, max(rtol, 1e-4),
                   times * mom_atol)
    lr = float(want_m["lr"])
    for path, w in _flat(want_st["params"]).items():
        vs = _vhat_sqrt(_flat(want_st["v"])[path], n)
        p_tol[path] = p_tol[path] + lr * (lr_units + EPS / (vs + EPS))
        err = np.abs(_np(_flat(got_st["params"])[path]).astype(np.float64)
                     - w)
        assert (err <= p_tol[path]).all(), (
            path, n, float((err / p_tol[path]).max()))


def test_train_state_round_trips_through_numpy():
    from repro_torch.models.model import train_state_to_numpy
    ref = _jax_run("falcon-mamba-7b")
    state = train_state_from_numpy(ref["state"], "cpu")
    back = train_state_to_numpy(state)
    for path, w in _flat(ref["state"]).items():
        assert _flat(back)[path].dtype == w.dtype
        np.testing.assert_array_equal(_flat(back)[path], w)
