"""The PyTorch port's encoder-decoder slice (whisper-medium) against the
JAX package, on the CPU: the full config's specs, the reduced model's
train-mode logits, prefill (logits, self and cross caches) and decode
steps, and one train step (loss, gradients, new parameters), each from the
JAX package's parameters carried across and the same numpy tokens and
frame embeddings; models fed embeddings (``embed_inputs`` False); and the
serve entry point.  On the CPU attention takes the plain versions, and
with grad ``ops.AttentionFn`` with its explicit plain backward, the
formula the card's flash kernels compute.

Tolerances, with their reasons (as ``tests/test_torch_serve.py`` and
``tests/test_torch_train.py`` hold the decoder-only models):

* float32 logits and caches: rtol 1e-4 and atol 1e-4 times the leaf's
  largest magnitude.  The JAX init draws the stacked weights at
  fan-in^-1/2 over the group axis, so scores reach tens and softmax rows
  are near one-hot, which carries one-ulp differences of summation order
  (the port's cross-attention runs ``ref.attention``, the JAX package's
  ``_sdpa_full``) well past 1e-5 of a leaf's scale, in either package.
* float32 gradients: rtol 1e-3 and atol 1e-3 times the leaf's largest
  magnitude.  Through the four layers of encoder and decoder that
  amplification is larger than in the decoder-only models: against the
  same model evaluated in float64 (the port's float64 path), the JAX
  package's float32 gradients lie up to 6.0e-4 of a leaf's scale away and
  the port's up to 3.8e-4 (the embedding and the attention weights), so
  the two packages may differ by the sum.  A wrong or missing gradient
  term is an order-one error.
* loss: rtol 1e-5.  After one AdamW step, m within atol 2e-3 and v 4e-3
  times the leaf's scale (m's new term carries the gradient's error, v is
  quadratic in it).  Parameters in units of lr: Adam's first update is
  g / (|g| + eps), which a gradient difference d moves by at most
  min(2, 2 d / (|g| + eps)); with d = 1e-3 (|g| + the leaf's scale), the
  gradient tolerance, an element may differ by lr * (1e-3 + that bound).
  Where |g| is far above 1e-3 of the scale that is ~3e-3 lr, so a wrong
  sign, scale or order of the update still shows.
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

ARCH = "whisper-medium"
B, T, S_ENC, MAX_LEN, DECODE_STEPS = 2, 16, 24, 20, 3
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


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def test_full_specs_match_jax():
    """whisper-medium at full size: the encoder, ``enc_norm``, each decoder
    layer's ``ln_x`` and ``xattn``, the self and cross caches, and the
    batch specs of every shape, under the JAX package's paths."""
    jcfg, pcfg = jax_config(ARCH), get_config(ARCH)
    assert (pcfg.encoder.n_layers, pcfg.n_layers, pcfg.d_model) == \
        (24, 24, 1024)
    _same_specs(jax_specs(jcfg), pmodel.model_specs(pcfg))
    n = param_count(pmodel.model_specs(pcfg))
    assert n == sum(int(np.prod(s.shape))
                    for s in _flat(jax_specs(jcfg)).values())
    assert 0.7e9 < n < 0.8e9          # arXiv:2212.04356: 769M with the convs
    _same_specs(jax_cache_specs(jcfg, 4, 256, enc_len=1500),
                pmodel.model_cache_specs(pcfg, 4, 256, enc_len=1500))
    from repro.configs import SHAPES as JSHAPES
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        _same_specs(jstep.batch_specs(jcfg, JSHAPES[name]),
                    batch_specs(pcfg, SHAPES[name]))
    _same_specs(jstep.cache_specs_for(jcfg, JSHAPES["decode_32k"]),
                cache_specs_for(pcfg, SHAPES["decode_32k"]))


# ---------------------------------------------------------------------------
# the reduced model from the JAX package's parameters
# ---------------------------------------------------------------------------

_JAX: dict = {}


def _setup():
    """The reduced whisper in float32 compute: the JAX config, parameters,
    numpy tokens, labels, frame embeddings and decode tokens."""
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
            enc=r.normal(size=(B, S_ENC, jcfg.d_model)).astype(np.float32),
            steps=r.integers(0, jcfg.vocab, (DECODE_STEPS, B)).astype(
                np.int32))
    return _JAX


def _pcfg():
    return dataclasses.replace(get_reduced(ARCH), compute_dtype=torch.float32)


def test_params_from_numpy_carries_the_encoder_and_cross_leaves():
    s = _setup()
    ported = pmodel.params_from_numpy(s["np_params"], "cpu")
    jflat, pflat = _flat(s["np_params"]), _flat(ported)
    assert sorted(jflat) == sorted(pflat)
    for path in ("encoder/groups/p0/attn/wq", "encoder/groups/p0/ffn/w_up",
                 "enc_norm", "stack/groups/p0/ln_x",
                 "stack/groups/p0/xattn/wo"):
        assert path in pflat
    for path, leaf in jflat.items():
        assert np.array_equal(pflat[path].numpy(), leaf), path
    # the reduced encoder layers are non-causal, the decoder's cross
    enc_lc, dec_lc = _pcfg().encoder.pattern[0], _pcfg().stack.pattern[0]
    assert not enc_lc.attn.causal and not enc_lc.attn.cross
    assert dec_lc.attn.causal and dec_lc.attn.cross


def test_train_logits_match_jax():
    s = _setup()
    want = jax.jit(lambda p, t, e: jax_forward(
        p, s["cfg"], t, mode="train", enc_inputs=e))(
        s["params"], jnp.asarray(s["tokens"]), jnp.asarray(s["enc"]))
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    with ops.stats_scope() as st:
        got = pmodel.forward(params, _pcfg(), torch.from_numpy(s["tokens"]),
                             mode="train",
                             enc_inputs=torch.from_numpy(s["enc"]))
    # encoder self, decoder self and cross: one attention call a layer each
    assert st.dispatches["attention"] == 3 * 2
    assert got.dtype == torch.float32
    _close(got, want)


def test_prefill_and_decode_match_jax():
    """Prefill's last logits, self caches (padded to MAX_LEN) and cross
    caches (the projected encoder states, positions 0..S_enc-1), then
    DECODE_STEPS decode steps that run no encoder and no attention
    kernel, and leave the cross caches as they were."""
    s = _setup()
    jpre = jax.jit(jstep.make_prefill_step(s["cfg"], max_len=MAX_LEN))
    jdec = jax.jit(jstep.make_decode_step(s["cfg"]))
    batch = {"tokens": s["tokens"], "enc_inputs": s["enc"]}
    logits, cache = jpre(s["params"], jax.tree.map(jnp.asarray, batch))
    want = [np.asarray(logits)]
    want_caches = [jax.tree.map(np.asarray, cache)]
    for i, tok in enumerate(s["steps"]):
        logits, cache = jdec(s["params"], cache,
                             {"tokens": jnp.asarray(tok),
                              "pos": jnp.asarray(T + i, jnp.int32)})
        want.append(np.asarray(logits))
    want_caches.append(jax.tree.map(np.asarray, cache))

    cfg = _pcfg()
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    prefill, decode = make_prefill_step(cfg, max_len=MAX_LEN), \
        make_decode_step(cfg)
    with ops.stats_scope() as st:
        logits, cache = prefill(params, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    assert st.dispatches["attention"] == 3 * 2
    got = [logits]
    # a copy: decode writes the cache in place, and on the CPU the numpy
    # arrays share the tensors' memory
    got_caches = [{k: v.copy() for k, v in _flat(pmodel.cache_to_numpy(
        cache)).items()}]
    cross_k = cache["groups"]["p0"]["cross"]["k"].clone()
    for i, tok in enumerate(s["steps"]):
        with ops.stats_scope() as st:
            logits, cache = decode(params, cache,
                                   {"tokens": torch.from_numpy(tok),
                                    "pos": T + i})
        assert not st.dispatches
        got.append(logits)
    got_caches.append(_flat(pmodel.cache_to_numpy(cache)))
    assert torch.equal(cache["groups"]["p0"]["cross"]["k"], cross_k)
    for g, w in zip(got, want):
        _close(g, w)
    for gflat, wc in zip(got_caches, want_caches):
        wflat = _flat(wc)
        assert sorted(gflat) == sorted(wflat)
        assert gflat["groups/p0/cross/k"].shape == (2, B, S_ENC, 4, 16)
        assert gflat["groups/p0/self/k"].shape == (2, B, MAX_LEN, 4, 16)
        for path, leaf in wflat.items():
            if path.endswith("pos"):
                assert np.array_equal(gflat[path], leaf), path
            else:
                _close(gflat[path], leaf)


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's loss and gradients (``jax.value_and_grad`` of its
    loss, jitted) and its state and metrics after one jitted train step,
    for remat none and full."""
    s = _setup()
    cfg = s["cfg"]
    opt = jopt.OptCfg(lr=LR, warmup_steps=2, total_steps=10)
    state = jstep.init_train_state(cfg, opt, jax.random.PRNGKey(0))
    batch = {"tokens": s["tokens"], "labels": s["labels"],
             "enc_inputs": s["enc"]}
    jb = jax.tree.map(jnp.asarray, batch)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_xent(
        jax_forward(p, cfg, jb["tokens"], mode="train",
                    enc_inputs=jb["enc_inputs"]), jb["labels"])))(
        state["params"])
    out = {"state": jax.tree.map(np.asarray, state), "batch": batch,
           "loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}
    for remat in ("none", "full"):
        step = jax.jit(jstep.make_train_step(cfg, opt,
                                             jstep.StepCfg(remat=remat)))
        out[remat] = jax.tree.map(np.asarray, step(state, jb))
    return out


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_jax(jax_step, remat):
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
    # forward (twice under remat "full": the backward runs each group
    # again) and backward through AttentionFn, 3 attention calls a layer
    assert st.dispatches["attention"] == 3 * 2 * (2 if remat == "full"
                                                  else 1)
    want_st, want_m = ref[remat]
    assert int(new["step"]) == 1
    _close(metrics["loss"], want_m["loss"], 1e-5, 0)
    _close(metrics["grad_norm"], want_m["grad_norm"], GRAD_TOL, 0)
    for mom, times in (("m", 1), ("v", 2)):       # v is quadratic in g
        for path, w in _flat(want_st[mom]).items():
            _close(_flat(new[mom])[path], w, GRAD_TOL,
                   times * 2 * GRAD_TOL)
    lr = float(want_m["lr"])
    for path, w in _flat(want_st["params"]).items():
        vs = np.sqrt(np.asarray(_flat(want_st["v"])[path], np.float64)
                     / (1 - 0.95))                      # |g| after step 1
        d = GRAD_TOL * (vs + np.abs(want_g[path]).max())
        tol = lr * (1e-3 + np.minimum(2.0, 2 * d / (vs + EPS)))
        err = np.abs(_np(_flat(new["params"])[path]).astype(np.float64) - w)
        assert (err <= tol).all(), (path, float((err / tol).max()))


def test_embedding_inputs_match_jax():
    """A model fed embeddings (B,T,D) in place of tokens
    (``embed_inputs`` False), with ``embed_scale``: the train logits and
    the train step's inputs, against the JAX package's forward."""
    jcfg = dataclasses.replace(jax_reduced("llama3.2-1b"),
                               compute_dtype=jnp.float32, embed_inputs=False,
                               embed_scale=True)
    pcfg = dataclasses.replace(get_reduced("llama3.2-1b"),
                               compute_dtype=torch.float32,
                               embed_inputs=False, embed_scale=True)
    params = jax_init(jax_specs(jcfg), jax.random.PRNGKey(1))
    r = np.random.default_rng(1)
    x = r.normal(size=(B, T, jcfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, e: jax_forward(p, jcfg, e, mode="train"))(
        params, jnp.asarray(x))
    ported = pmodel.params_from_numpy(jax.tree.map(np.asarray, params),
                                      "cpu")
    got = pmodel.forward(ported, pcfg, torch.from_numpy(x), mode="train")
    _close(got, want)
    labels = torch.from_numpy(r.integers(0, jcfg.vocab, (B, T)))
    loss, _ = loss_and_grads(pcfg, StepCfg(remat="none"), ported,
                             {"inputs": torch.from_numpy(x),
                              "labels": labels})
    _close(loss, jax_xent(want, jnp.asarray(labels.numpy())), 1e-5, 0)
    with pytest.raises(ValueError, match="inputs"):
        loss_and_grads(pcfg, StepCfg(), ported,
                       {"tokens": labels, "labels": labels})


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


def test_serve_runs_whisper_on_the_cpu_when_asked(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out["arch"] == "whisper-medium-reduced"
    assert out["tokens"].shape == (2, 3) and out["device"] == "cpu"
    printed = capsys.readouterr().out
    assert "prefill:" in printed and "decode:" in printed


def test_train_launcher_refuses_an_encoder_model_before_any_step():
    """The launcher's batches are tokens only, as the JAX launcher's."""
    with pytest.raises(ValueError, match="encoder inputs"):
        train_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "1"])
