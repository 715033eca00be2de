"""The PyTorch port's M-RoPE slice (qwen2-vl-72b) against the JAX package,
on the CPU: the full config's specs, ``apply_rope`` with distinct
time/height/width streams, the reduced model's (head dim 16, sections
(2, 3, 3)) train-mode logits at the default positions and at (3, B, T)
streams whose height and width differ from the time stream, its loss and
gradients, and prefill from patch embeddings + decode from tokens at
(3, B, 1) positions, each from the JAX package's parameters carried
across and the same numpy inputs; and the serve entry point.  On the CPU
attention takes the plain versions, the formula the card's flash kernels
compute.

Tolerances, with their reasons (as ``tests/test_torch_whisper.py``):

* ``apply_rope``: rtol 1e-5 and atol 1e-5 times the output's largest
  magnitude: the same float32 sines and cosines of the same angles, which
  the two libraries round within a few ulp of each other.
* float32 logits and caches: rtol 1e-4 and atol 1e-4 times the leaf's
  largest magnitude (one-ulp differences of summation order carried
  through near one-hot softmax rows); cache positions exactly.
* float32 gradients: rtol 1e-3 and atol 1e-3 times the leaf's largest
  magnitude, loss rtol 1e-5.  A section rotated by the wrong stream or
  the wrong rung of the frequency ladder is an order-one error.
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
from repro.models import common as jcommon  # noqa: E402
from repro.models.losses import xent as jax_xent  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import model_specs as jax_specs  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import SHAPES, get_config, get_reduced  # noqa: E402
from repro_torch.dist.sharding import param_count  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402
from repro_torch.train.step import (StepCfg, batch_specs,  # noqa: E402
                                    loss_and_grads, make_decode_step,
                                    make_prefill_step)

ARCH = "qwen2-vl-72b"
B, T, MAX_LEN, DECODE_STEPS = 2, 12, 16, 3
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


def _streams(r, b, t):
    """(3, B, T) positions: time is the index, height and width are patch
    grid coordinates that differ from it and from each other."""
    tt = np.broadcast_to(np.arange(t, dtype=np.int32), (b, t))
    hh = r.integers(0, 5, (b, t)).astype(np.int32)
    ww = r.integers(0, 7, (b, t)).astype(np.int32)
    return np.stack([tt, hh, ww])


def test_full_specs_match_jax():
    """qwen2-vl-72b at full size (arXiv:2409.12191): 80 layers of width
    8,192, 64 heads over 8 KV heads of 128, sections 16/24/24, rope theta
    1e6, embeddings in, untied, long_500k skipped."""
    jcfg, pcfg = jax_config(ARCH), get_config(ARCH)
    a = pcfg.stack.pattern[0].attn
    assert (pcfg.n_layers, pcfg.d_model, pcfg.vocab) == (80, 8192, 152064)
    assert (a.n_heads, a.n_kv, a.head_dim, a.rope_theta, a.mrope_section) \
        == (64, 8, 128, 1e6, (16, 24, 24))
    assert not pcfg.embed_inputs and not pcfg.tie_embeddings
    assert pcfg.skip_shapes == ("long_500k",)
    assert pcfg.stack.pattern[0].mlp.d_ff == 29568
    assert pcfg.mrope and not get_config("llama3.2-1b").mrope
    _same_specs(jax_specs(jcfg), pmodel.model_specs(pcfg))
    assert 72e9 < param_count(pmodel.model_specs(pcfg)) < 74e9
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        _same_specs(jstep.batch_specs(jcfg, JSHAPES[name]),
                    batch_specs(pcfg, SHAPES[name]))


def test_apply_rope_mrope_matches_jax_and_uses_the_sections():
    """Each section of the head-dim half is rotated by its own stream at
    its own rungs of the global frequency ladder: the JAX function's
    result, and not plain RoPE's by the time stream (nor a ladder
    restarted in each section)."""
    r = np.random.default_rng(3)
    x = r.normal(size=(B, T, 4, 32)).astype(np.float32)
    pos = _streams(r, B, T)
    sec = (4, 6, 6)
    want = np.asarray(jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         1e6, sec))
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                            sec)
    _close(got, want, 1e-5, 1e-5)
    plain = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos[0]),
                              1e6)
    assert float((got - plain).abs().max()) > 0.1 * float(got.abs().max())
    # the default streams (all equal to the index) are plain RoPE
    same = common.default_positions(B, T, mrope=True)
    assert same.shape == (3, B, T)
    torch.testing.assert_close(
        common.apply_rope(torch.from_numpy(x), same, 1e6, sec),
        common.apply_rope(torch.from_numpy(x), same[0], 1e6))
    with pytest.raises(ValueError, match="M-RoPE"):
        common.apply_rope(torch.from_numpy(x), same[0], 1e6, sec)


_JAX: dict = {}


def _setup():
    if not _JAX:
        jcfg = dataclasses.replace(jax_reduced(ARCH),
                                   compute_dtype=jnp.float32)
        params = jax_init(jax_specs(jcfg), jax.random.PRNGKey(0))
        r = np.random.default_rng(0)
        _JAX.update(
            cfg=jcfg, params=params,
            np_params=jax.tree.map(np.asarray, params),
            inputs=r.normal(size=(B, T, jcfg.d_model)).astype(np.float32),
            labels=r.integers(0, jcfg.vocab, (B, T)).astype(np.int32),
            pos=_streams(r, B, T),
            steps=r.integers(0, jcfg.vocab, (DECODE_STEPS, B)).astype(
                np.int32))
    return _JAX


def _pcfg():
    return dataclasses.replace(get_reduced(ARCH), compute_dtype=torch.float32)


@pytest.mark.parametrize("streams", ["default", "distinct"])
def test_train_logits_match_jax(streams):
    """From patch embeddings, at the default positions and at (3, B, T)
    streams whose height and width differ from the time stream."""
    s = _setup()
    pos = None if streams == "default" else s["pos"]
    want = jax.jit(lambda p, e, q: jax_forward(
        p, s["cfg"], e, mode="train", positions=q))(
        s["params"], jnp.asarray(s["inputs"]),
        None if pos is None else jnp.asarray(pos))
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    with ops.stats_scope() as st:
        got = pmodel.forward(params, _pcfg(), torch.from_numpy(s["inputs"]),
                             mode="train", positions=None if pos is None
                             else torch.from_numpy(pos))
    assert st.dispatches["attention"] == 3
    _close(got, want)


def test_forward_refuses_positions_the_kernel_cannot_mask():
    """The kernel masks by index: a time stream that is not the index, or
    (B, T) positions for an M-RoPE model, raise before any layer."""
    s = _setup()
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    x = torch.from_numpy(s["inputs"])
    shifted = torch.from_numpy(s["pos"]).clone()
    shifted[0] += 1
    for bad in (shifted, torch.from_numpy(s["pos"][0])):
        with pytest.raises(ValueError, match="default positions"):
            pmodel.forward(params, _pcfg(), x, mode="train", positions=bad)
    with pytest.raises(ValueError, match="default positions"):
        pmodel.forward(params, dataclasses.replace(
            get_reduced("llama3.2-1b"), compute_dtype=torch.float32),
            torch.zeros((B, T), dtype=torch.int64), mode="train",
            positions=torch.from_numpy(s["pos"]))


def test_loss_and_grads_match_jax():
    """The train step's loss and gradients (remat none) from patch
    embeddings at the default positions, as both packages' steps take
    them; the embedding table, which no term of the loss reaches in an
    untied model fed embeddings, gets a zero gradient, as in JAX."""
    s = _setup()
    cfg = s["cfg"]
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_xent(
        jax_forward(p, cfg, jnp.asarray(s["inputs"]), mode="train"),
        jnp.asarray(s["labels"]))))(s["params"])
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    got_loss, got = loss_and_grads(
        _pcfg(), StepCfg(remat="none"), params,
        {"inputs": torch.from_numpy(s["inputs"]),
         "labels": torch.from_numpy(s["labels"])})
    _close(got_loss, float(loss), 1e-5, 0)
    want_g, got_g = _flat(jax.tree.map(np.asarray, grads)), _flat(got)
    assert sorted(got_g) == sorted(want_g)
    for path, w in want_g.items():
        _close(got_g[path], w, GRAD_TOL, GRAD_TOL)


def test_loss_and_grads_raises_for_any_other_unreached_leaf():
    """Only that embedding table is exempt: any other leaf the loss does
    not reach (a mixer detached from autograd, say) still raises."""
    s = _setup()
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    params["stray"] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="not have been used"):
        loss_and_grads(_pcfg(), StepCfg(remat="none"), params,
                       {"inputs": torch.from_numpy(s["inputs"]),
                        "labels": torch.from_numpy(s["labels"])})


def test_prefill_and_decode_match_jax():
    """Prefill from patch embeddings (caches padded to MAX_LEN), then
    DECODE_STEPS decode steps from tokens at (3, B, 1) positions: logits,
    and every layer's k, v and pos slot by slot."""
    s = _setup()
    jpre = jax.jit(jstep.make_prefill_step(s["cfg"], max_len=MAX_LEN))
    jdec = jax.jit(jstep.make_decode_step(s["cfg"]))
    logits, cache = jpre(s["params"], {"inputs": jnp.asarray(s["inputs"])})
    want = [np.asarray(logits)]
    for i, tok in enumerate(s["steps"]):
        logits, cache = jdec(s["params"], cache,
                             {"tokens": jnp.asarray(tok),
                              "pos": jnp.asarray(T + i, jnp.int32)})
        want.append(np.asarray(logits))
    want_cache = _flat(jax.tree.map(np.asarray, cache))

    cfg = _pcfg()
    params = pmodel.params_from_numpy(s["np_params"], "cpu")
    logits, cache = make_prefill_step(cfg, max_len=MAX_LEN)(
        params, {"inputs": torch.from_numpy(s["inputs"])})
    got = [logits]
    decode = make_decode_step(cfg)
    for i, tok in enumerate(s["steps"]):
        logits, cache = decode(params, cache, {"tokens": torch.from_numpy(
            tok), "pos": T + i})
        got.append(logits)
    for g, w in zip(got, want):
        _close(g, w)
    got_cache = _flat(pmodel.cache_to_numpy(cache))
    assert sorted(got_cache) == sorted(want_cache)
    for path, leaf in want_cache.items():
        if path.endswith("pos"):
            assert np.array_equal(got_cache[path], leaf), path
        else:
            _close(got_cache[path], leaf)
    assert pmodel.decode_positions(5, B, mrope=True).shape == (3, B, 1)


def test_serve_runs_qwen2vl_on_the_cpu_when_asked(capsys):
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    assert out["arch"] == "qwen2-vl-72b-reduced"
    assert out["tokens"].shape == (2, 3) and out["device"] == "cpu"
    assert "decode:" in capsys.readouterr().out


def test_train_launcher_refuses_embedding_inputs_before_any_step():
    with pytest.raises(ValueError, match="embeddings"):
        train_launch.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "1"])
