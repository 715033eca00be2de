"""The bf16 attention gradient on the training path, on the CPU: the
gradients that ``ops.attention`` gives through ``ops.AttentionFn`` (the
plain forward with log-sum-exp, then the explicit plain backward
``ref.attention_bwd``, the two formulas the card's kernels compute) held
to ``jax.vjp`` of the JAX package's plain attention
(``repro.kernels.ref.attention``) on the same bf16 inputs and upstream
gradient.

Tolerance: 2^-8 of each gradient's largest magnitude, the bf16 tolerance
of ``chip_smoke.py``'s backward checks.  Both sides compute in float32 and
round each gradient once to bf16; what is left between them is float32
summation order and those roundings.  The backward must take the float32
output of the forward: D = rowsum(dO * O) from the output rounded to bf16
puts dq at 0.0042 (causal GQA) and 0.0055 (non-causal) of its scale at
the first two shapes, past the tolerance; from the float32 output every
share here is at most 0.0014.  Also: the flash launches' count by shape
(``_build.SHAPE_LAUNCHES``), which ``chip_smoke.py`` reads for the
launches of each timed shape on the main paths.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention, ops, ref  # noqa: E402

TOL = 2 ** -8

CASES = [
    # b, t, s, h, kv, d, causal
    (2, 256, 256, 8, 2, 64, True),      # causal GQA 4:1
    (2, 300, 300, 4, 4, 64, False),     # non-causal: an encoder layer
    (2, 96, 300, 4, 4, 64, False),      # cross: T != S, no mask
]


def _arrays(seed, b, t, s, h, kv, d):
    r = np.random.default_rng(seed)
    return [r.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d),
                          (b, t, h, d))]


def _share(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_f32(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _jax_grads(arrays, causal):
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=causal),
                     q, k, v)
    return [np.asarray(g, np.float32) for g in vjp(do)]


@pytest.mark.parametrize("case", CASES, ids=["causal_gqa", "non_causal",
                                             "cross"])
def test_bf16_attention_gradients_match_jax_vjp(case):
    b, t, s, h, kv, d, causal = case
    arrays = _arrays(sum(case[:6]), b, t, s, h, kv, d)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
               for a in arrays[:3])
    do = torch.from_numpy(arrays[3]).to(torch.bfloat16)
    out = ops.attention(q, k, v, causal=causal)
    assert type(out.grad_fn).__name__ == "AttentionFnBackward"
    got = torch.autograd.grad(out, (q, k, v), do)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = _jax_grads(arrays, causal)
    shares = {n: _share(_bf16_f32(g), w)
              for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    assert max(shares.values()) <= TOL, shares
    # the forward itself is the JAX package's, value for value in bf16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays[:3])
    jout = np.asarray(jref.attention(jq, jk, jv, causal=causal), np.float32)
    assert _share(_bf16_f32(out), jout) <= TOL


def test_forward_hands_the_backward_its_float32_output():
    """``flash_attention_fwd``: the output, its lse and the output before
    its rounding, float32 for bf16 inputs and the output itself for
    float32 inputs; the backward's wrappers take O in q's dtype or in
    float32."""
    arrays = _arrays(5, 1, 40, 40, 4, 2, 16)
    qf, kf, vf, dof = map(torch.from_numpy, arrays)
    q, k, v, do = (x.to(torch.bfloat16) for x in (qf, kf, vf, dof))
    out, lse, o32 = flash_attention.flash_attention_fwd(q, k, v)
    assert out.dtype == torch.bfloat16 and o32.dtype == torch.float32
    assert torch.equal(o32.to(torch.bfloat16), out)
    assert torch.equal(o32, ref.attention_lse(q.float(), k.float(),
                                              v.float())[0])
    out_f, _, o32_f = flash_attention.flash_attention_fwd(qf, kf, vf)
    assert o32_f is out_f
    for o in (out, o32):
        flash_attention._check_bwd(q, k, v, o, lse, do, None)
        flash_attention.flash_attention_bwd(q, k, v, o, lse, do)
    for o in (o32.double(), o32.half()):
        with pytest.raises(ValueError, match="o must"):
            flash_attention._check_bwd(q, k, v, o, lse, do, None)
    with pytest.raises(ValueError, match="do must"):
        flash_attention._check_bwd(q, k, v, o32, lse, do.float(), None)


def test_flash_launches_are_counted_by_shape():
    """``_build.check`` counts a launch by kernel and, given a key, by
    (kernel, key); ``launch_key`` tells the serving forward, the training
    forward and the backward from either O apart, and the shapes."""
    from repro_torch.kernels import _build

    q = torch.zeros((4, 224, 16, 64), dtype=torch.bfloat16)
    k = torch.zeros((4, 1500, 16, 64), dtype=torch.bfloat16)
    whats = ("fwd", "fwd+lse", "bwd from float32 O", "bwd from bfloat16 O")
    keys = [flash_attention.launch_key(w, q, k, False, None) for w in whats]
    assert len(set(keys)) == 4
    assert keys[0] == ("fwd q (4, 224, 16, 64) k/v (4, 1500, 16, 64) "
                       "bfloat16 non-causal")
    assert flash_attention.launch_key("fwd", q, q, True, 8) == (
        "fwd q (4, 224, 16, 64) k/v (4, 224, 16, 64) bfloat16 causal "
        "window 8")
    saved = (_build.KERNEL_LAUNCHES.copy(), _build.SHAPE_LAUNCHES.copy())
    try:
        _build.KERNEL_LAUNCHES.clear()
        _build.SHAPE_LAUNCHES.clear()
        for key in (keys[0], keys[0], keys[1]):
            _build.check("flash_attention", 0, key)
        _build.check("hail_read", 0)
        assert _build.KERNEL_LAUNCHES == {"flash_attention": 3,
                                          "hail_read": 1}
        assert _build.SHAPE_LAUNCHES == {("flash_attention", keys[0]): 2,
                                         ("flash_attention", keys[1]): 1}
    finally:
        for counter, old in zip((_build.KERNEL_LAUNCHES,
                                 _build.SHAPE_LAUNCHES), saved):
            counter.clear()
            counter.update(old)
