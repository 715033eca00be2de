"""The port's losses (``models/losses.py``) against the JAX package's:
``xent`` and ``chunked_xent``, with and without a mask, values and
gradients, on the same numpy inputs.

Tolerance: rtol 1e-5, and atol 1e-5 times the largest magnitude for the
gradients — the same float32 log-sum-exp and gather, summed in another
order.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import losses as jl  # noqa: E402
from repro_torch.models import losses as pl  # noqa: E402

TOL = 1e-5
B, T, D, V = 2, 16, 12, 40


def _close(got, want):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def _inputs(seed):
    r = np.random.default_rng(seed)
    return {"logits": (3 * r.normal(size=(B, T, V))).astype(np.float32),
            "x": r.normal(size=(B, T, D)).astype(np.float32),
            "head": r.normal(size=(D, V)).astype(np.float32),
            "labels": r.integers(0, V, (B, T)).astype(np.int32),
            "mask": (r.random((B, T)) < 0.6)}


@pytest.mark.parametrize("masked", [False, True])
def test_xent_matches_jax(masked):
    a = _inputs(1)
    mask = a["mask"] if masked else None
    want, want_g = jax.value_and_grad(lambda lg: jl.xent(
        lg, jnp.asarray(a["labels"]),
        None if mask is None else jnp.asarray(mask)))(
        jnp.asarray(a["logits"]))
    logits = torch.from_numpy(a["logits"]).requires_grad_(True)
    got = pl.xent(logits, torch.from_numpy(a["labels"]),
                  None if mask is None else torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, logits)
    _close(got, want)
    _close(got_g, want_g)


def test_xent_of_an_empty_mask_is_zero():
    a = _inputs(2)
    got = pl.xent(torch.from_numpy(a["logits"]),
                  torch.from_numpy(a["labels"]),
                  torch.zeros((B, T), dtype=torch.bool))
    want = jl.xent(jnp.asarray(a["logits"]), jnp.asarray(a["labels"]),
                   jnp.zeros((B, T), bool))
    assert float(got) == float(want) == 0.0


@pytest.mark.parametrize("n_chunks", [1, 4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_xent_matches_jax(n_chunks, masked):
    a = _inputs(3 + n_chunks)
    mask = a["mask"] if masked else None

    def jfn(x, head):
        return jl.chunked_xent(x, head, jnp.asarray(a["labels"]), n_chunks,
                               None if mask is None else jnp.asarray(mask))
    want, (wx, wh) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(a["x"]), jnp.asarray(a["head"]))
    x = torch.from_numpy(a["x"]).requires_grad_(True)
    head = torch.from_numpy(a["head"]).requires_grad_(True)
    got = pl.chunked_xent(x, head, torch.from_numpy(a["labels"]), n_chunks,
                          None if mask is None else torch.from_numpy(mask))
    gx, gh = torch.autograd.grad(got, (x, head))
    _close(got, want)
    _close(gx, wx)
    _close(gh, wh)


def test_chunked_equals_plain_on_the_full_logits():
    a = _inputs(5)
    x, head = torch.from_numpy(a["x"]), torch.from_numpy(a["head"])
    labels = torch.from_numpy(a["labels"])
    plain = pl.xent(torch.einsum("btd,dv->btv", x, head), labels)
    _close(pl.chunked_xent(x, head, labels, 4), plain.numpy())
    with pytest.raises(ValueError, match="multiple"):
        pl.chunked_xent(x, head, labels, 5)
