"""The port's bfloat16 gradient mean with error feedback
(``dist/compression.py``): ``tests/test_compression.py``'s three tests,
ported, over the port's ``DeviceMesh``, and the same numbers as the JAX
package on the same numpy gradients, bit for bit (one rounding to
bfloat16 and float32 sums, the same in both)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.dist import compression as jc  # noqa: E402
from repro.launch.mesh import make_mesh as jax_mesh  # noqa: E402
from repro_torch.dist.compression import (compressed_mean_grads,  # noqa: E402
                                          init_residual)
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def _mesh():
    return make_mesh((1,), ("data",), devices=["cpu"])


def test_exact_for_bf16_representable():
    g = {"w": torch.tensor([1.0, 0.5, -2.0, 0.25])}
    r = init_residual(g)
    m, r2 = compressed_mean_grads(_mesh(), g, r)
    np.testing.assert_array_equal(m["w"].numpy(), g["w"].numpy())
    np.testing.assert_array_equal(r2["w"].numpy(), np.zeros(4))


def test_error_feedback_preserves_mean():
    """Quantization error must be carried, not lost: summed updates over
    many steps converge to the true sum."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=256).astype(np.float32)) * 1e-3
    r = init_residual({"w": g_true})
    acc = np.zeros(256, np.float64)
    for _ in range(64):
        m, r = compressed_mean_grads(_mesh(), {"w": g_true}, r)
        acc += m["w"].numpy().astype(np.float64)
    want = g_true.numpy().astype(np.float64) * 64
    err_fb = np.abs(acc - want).max()
    naive = np.abs(g_true.to(torch.bfloat16).float().numpy().astype(
        np.float64) * 64 - want).max()
    assert err_fb <= naive + 1e-12
    assert err_fb < 1e-4


def test_residual_absorbs_quantization_error():
    g = {"w": torch.tensor([1e-4, 3.14159, -1e-5])}
    r = init_residual(g)
    m, r2 = compressed_mean_grads(_mesh(), g, r)
    np.testing.assert_allclose(m["w"].numpy() + r2["w"].numpy(),
                               g["w"].numpy(), rtol=1e-7)


@pytest.mark.parametrize("steps", [1, 5])
def test_same_numbers_as_jax(steps):
    """Nested trees, a bfloat16 leaf, several steps of error feedback."""
    rng = np.random.default_rng(steps)
    grads = {"a": rng.normal(size=(7, 5)).astype(np.float32) * 1e-2,
             "sub": {"b": rng.normal(size=(33,)).astype(np.float32),
                     "c": rng.normal(size=(4, 4)).astype(np.float32)}}
    jg = jax.tree.map(jnp.asarray, grads)
    jg["sub"]["c"] = jg["sub"]["c"].astype(jnp.bfloat16)
    pg = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), grads)
    pg["sub"]["c"] = pg["sub"]["c"].to(torch.bfloat16)
    jmesh, pmesh = jax_mesh((1,), ("data",)), _mesh()
    jr, pr = jc.init_residual(jg), init_residual(pg)
    for _ in range(steps):
        jm, jr = jc.compressed_mean_grads(jmesh, jg, jr)
        pm, pr = compressed_mean_grads(pmesh, pg, pr)
    for got, want in ((pm, jm), (pr, jr)):
        for g, w in zip(jax.tree.leaves(jax.tree.map(
                lambda t: t.numpy(), got)), jax.tree.leaves(want)):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, np.asarray(w))


def test_mesh_without_the_axis_raises():
    with pytest.raises(ValueError, match="axis"):
        compressed_mean_grads(make_mesh((1,), ("model",), devices=["cpu"]),
                              {"w": torch.zeros(2)},
                              {"w": torch.zeros(2)})
