"""The Mamba1 scan's training path of the PyTorch port on the CPU, held to
the JAX package.

On the card ``ops.SelectiveScanFn`` launches the training forward
(``selective_scan.selective_scan_train``: ``csrc/selective_scan.cu``,
which also writes h at the start of every ``CKPT_STEPS`` steps) and then
the backward kernel (``csrc/selective_scan_bwd.cu``), which starts every
interval from those checkpoints and makes no forward sweep of its own.  On
the CPU the same wrappers take the plain versions: ``ref.selective_scan``
with ``ref.selective_scan_states``, and ``ref.selective_scan_bwd``.

* The plain checkpoints: interval c's is h_final of the JAX package's
  Pallas kernel (``repro.kernels.selective_scan``, interpret mode) run on
  the first ``CKPT_STEPS`` * c steps, within 1e-5 of the states' scale;
  interval 0's is the zero state.
* ``SelectiveScanFn``'s gradients against a jitted ``jax.vjp`` of the JAX
  package's scan oracle (``repro.kernels.ref.selective_scan``, whose
  arithmetic the Pallas kernel is held to by the JAX package's own tests:
  ``jax.vjp`` through the ``pallas_call`` itself stops in its JVP rule),
  within ``SCAN_BWD_RTOL`` (1e-4 of each gradient's scale, as
  ``chip_smoke.py`` holds the kernel), and its outputs against the Pallas
  kernel's.

The kernels themselves run only on the card (``chip_smoke.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.selective_scan import selective_scan as jax_scan  # noqa
from repro_torch.kernels import _build, ops, selective_scan  # noqa: E402

SCAN_BWD_RTOL = 1e-4        # chip_smoke.py, the scan's gradients
STATE_RTOL = 1e-5           # the checkpoints, of the states' scale
SCAN_TOL = 1e-4             # tests/test_torch_lm_kernels.py, the forward


def _share(got, want):
    """max |got - want| as a share of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _arrays(seed, b, t, d, n):
    r = np.random.default_rng(seed)
    delta = np.log1p(np.exp(r.normal(size=(b, t, d)))).astype(np.float32)
    return (delta,
            r.normal(size=(b, t, d)).astype(np.float32),
            r.normal(size=(b, t, n)).astype(np.float32),
            r.normal(size=(b, t, n)).astype(np.float32),
            (-np.exp(0.3 * r.normal(size=(d, n)))).astype(np.float32),
            r.normal(size=(b, t, d)).astype(np.float32),
            r.normal(size=(b, d, n)).astype(np.float32))


@pytest.mark.parametrize("t,d,n", [(37, 24, 16), (20, 12, 5), (8, 8, 1)])
def test_plain_checkpoints_are_the_jax_kernels_states(t, d, n):
    """T off the interval (37, 20) and one whole interval (8); N = 16, 5,
    1: each checkpoint is the JAX kernel's h_final after the steps before
    it."""
    arrays = _arrays(t + n, 2, t, d, n)
    y, h, ckpt = selective_scan.selective_scan_train(
        *map(torch.from_numpy, arrays[:5]))
    steps = selective_scan.CKPT_STEPS
    assert ckpt.shape == (2, -(-t // steps), d, n)
    assert ckpt.dtype == torch.float32
    assert not ckpt[:, 0].any()
    scale = float(h.abs().max())
    for c in range(1, ckpt.shape[1]):
        _, want = jax_scan(*(jnp.asarray(v[:, :steps * c]) if v.ndim == 3
                             else jnp.asarray(v) for v in arrays[:5]))
        err = float(np.abs(ckpt[:, c].numpy() - np.asarray(want)).max())
        assert err <= STATE_RTOL * scale, (c, err, scale)
    wy, wh = jax_scan(*map(jnp.asarray, arrays[:5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), atol=SCAN_TOL,
                               rtol=SCAN_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), atol=SCAN_TOL,
                               rtol=SCAN_TOL)


@pytest.mark.parametrize("n,t,d,with_dh", [
    (1, 37, 24, True),      # one state; T off the 8-step interval
    (5, 19, 136, False),    # 2 lanes of 3 states; D off the 128-channel CTA
    (16, 40, 130, True),    # 4 lanes of 4 states; D off the CTA and 4
    (16, 21, 8, False),     # T off the interval, past two
])
def test_scan_function_matches_jitted_jax_vjp(n, t, d, with_dh):
    """``SelectiveScanFn`` (the training forward, then the backward from
    its checkpoints) against a jitted ``jax.vjp``: y and h_final, and the
    gradients of delta, x, B, C and A for an upstream gradient of y and,
    where given, of h_final."""
    arrays = _arrays(n + t + d, 2, t, d, n)
    ins = [torch.from_numpy(v).requires_grad_(True) for v in arrays[:5]]
    before = dict(_build.KERNEL_LAUNCHES)
    y, h = ops.SelectiveScanFn.apply(*ins)
    dy = torch.from_numpy(arrays[5])
    dh = torch.from_numpy(arrays[6])
    outs, grads = ((y, h), (dy, dh)) if with_dh else ((y,), (dy,))
    got = torch.autograd.grad(outs, ins, grads)
    assert dict(_build.KERNEL_LAUNCHES) == before   # the plain versions
    wy, vjp = jax.vjp(jref.selective_scan, *map(jnp.asarray, arrays[:5]))
    want = jax.jit(vjp)((jnp.asarray(arrays[5]),
                         jnp.asarray(arrays[6]) if with_dh
                         else jnp.zeros(arrays[6].shape, jnp.float32)))
    ky, kh = jax_scan(*map(jnp.asarray, arrays[:5]))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ky),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(kh),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(wy[0]),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _share(g.numpy(), np.asarray(w)) <= SCAN_BWD_RTOL


def test_backward_rejects_checkpoints_of_another_shape():
    """The backward takes only the training forward's checkpoints: on a
    CUDA tensor it needs them (the kernel makes no forward sweep), and a
    ckpt of another interval count, dtype or layout is refused on every
    route."""
    arrays = [torch.from_numpy(v) for v in _arrays(3, 1, 20, 4, 2)]
    _, _, ckpt = selective_scan.selective_scan_train(*arrays[:5])
    selective_scan._check_ckpt(arrays[0], arrays[4], ckpt)
    for bad in (ckpt[:, :1].contiguous(), ckpt.double(),
                ckpt.transpose(2, 3)):
        with pytest.raises(ValueError, match="ckpt"):
            selective_scan.selective_scan_bwd(*arrays[:6], None, bad)
    with pytest.raises(ValueError, match="ckpt"):
        selective_scan._check_ckpt(arrays[0], arrays[4], None)
