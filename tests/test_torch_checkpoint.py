"""The port's checkpoints (``ckpt/checkpoint.py``): ``tests/
test_checkpoint.py``'s eight tests, ported, and the layout shared with the
JAX package — a train state saved by either package, with float32 and
with bfloat16 optimizer state, restores in the other bit for bit."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import checkpoint as jck  # noqa: E402
from repro.configs import get_reduced as jax_reduced  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.model import train_state_from_numpy  # noqa: E402
from repro_torch.train.optimizer import OptCfg  # noqa: E402
from repro_torch.train.step import init_train_state, train_state_specs  # noqa: E402


def _state():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones((4,))},
            "step": torch.tensor(7, dtype=torch.int32)}


def _plus(tree, s):
    return {k: _plus(v, s) if isinstance(v, dict) else v + s
            for k, v in tree.items()}


def test_roundtrip(tmp_path):
    st = _state()
    ck.save(st, str(tmp_path), 7)
    got, step = ck.restore_latest(str(tmp_path), st)
    assert step == 7
    assert torch.equal(got["params"]["w"], st["params"]["w"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7


def test_corruption_falls_back_to_previous(tmp_path):
    st = _state()
    ck.save(st, str(tmp_path), 1)
    d2 = ck.save(_plus(st, 1), str(tmp_path), 2)
    victim = next(f for f in os.listdir(d2) if f.endswith(".npy"))
    with open(os.path.join(d2, victim), "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff\xff\xff")
    got, step = ck.restore_latest(str(tmp_path), st)
    assert step == 1
    assert torch.equal(got["params"]["b"], st["params"]["b"])


def test_atomicity_tmp_never_published(tmp_path):
    st = _state()
    ck.save(st, str(tmp_path), 3)
    assert ck.list_steps(str(tmp_path)) == [3]
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp"))
    assert ck.list_steps(str(tmp_path)) == [3]       # tmp dirs invisible
    _, step = ck.restore_latest(str(tmp_path), st)
    assert step == 3


def test_async_saver(tmp_path):
    st = _state()
    saver = ck.AsyncSaver()
    saver.save(st, str(tmp_path), 5)
    saver.wait()
    _, step = ck.restore_latest(str(tmp_path), st)
    assert step == 5


def test_elastic_reshard_restore(tmp_path):
    """Save a real train state; restore with specs + mesh placement."""
    cfg = get_reduced("llama3.2-1b")
    opt = OptCfg()
    state = init_train_state(cfg, opt, torch.Generator().manual_seed(3),
                             "cpu")
    ck.save(state, str(tmp_path), 11)
    mesh = make_host_mesh("cpu")
    got, step = ck.restore_latest(str(tmp_path), state,
                                  specs=train_state_specs(cfg, opt),
                                  mesh=mesh)
    assert step == 11
    assert torch.equal(got["params"]["embed"], state["params"]["embed"])
    assert got["params"]["embed"].device == mesh.devices.reshape(-1)[0]
    assert mesh.shape == {"data": 1, "model": 1}


def _save_three(tmp_path):
    """Steps 1..3, values offset by the step number; returns the dirs."""
    st = _state()
    return st, {s: ck.save(_plus(st, s), str(tmp_path), s) for s in (1, 2, 3)}


def test_torn_manifest_skips_to_previous_step(tmp_path):
    st, dirs = _save_three(tmp_path)
    mpath = os.path.join(dirs[3], "manifest.json")
    raw = open(mpath, "rb").read()
    with open(mpath, "wb") as f:
        f.write(raw[:len(raw) // 2])          # torn: half-written JSON
    got, step = ck.restore_latest(str(tmp_path), st)
    assert step == 2
    assert torch.equal(got["params"]["w"], st["params"]["w"] + 2)


def test_truncated_leaf_skips_to_previous_step(tmp_path):
    st, dirs = _save_three(tmp_path)
    victim = next(f for f in sorted(os.listdir(dirs[3]))
                  if f.endswith(".npy"))
    p = os.path.join(dirs[3], victim)
    os.truncate(p, os.path.getsize(p) // 2)
    got, step = ck.restore_latest(str(tmp_path), st)
    assert step == 2
    assert torch.equal(got["params"]["b"], st["params"]["b"] + 2)


def test_bad_manifest_crc_skips_newest_verifiable(tmp_path):
    st, dirs = _save_three(tmp_path)
    mpath = os.path.join(dirs[3], "manifest.json")
    man = json.load(open(mpath))
    fn = sorted(man["leaves"])[0]
    man["leaves"][fn]["crc32"] ^= 0xFFFFFFFF
    json.dump(man, open(mpath, "w"))
    victim = next(f for f in sorted(os.listdir(dirs[2]))
                  if f.endswith(".npy"))
    with open(os.path.join(dirs[2], victim), "r+b") as f:
        f.seek(16)
        f.write(b"\x5a\x5a\x5a\x5a")          # step 2 rots too
    got, step = ck.restore_latest(str(tmp_path), st)
    assert step == 1
    assert int(got["step"]) == int(st["step"]) + 1


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _bits(a):
    """A leaf's raw bits as an unsigned integer array."""
    if torch.is_tensor(a):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view(f"u{a.dtype.itemsize}") if a.ndim else \
        a.reshape(1).view(f"u{a.dtype.itemsize}")


def _jax_state(state_dtype, arch):
    cfg = jax_reduced(arch)
    opt = jopt.OptCfg(state_dtype=state_dtype)
    st = jstep.init_train_state(cfg, opt, jax.random.PRNGKey(5))
    # moments and step as after some training: nonzero, every bit in use
    r = np.random.default_rng(0)
    noise = lambda x: jnp.asarray(r.normal(size=x.shape), x.dtype)  # noqa
    return {"params": st["params"], "m": jax.tree.map(noise, st["m"]),
            "v": jax.tree.map(lambda x: jnp.abs(noise(x)), st["v"]),
            "step": jnp.asarray(42, jnp.int32)}


def _port_template(arch, state_dtype):
    return init_train_state(get_reduced(arch), OptCfg(state_dtype=state_dtype),
                            torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_jax_save_restores_in_the_port_bit_for_bit(tmp_path, arch, dt):
    jst = _jax_state(getattr(jnp, dt), arch)
    jck.save(jst, str(tmp_path), 42)
    got, step = ck.restore_latest(str(tmp_path),
                                  _port_template(arch, getattr(torch, dt)))
    assert step == 42
    want = jck._flatten(jst)
    flat = ck._flatten(got)
    assert sorted(flat) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert str(flat[key].dtype).split(".")[-1] == w.dtype.name, key
        assert tuple(flat[key].shape) == w.shape, key
        np.testing.assert_array_equal(_bits(flat[key]), _bits(w))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "falcon-mamba-7b"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_port_save_restores_in_jax_bit_for_bit(tmp_path, arch, dt):
    jst = _jax_state(getattr(jnp, dt), arch)
    pst = train_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    ck.save(pst, str(tmp_path), 42)
    got, step = jck.restore_latest(str(tmp_path), jst)
    assert step == 42
    want = ck._flatten(pst)
    flat = jck._flatten(got)
    assert sorted(flat) == sorted(want)
    for key, w in want.items():
        g = np.asarray(flat[key])
        # bfloat16 leaves come back as the 2-byte records np.load reads
        # from the JAX package's own saves too
        assert g.dtype.itemsize == w.element_size(), key
        np.testing.assert_array_equal(_bits(g), _bits(w))
    man = json.load(open(os.path.join(str(tmp_path), "step_00000042",
                                      "manifest.json")))
    assert {i["dtype"] for i in man["leaves"].values()} == \
        ({"float32", "int32"} | ({"bfloat16"} if dt == "bfloat16" else set()))
