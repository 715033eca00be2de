"""The JAX package's full-width readings, and the port held to them.

``repro_torch.launch.fullwidth`` defines the cuts, the inputs, the
readings and the comparison; this helper adds the JAX package's side:

* ``np_hashed_uniform`` / ``np_draw_leaf``: the numpy twin of the port's
  counter-based draw (``repro_torch.models.model.draw_leaf``), bit for
  bit;
* ``jax_run(arch)``: the JAX package on the CPU on its plain route
  (``repro.kernels.ops.use_kernels(False)``) in float32 compute, at the
  arch's cut, on weights drawn by the twin: the same readings as the
  port's ``fullwidth.run``, with every MoE layer's routing (top_idx, pos,
  each token's top-k margin) recorded through ``jax.debug.callback``.

Run from the repo root with ``PYTHONPATH=src``:

  python tests/_torch_fullwidth.py --make [ARCH ...]
      the JAX package's readings of every arch of ``fullwidth.CUTS``
      (or those named), one process an arch, merged into
      ``tests/data/fullwidth_jax.npz``;
  python tests/_torch_fullwidth.py --check [ARCH ...]
      the port's plain route on the CPU held to the fixture, one process
      an arch, on weights drawn by the numpy twin (the port's bits: the
      card's run draws them with the port's own ``draw_params``); prints
      one JSON line of readings an arch.
"""
import concurrent.futures
import contextlib
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import fullwidth as fw  # noqa: E402
from repro_torch.models import model as pmodel  # noqa: E402

OUT = ROOT / "build" / "fullwidth"
_P = 2_147_483_647
_STEPS = ((1_103_515_245, 12_345, 15), (48_271, 0, 13), (69_621, 1, 16))
_SLICE = 1 << 22


# ---------------------------------------------------------------------------
# The numpy twin of the port's draw
# ---------------------------------------------------------------------------


def np_mix(x):
    for mul, add, shift in _STEPS:
        x = (x * mul + add) % _P
        x = x ^ (x >> shift)
    return x


def np_hashed_uniform(seed, leaf, start, count):
    """float64 values on (-1, 1): the port's ``hashed_uniform``."""
    key = int(np_mix(np.int64(np_mix(np.int64(seed % _P)) ^ (leaf % _P))))
    e = np.arange(start, start + count, dtype=np.int64)
    h = np_mix(np_mix((e % _P) ^ key) ^ (e // _P))
    return (h * 2 + 1).astype(np.float64) / float(1 << 31) - 1.0


def np_draw_leaf(spec, seed, leaf, start=0, count=None):
    """Elements start .. start+count of a leaf, flat: the port's
    ``draw_leaf`` (float64 offset + half * u, rounded once to float32),
    a slice a thread."""
    count = int(np.prod(spec.shape)) - start if count is None else count
    offset, half = pmodel.draw_recipe(spec)
    out = np.empty(count, np.float32)

    def one(s0):
        n = min(_SLICE, count - s0)
        v = np_hashed_uniform(seed, leaf, start + s0, n) * half
        if offset:
            v = v + offset
        out[s0:s0 + n] = v.astype(np.float32)

    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        list(pool.map(one, range(0, count, _SLICE)))
    return out


def spec_leaves(tree):
    """(path, spec) in the JAX flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, s) for k in sorted(tree)
                for p, s in spec_leaves(tree[k])]
    return [("", tree)]


# ---------------------------------------------------------------------------
# The JAX package's run
# ---------------------------------------------------------------------------


def jax_config(arch, reduced=False):
    import jax.numpy as jnp

    from repro.configs import get_config, get_reduced

    cut = (fw.REDUCED_CUTS if reduced else fw.CUTS)[arch]
    base = get_reduced(arch) if reduced else get_config(arch)
    return fw.cut_config(base, cut, jnp.float32), cut


def jax_params(cfg):
    """The JAX parameter tree drawn by the twin, leaf by leaf (a leaf's
    numpy draw is dropped once JAX holds it)."""
    import jax.numpy as jnp

    from repro.models.model import model_specs

    out: dict = {}
    for i, (path, spec) in enumerate(spec_leaves(model_specs(cfg))):
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        a = np_draw_leaf(spec, fw.SEED, i).reshape(spec.shape)
        node[keys[-1]] = jnp.asarray(a)
        del a
    return out


def to_torch(tree):
    import torch

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        return torch.from_numpy(np.array(a))
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    return one(tree)


class RouteRecorder:
    """Patches the JAX stack's ``moe`` to report each call's top_idx, pos,
    each token's top-k margin (k-th minus (k+1)-th router logit) and the
    router logits' largest magnitude through ``jax.debug.callback``."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        import jax
        import jax.numpy as jnp

        from repro.models import moe as jmoe
        from repro.models import stack as jstack

        self.real = jstack.moe

        def moe(params, x, cfg, **kw):
            y, aux = self.real(params, x, cfg, return_aux=True)
            b, t, d = x.shape
            n = b * t
            g = jmoe.group_count(n)
            logits = jnp.einsum(
                "gnd,de->gne", x.reshape(g, n // g, d).astype(jnp.float32),
                params["router"].astype(jnp.float32))
            top = jax.lax.top_k(logits, cfg.top_k + 1)[0]
            margin = (top[..., cfg.top_k - 1] - top[..., cfg.top_k])
            jax.debug.callback(self._record, aux["top_idx"], aux["pos"],
                               margin.reshape(n), jnp.abs(logits).max())
            return y

        jstack.moe = moe
        return self

    def _record(self, top_idx, pos, margin, scale):
        self.calls.append((np.asarray(top_idx), np.asarray(pos),
                           np.asarray(margin), float(scale)))

    def take(self, prefix, run):
        import jax

        jax.effects_barrier()
        out = {}
        for i, (idx, pos, margin, scale) in enumerate(self.calls):
            name = f"{prefix}route/{run}/{i}"
            out[name + "/top_idx"] = idx.astype(np.int32)
            out[name + "/pos"] = pos.astype(np.int32)
            out[name + "/margin"] = margin.astype(np.float64)
            out[name + "/scale"] = np.float64(scale)
        self.calls = []
        return out

    def __exit__(self, *exc):
        from repro.models import stack as jstack

        jstack.moe = self.real
        return False


def jax_run(arch, reduced=False):
    """The JAX package's readings of ``arch`` at its cut, keyed as the
    port's ``fullwidth.run``, with ``{arch}/meta``."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.models.losses import xent
    from repro.models.model import forward
    from repro.train import step as jstep

    jops.use_kernels(False)
    cfg, cut = jax_config(arch, reduced)
    pcfg, _ = fw.port_config(arch, reduced)
    assert fw.config_digest(cfg) == fw.config_digest(pcfg), arch
    p = f"{arch}/"
    params = jax_params(cfg)
    inp = {k: v.numpy() for k, v in fw.draw_inputs(pcfg, cut).items()}
    out = {p + "meta": fw.meta(arch, pcfg, cut)}
    moe = fw.is_moe(pcfg)
    rec = RouteRecorder() if moe else contextlib.nullcontext()

    kw = {}
    if "enc_inputs" in inp:
        kw["enc_inputs"] = jnp.asarray(inp["enc_inputs"])
    if "positions" in inp:
        kw["positions"] = jnp.asarray(inp["positions"])
    x = jnp.asarray(inp.get("inputs", inp["tokens"]))
    cache_len = cut.seq + fw.DECODE_STEPS
    with rec:
        logits, cache = jax.jit(lambda prm, x, kw: forward(
            prm, cfg, x, mode="prefill", cache_len=cache_len, **kw))(
                params, x, kw)
        if moe:
            out.update(rec.take(p, "prefill"))
        out.update(fw.logit_readings(to_torch(logits), p + "prefill/"))
        del logits
        out.update(fw.cache_readings(to_torch(cache), p + "cache/"))
        dec = jax.jit(jstep.make_decode_step(cfg))
        steps = []
        for i in range(fw.DECODE_STEPS):
            logits, cache = dec(params, cache, {
                "tokens": jnp.asarray(inp["decode"][i]),
                "pos": jnp.asarray(cut.seq + i, jnp.int32)})
            if moe:
                out.update(rec.take(p, f"decode{i}"))
            steps.append(fw.logit_readings(
                to_torch(logits)[:, None], "")["proj"][:, 0])
        out[p + "decode/proj"] = np.stack(steps)
        del cache, logits, dec
        if cut.train:
            ts = cut.train_seq or cut.seq
            labels = jnp.asarray(inp["labels"][:, :ts])
            tokens = jnp.asarray(inp["tokens"][:, :ts])
            enc = kw.get("enc_inputs")

            def loss_fn(prm):
                extra = {} if enc is None else {"enc_inputs": enc}
                return xent(forward(prm, cfg, tokens, mode="train",
                                    **extra), labels)

            loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
            if moe:
                out.update(rec.take(p, "train"))
            out[p + "train/loss"] = np.float64(loss)
            del params
            out.update(fw.grad_readings(to_torch(grads), p + "train/"))
    return out


# ---------------------------------------------------------------------------
# The fixture
# ---------------------------------------------------------------------------


def save(readings, path):
    """Readings to an npz: arrays of floats as float32 (the limits are
    1e-4 and wider), scalars as float64, the metadata as JSON."""
    arrays = {}
    for k, v in readings.items():
        v = np.array(json.dumps(v)) if k.endswith("/meta") else np.asarray(v)
        if v.ndim and v.dtype == np.float64:
            v = v.astype(np.float32)
        arrays[k] = v
    np.savez_compressed(path, **arrays)


def make_one(arch):
    t0 = time.perf_counter()
    out = jax_run(arch)
    out[f"{arch}/meta"]["made"] = {
        "seconds": round(time.perf_counter() - t0, 1),
        "peak_rss_gb": round(resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2)}
    OUT.mkdir(parents=True, exist_ok=True)
    save(out, OUT / f"{arch}.npz")
    print(json.dumps(out[f"{arch}/meta"]), flush=True)


def merge(archs):
    """The per-arch files of ``archs`` into the fixture, beside the archs
    it already holds."""
    merged = fw.load_fixture() if fw.FIXTURE.exists() else {}
    for arch in archs:
        merged = {k: v for k, v in merged.items()
                  if not k.startswith(arch + "/")}
        merged.update(fw.load_fixture(OUT / f"{arch}.npz"))
    fw.FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    save(merged, fw.FIXTURE)
    print(f"{fw.FIXTURE}: {fw.FIXTURE.stat().st_size} bytes, archs "
          f"{fw.fixture_archs(merged)}", flush=True)


def twin_params(arch):
    """The port's parameter tree of ``arch``'s cut, drawn by the numpy
    twin (the bits of ``fullwidth.port_params``, several times faster on
    the CPU than torch's int64 arithmetic)."""
    import torch

    cfg, cut = fw.port_config(arch)
    out: dict = {}
    for i, (path, spec) in enumerate(spec_leaves(pmodel.model_specs(cfg))):
        node = out
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.from_numpy(np_draw_leaf(
            spec, fw.SEED, i).reshape(spec.shape))
    return out


def check_one(arch):
    ref = fw.load_fixture()
    t0 = time.perf_counter()
    got = fw.run(arch, "cpu", ref, params=twin_params(arch))
    readings, fails = fw.compare(arch, got, ref)
    print(json.dumps({"arch": arch, "readings": readings, "fails": fails,
                      "seconds": round(time.perf_counter() - t0, 1),
                      "peak_rss_gb": round(resource.getrusage(
                          resource.RUSAGE_SELF).ru_maxrss / 2 ** 20, 2)}),
          flush=True)
    return 1 if fails else 0


def each(flag, archs):
    rc = 0
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for arch in archs:
        rc |= subprocess.call([sys.executable, __file__, flag, arch],
                              env=env)
    return rc


def main(argv):
    if argv[:1] == ["--make-one"]:
        make_one(argv[1])
        return 0
    if argv[:1] == ["--check-one"]:
        return check_one(argv[1])
    archs = argv[1:] or list(fw.CUTS)
    if argv[:1] == ["--make"]:
        rc = each("--make-one", archs)
        merge([a for a in archs if (OUT / f"{a}.npz").exists()])
        return rc
    if argv[:1] == ["--check"]:
        return each("--check-one",
                    argv[1:] or fw.fixture_archs(fw.load_fixture()))
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
