"""Full-width parity: the port held to saved readings of the JAX package.

Each arch of the registry runs at its published widths, cut in depth
(``CUTS``), on weights and inputs that both packages draw from one seed
by the counter-based hash of ``models.model`` (``draw_params``,
``hashed_uniform``).  A run (``run``) gives readings that fit in a small
file: the prefill logits projected onto hashed directions of the
vocabulary at every position and their top-16 at four positions, every
cache leaf after prefill projected per position, the logits of
``DECODE_STEPS`` teacher-forced decode steps, and for the trained archs
the loss and each gradient leaf's norm and dot with a hashed direction.
An MoE layer runs on the reference's routing (``launch.routing.Routing``),
and the tokens whose own routing differs are counted against the
reference's margins.  ``compare`` holds one arch's readings to the
reference's at the limits of ``LIMITS``.

Over a mesh (``run(..., mesh=)``) the weights are placed on the mesh's
slots and only the serving readings are taken (``serving``), so the same
fixture holds the sharded serving path too.

The reference's readings are made by ``tests/_torch_fullwidth.py --make``
(the JAX package on the CPU) into ``FIXTURE``; the CPU tests and
``chip_smoke.py``'s ``fullwidth`` phase (the kernel route on the card) hold
the port to them.  This module imports torch and numpy only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.launch.routing import (ROUTE_FLIPS_MAX, ROUTE_GAP_SHARE,
                                       Routing)
from repro_torch.models import model as model_mod

SEED = 0
FIXTURE = Path(__file__).resolve().parents[3] / "tests" / "data" / \
    "fullwidth_jax.npz"
N_DIRS = 8             # hashed directions of the vocabulary
N_CACHE_DIRS = 2       # hashed directions of a cache leaf's features
TOP = 16               # top logits kept at each of four positions
DECODE_STEPS = 8
_ROW = 256             # logits rows projected at a time
_GRAD_SLICE = 1 << 24  # gradient values dotted at a time

# reading -> limit.  Logits, caches: |got - want| <= limit * (scale +
# |want|), the scale the largest magnitude of the reference's array (the
# parity helper's rtol = atol share); gradients: a leaf's norm relative,
# its dot with a hashed direction over (norm * the direction's norm); the
# loss relative; routing: tokens routed otherwise, and the largest
# margin among them as a share of the router logits' largest magnitude.
LIMITS = {
    "prefill_logits": 1e-4, "prefill_top": 1e-4, "cache": 1e-4,
    "decode_logits": 1e-4, "loss": 1e-5, "grad_norm": 1e-3,
    "grad_dot": 1e-3, "route_flips": ROUTE_FLIPS_MAX,
    "route_gap": ROUTE_GAP_SHARE,
}

# hash streams of the inputs (weights take streams 0 .. leaves - 1)
_STREAM_TOKENS, _STREAM_DECODE, _STREAM_EMBED, _STREAM_FRAMES = (
    1 << 24, (1 << 24) + 1, (1 << 24) + 2, (1 << 24) + 3)


@dataclasses.dataclass(frozen=True)
class Cut:
    """How an arch is cut: ``groups`` groups of its stack (None: all), its
    tail kept or not, ``batch`` x ``seq`` tokens (``frames`` encoder
    frames), a train step or not (on the first ``train_seq`` tokens, if
    set)."""
    groups: Optional[int]
    batch: int
    seq: int
    tail: bool = True
    frames: Optional[int] = None
    train: bool = True
    train_seq: Optional[int] = None

    def meta(self) -> dict:
        return dataclasses.asdict(self)


CUTS: dict[str, Cut] = {
    "llama3.2-1b": Cut(None, 2, 256),
    "h2o-danube-1.8b": Cut(2, 1, 4608),                 # window 4,096
    "whisper-medium": Cut(None, 1, 64, frames=1500),
    "gemma3-4b": Cut(1, 1, 1536, tail=False),           # local window 1,024
    "gemma3-12b": Cut(1, 1, 1536, train=False),
    "qwen2-vl-72b": Cut(2, 1, 256, train=False),
    "falcon-mamba-7b": Cut(2, 2, 256),
    "zamba2-2.7b": Cut(1, 1, 512),                      # 4 chunks of 128
    # window 4,096; the train step on 1,024 tokens, which the CPU's
    # memory holds beside the layer's 2.8 B float32 weights and gradients
    "mixtral-8x22b": Cut(1, 1, 4608, train_seq=1024),
}

# the reduced configs' cuts (the machinery's CPU tests): whole depth, past
# the reduced windows of 8 and zamba2's reduced chunk of 16
REDUCED_CUTS: dict[str, Cut] = {
    "llama3.2-1b": Cut(None, 2, 16),
    "mixtral-8x22b": Cut(None, 1, 24),
    "zamba2-2.7b": Cut(None, 1, 32),
}


def cut_config(cfg, cut: Cut, compute_dtype):
    """``cfg`` (the port's or the JAX package's ModelCfg: the same
    fields) cut to ``cut``'s depth, in ``compute_dtype``."""
    stack = cfg.stack
    if cut.groups is not None:
        stack = dataclasses.replace(stack, n_groups=cut.groups)
    if not cut.tail:
        stack = dataclasses.replace(stack, tail=())
    return dataclasses.replace(cfg, stack=stack, compute_dtype=compute_dtype)


def config_digest(cfg) -> str:
    """A digest of a config's fields, the compute dtype aside: the same
    for the port's config and the JAX package's."""
    d = dataclasses.asdict(cfg)
    d.pop("compute_dtype")
    return hashlib.sha256(json.dumps(d, sort_keys=True, default=str)
                          .encode()).hexdigest()[:16]


def stream(name: str) -> int:
    """The hash stream of a named direction."""
    return (1 << 25) + zlib.crc32(name.encode())


def top_positions(seq: int) -> list[int]:
    return [0, seq // 3, 2 * seq // 3, seq - 1]


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def draw_inputs(cfg, cut: Cut, device=None) -> dict:
    """The run's inputs as tensors on ``device``: ``tokens`` and ``labels``
    (B, T), ``decode`` (DECODE_STEPS, B) teacher-forced tokens, and for
    an embedding-fed model ``inputs`` (B, T, D) with M-RoPE ``positions``
    (3, B, T) of a 16-wide grid of patches, for an encoder-decoder
    ``enc_inputs`` (B, frames, D); embeddings uniform at unit deviation."""
    b, t, d = cut.batch, cut.seq, cfg.d_model

    def ints(s, shape):
        n = int(np.prod(shape))
        return (model_mod.hash_ints(SEED, s, 0, n, device) % cfg.vocab).to(
            torch.int32).view(shape)

    def units(s, shape):
        n = int(np.prod(shape))
        return (model_mod.hashed_uniform(SEED, s, 0, n, device)
                * 3 ** 0.5).float().view(shape)

    tok = ints(_STREAM_TOKENS, (b, t + 1))
    out = {"tokens": tok[:, :-1].contiguous(),
           "labels": tok[:, 1:].contiguous(),
           "decode": ints(_STREAM_DECODE, (DECODE_STEPS, b))}
    if not cfg.embed_inputs:
        out["inputs"] = units(_STREAM_EMBED, (b, t, d))
        if cfg.stack.pattern[0].attn is not None and \
                cfg.stack.pattern[0].attn.mrope_section:
            i = torch.arange(t, dtype=torch.int32, device=device)
            out["positions"] = torch.stack(
                [i, i // 16, i % 16])[:, None].expand(3, b, t).contiguous()
    if cfg.encoder is not None:
        out["enc_inputs"] = units(_STREAM_FRAMES, (b, cut.frames, d))
    return out


def _mrope(cfg) -> bool:
    return any(lc.attn is not None and lc.attn.mrope_section
               for lc in cfg.stack.pattern)


# ---------------------------------------------------------------------------
# Readings
# ---------------------------------------------------------------------------


def flat(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def directions(name: str, n: int, k: int, device) -> torch.Tensor:
    """(n, k) float64 hashed directions, uniform on (-1, 1)."""
    return model_mod.hashed_uniform(SEED, stream(name), 0, n * k,
                                    device).view(n, k)


def logit_readings(logits: torch.Tensor, prefix: str,
                   top_ids: Optional[np.ndarray] = None) -> dict:
    """Logits (B, T, V) -> ``{prefix}proj`` (B, T, N_DIRS) float64; at
    row 0's ``top_positions``, ``{prefix}top_ids`` (4, TOP) (the reference
    run, when ``top_ids`` is None) and ``{prefix}top_vals``, the logits at
    those ids (the ids given: the reference's)."""
    b, t, v = logits.shape
    dirs = directions("logits", v, N_DIRS, logits.device)
    rows = logits.reshape(b * t, v)
    proj = torch.cat([rows[r:r + _ROW].double() @ dirs
                      for r in range(0, b * t, _ROW)])
    out = {prefix + "proj": proj.view(b, t, N_DIRS).cpu().numpy()}
    if t > 1:
        at = logits[0, top_positions(t)].float()              # (4, V)
        if top_ids is None:
            top_ids = torch.topk(at, TOP, dim=-1).indices.cpu().numpy()
            out[prefix + "top_ids"] = top_ids.astype(np.int32)
        ids = torch.from_numpy(np.asarray(top_ids, np.int64)).to(at.device)
        out[prefix + "top_vals"] = at.gather(-1, ids).double().cpu().numpy()
        out[prefix + "top_scale"] = np.float64(at.abs().max().item())
    return out


def cache_readings(cache, prefix: str) -> dict:
    """Every cache leaf: integer leaves (positions) whole; a float leaf
    with its first min(3, ndim - 1) axes kept and the rest projected onto
    N_CACHE_DIRS hashed directions (float64)."""
    out = {}
    for path, leaf in flat(cache).items():
        if not leaf.is_floating_point():
            out[prefix + path] = leaf.cpu().numpy().astype(np.int32)
            continue
        keep = min(3, leaf.dim() - 1)
        lead = tuple(leaf.shape[:keep])
        x = leaf.reshape(*lead, -1).double()
        dirs = directions("cache/" + path, x.shape[-1], N_CACHE_DIRS,
                          leaf.device)
        out[prefix + path] = (x @ dirs).cpu().numpy()
    return out


def grad_readings(grads, prefix: str = "train/") -> dict:
    """Each gradient leaf's norm, its dot with a hashed direction of the
    leaf's size and that direction's norm, in float64, a slice at a
    time (so no float64 copy of a large leaf is made)."""
    out = {}
    for path, g in flat(grads).items():
        g = g.reshape(-1)
        sq = dot = dsq = 0.0
        for s0 in range(0, g.numel(), _GRAD_SLICE):
            part = g[s0:s0 + _GRAD_SLICE].double()
            d = model_mod.hashed_uniform(SEED, stream("grad/" + path), s0,
                                         part.numel(), g.device)
            sq += float(part.square().sum())
            dot += float((part * d).sum())
            dsq += float(d.square().sum())
        out[f"{prefix}grad_norm/{path}"] = np.float64(sq ** 0.5)
        out[f"{prefix}grad_dot/{path}"] = np.float64(dot)
        out[f"{prefix}dir_norm/{path}"] = np.float64(dsq ** 0.5)
    return out


# ---------------------------------------------------------------------------
# MoE routing: the reference's, forced
# ---------------------------------------------------------------------------


def forced_calls(ref: dict, prefix: str, run: str) -> list:
    """The reference's routing of one run (``Routing``'s records: top_idx,
    pos, each token's margin and the logits' scale), its layers in
    order."""
    out, i = [], 0
    while f"{prefix}route/{run}/{i}/top_idx" in ref:
        name = f"{prefix}route/{run}/{i}/"
        out.append({k: ref[name + k] for k in ("top_idx", "pos", "margin",
                                               "scale")})
        i += 1
    return out


def is_moe(cfg) -> bool:
    return any(lc.moe is not None for lc in cfg.stack.pattern)


# ---------------------------------------------------------------------------
# The port's run
# ---------------------------------------------------------------------------


def port_config(arch: str, reduced: bool = False):
    from repro_torch.configs import get_config, get_reduced

    cut = (REDUCED_CUTS if reduced else CUTS)[arch]
    base = get_reduced(arch) if reduced else get_config(arch)
    return cut_config(base, cut, torch.float32), cut


def port_params(cfg, device) -> dict:
    return model_mod.draw_params(model_mod.model_specs(cfg), SEED, device)


def run(arch: str, device, ref: Optional[dict] = None,
        reduced: bool = False, params: Optional[dict] = None,
        mesh=None) -> dict:
    """The port's readings of ``arch`` at its cut on ``device`` (on the
    route ``kernels.ops.use_kernels`` selects: a CPU tensor takes the
    plain versions), keyed ``{arch}/...`` as the fixture is.  ``ref``, the
    reference's readings, gives the top-16 ids and, for an MoE arch, the
    routing to force; ``params`` reuses drawn weights.  With a ``mesh`` of
    more than one slot the weights are placed on it and the
    serving readings alone are taken (prefill, cache, decode), through
    ``train.step.sharded_forward``, the caches gathered whole."""
    from repro_torch.models.model import decode_positions, forward
    from repro_torch.train import step as step_mod

    cfg, cut = port_config(arch, reduced)
    p = f"{arch}/"
    if params is None:
        params = port_params(cfg, device)
    sharded = step_mod.is_sharded_mesh(mesh)
    run_model = forward
    if sharded:
        from repro_torch.dist import sharding as sh

        step_mod.check_sharded_serving(cfg, mesh)
        placed = sh.place(params, model_mod.model_specs(cfg), mesh)

        def run_model(params, cfg, x, *, mode, cache=None, positions=None,
                      cache_len=None):
            return step_mod.sharded_forward(
                placed, cfg, mesh, None, x, mode=mode, cache=cache,
                pos=None if positions is None else positions[0, 0],
                cache_len=cache_len)
    inp = draw_inputs(cfg, cut, device)
    moe = is_moe(cfg)
    ref = ref or {}
    routes: list = []
    out: dict = {}

    def forced(run_name):
        if not moe:
            return contextlib.nullcontext()
        routes.append(Routing(forced_calls(ref, p, run_name)))
        return routes[-1]

    x = inp.get("inputs", inp["tokens"])
    kw = {}
    if "enc_inputs" in inp:
        kw["enc_inputs"] = inp["enc_inputs"]
    if "positions" in inp:
        kw["positions"] = inp["positions"]
    cache_len = cut.seq + DECODE_STEPS
    with torch.no_grad():
        with forced("prefill"):
            logits, cache = run_model(params, cfg, x, mode="prefill",
                                      cache_len=cache_len, **kw)
        out.update(logit_readings(logits, p + "prefill/",
                                  ref.get(p + "prefill/top_ids")))
        del logits
        out.update(cache_readings(sh.gather(cache) if sharded else cache,
                                  p + "cache/"))
        steps = []
        for i in range(DECODE_STEPS):
            tok = inp["decode"][i][:, None]
            pos = decode_positions(cut.seq + i, cut.batch, device,
                                   _mrope(cfg))
            with forced(f"decode{i}"):
                logits, cache = run_model(params, cfg, tok, mode="decode",
                                          cache=cache, positions=pos)
            steps.append(logit_readings(logits, "")["proj"][:, 0])
        out[p + "decode/proj"] = np.stack(steps)
        del cache, logits
    if cut.train and not sharded:
        from repro_torch.train.step import StepCfg, loss_and_grads

        ts = cut.train_seq or cut.seq
        batch = {"tokens": inp["tokens"][:, :ts],
                 "labels": inp["labels"][:, :ts]}
        if "enc_inputs" in inp:
            batch["enc_inputs"] = inp["enc_inputs"]
        with forced("train"):
            loss, grads = loss_and_grads(cfg, StepCfg(remat="none"), params,
                                         batch)
        out[p + "train/loss"] = np.float64(loss.item())
        out.update(grad_readings(grads, p + "train/"))
        del grads
    if moe:
        flips = [r.flips() for r in routes]
        out[p + "route_flips"] = sum(f["flips"] for f in flips)
        out[p + "route_gap"] = max((g for f in flips
                                    for g in f["gap_shares"]), default=0.0)
    return out


def serving(ref: dict) -> dict:
    """The serving readings of a fixture (prefill, cache, decode, the
    metadata): what a sharded run takes."""
    return {k: v for k, v in ref.items()
            if k.split("/", 2)[1] in ("meta", "prefill", "cache", "decode")}


def meta(arch: str, cfg, cut: Cut) -> dict:
    return {"arch": arch, "cut": cut.meta(), "seed": SEED,
            "tokens": [cut.batch, cut.seq], "digest": config_digest(cfg),
            "decode_steps": DECODE_STEPS}


# ---------------------------------------------------------------------------
# The comparison
# ---------------------------------------------------------------------------


def _share(got, want) -> float:
    """max |got - want| / (scale + |want|), the scale the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if not want.size:
        return 0.0
    scale = float(np.abs(want).max())
    den = scale + np.abs(want)
    den = np.where(den > 0, den, 1.0)
    return float((np.abs(got - want) / den).max())


def compare(arch: str, got: dict, ref: dict) -> tuple[dict, list]:
    """One arch's readings against the reference's -> ({reading: value},
    [failures]); each reading is the worst over its arrays, and a
    failure names the reading, the array and its limit (``LIMITS``).  A
    gradient the reference computed as NaN (the JAX package's Mamba2
    gradient at its full chunk, a fault of the reference) is held only
    to be finite on the port."""
    p = f"{arch}/"
    readings: dict[str, Any] = {}
    worst: dict[str, str] = {}
    fails: list = []

    def note(kind, name, value):
        if value > readings.get(kind, -1.0):
            readings[kind], worst[kind] = value, name

    for name, want in ref.items():
        if not name.startswith(p) or name == p + "meta":
            continue
        key = name[len(p):]
        if key.startswith("route/") or key.endswith("top_ids") or \
                key.startswith("train/dir_norm/"):
            continue
        if name not in got:
            fails.append(f"{name}: missing from the port's readings")
            continue
        g = got[name]
        if key == "prefill/proj":
            note("prefill_logits", key, _share(g, want))
        elif key == "prefill/top_vals":
            scale = float(ref[p + "prefill/top_scale"])
            note("prefill_top", key, float(np.abs(
                np.asarray(g) - want).max() / scale))
        elif key == "prefill/top_scale":
            continue
        elif key == "decode/proj":
            note("decode_logits", key, _share(g, want))
        elif key.startswith("cache/"):
            if np.asarray(want).dtype.kind in "iu":
                if not np.array_equal(g, want):
                    fails.append(f"{name}: cache positions differ")
            else:
                note("cache", key, _share(g, want))
        elif key == "train/loss":
            note("loss", key, abs(float(g) - float(want)) / abs(float(want)))
        elif key.startswith("train/grad_norm/"):
            if np.isnan(want):
                readings["ref_nan_grads"] = readings.get(
                    "ref_nan_grads", 0) + 1
                if not np.isfinite(g):
                    fails.append(f"{name}: not finite on the port")
                continue
            note("grad_norm", key, abs(float(g) - float(want))
                 / max(abs(float(want)), 1e-300))
        elif key.startswith("train/grad_dot/"):
            path = key[len("train/grad_dot/"):]
            n = float(ref[p + "train/grad_norm/" + path])
            if np.isnan(want) or np.isnan(n):
                continue
            d = float(ref[p + "train/dir_norm/" + path])
            note("grad_dot", key, abs(float(g) - float(want))
                 / max(n * d, 1e-300))
    for kind in ("route_flips", "route_gap"):
        if p + kind in got:
            readings[kind] = got[p + kind]
            worst[kind] = "route"
    for kind, value in readings.items():
        if kind in LIMITS and not value <= LIMITS[kind]:
            fails.append(f"{arch} {kind} {value:.3g} > {LIMITS[kind]:g} "
                         f"({worst[kind]})")
    return readings, fails


def load_fixture(path=FIXTURE) -> dict:
    """The fixture as {name: array}; ``{arch}/meta`` decoded from JSON."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    for k in list(out):
        if k.endswith("/meta"):
            out[k] = json.loads(str(out[k]))
    return out


def fixture_archs(ref: dict) -> list[str]:
    return [k[:-len("/meta")] for k in ref if k.endswith("/meta")]
