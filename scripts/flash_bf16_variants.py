"""The bf16 flash forward, its variants and earlier sources side by side on
one CUDA card.

    python3 scripts/flash_bf16_variants.py [--shape NAME ... | --shape all]
        [--baseline OLD.cu ...] [--variants | --variant NAME ...]
        [--cases] [--phases] [--rounds N] [--dims 80,128]

Builds the flash forward as it is (``src/repro_torch/kernels/csrc/
flash_attention.cu``, the ``flash_fwd_d<D>.cu`` files and the headers
they include) into its own library under ``build/flash_variants/``, one
``nvcc`` a translation unit, all started together.  ``--variants`` also
builds variants made from ``flash_fwd.cuh`` by exact text substitutions
(``--variant NAME``, repeatable, some of them):

* ``no_overlap``  each consumer warpgroup waits for S, runs the softmax,
  then issues O += P V and waits for it (no softmax under P V), as at
  D = 256;
* ``no_pingpong`` the two consumers issue their products without taking
  turns, as at D = 256;
* ``2_stages``    a ring of 2 K/V stages, not 3;
* ``pv_chunks``   O += P V as one wgmma a 64-column chunk at D = 128 and
  256, not one over all of D;
* ``tk64``        64-key tiles at D = 256, not 80;
* ``no_pv``       without O += P V, ``no_exp`` without the exponentials
  of P, and ``no_kv_load`` without the K/V loads past the ring's first
  fill (their results are wrong: each times everything else).

``--baseline OLD.cu`` (repeatable) builds other single-file sources of
the same entry points as they are (earlier versions, e.g. ``git show
509570a:src/repro_torch/kernels/csrc/flash_attention.cu``), under their
file names; sources from before the softcap argument are called without
it, and without the training entry.  ``--dims 80,128`` builds only those
head dims of the flash forward (the others' entries return an error).

``--shape`` (repeatable; default ``llama``; ``all`` for every one) picks
the shapes of ``PERF.md`` section 6, each bf16: the serving forwards
``llama`` (5), ``whisper_enc`` (5'), ``whisper_cross`` (5''), ``h2o``
(5-h2o), ``qwen`` (5-qwen), ``g4``, ``g4_local``, ``g12``, ``g12_local``
(5-g4 ... 5-g12'), ``mixtral`` (5-mx), ``arctic`` (5-ar), ``zamba2``
(5-z), and the training forwards (lse and the float32 O) ``llama_train``,
``whisper_enc_train``, ``whisper_cross_train``, ``h2o_train``,
``g4_train``, ``g4_train_local`` (5-g4t), ``mixtral_train``,
``zamba2_train``.  At each shape every source but ``no_pv``, ``no_exp``
and ``no_kv_load`` is first held to the plain version
(``ref.attention``, or ``ref.attention_lse`` for lse and the float32 O)
on batch 0 and the first KV group's heads, within
``FLASH_TOL[bfloat16]``; then all are timed in turns (A B C ... C B A,
``--rounds`` rounds, default 3) by CUDA events around back-to-back
launches (at least 3, about 100 ms of them), with
``scaled_dot_product_attention`` beside them (causal with GQA,
non-causal, or a boolean band mask over K/V expanded to the query heads
for a window).

``--cases`` first runs phase 3's small bf16 forward cases of
``chip_smoke.py`` (every head dim, ragged T and S, T != S, windows, rows
with no key in their band, softcap) on those sources, lse and the
float32 O included, and exits 1 at the first miss.  ``--phases`` also
builds the source as it is with FLASH_FWD_PHASES defined and prints, for
each shape, where a consumer warp's SM cycles go (``clock64`` stamps,
``FwdPhase`` in ``flash_fwd.cuh``): cycles a warp and key tile in each
phase of one launch, and the epilogue's a warp.

Prints one JSON line per shape and round and, before the last line, the
card's name and power limit; the last line holds, per shape, the median
of each source, SDPA's and the bound (``fwd_work`` at 3.35 TB/s and 989
TFLOP/s).  Needs one card and ``nvcc``; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_variants"
TOL = 2e-2                       # FLASH_TOL[bfloat16] in chip_smoke.py
BYTES_PER_S, FLOPS_PER_S = 3.35e12, 989e12
TARGET_MS = 100.0                # launches timed back to back, about
# name: (b, t, s, h, kv, d, causal, window, training forward)
SHAPES = {
    "llama": (4, 512, 512, 32, 8, 64, True, None, False),
    "whisper_enc": (4, 1500, 1500, 16, 16, 64, False, None, False),
    "whisper_cross": (4, 224, 1500, 16, 16, 64, False, None, False),
    "h2o": (4, 8192, 8192, 32, 8, 80, True, 4096, False),
    "qwen": (4, 512, 512, 64, 8, 128, True, None, False),
    "g4": (4, 4096, 4096, 8, 4, 256, True, None, False),
    "g4_local": (4, 4096, 4096, 8, 4, 256, True, 1024, False),
    "g12": (4, 4096, 4096, 16, 8, 256, True, None, False),
    "g12_local": (4, 4096, 4096, 16, 8, 256, True, 1024, False),
    "mixtral": (4, 8192, 8192, 48, 8, 128, True, 4096, False),
    "arctic": (4, 4096, 4096, 56, 8, 128, True, None, False),
    "zamba2": (4, 4096, 4096, 32, 32, 80, True, None, False),
    "llama_train": (4, 512, 512, 32, 8, 64, True, None, True),
    "whisper_enc_train": (4, 1500, 1500, 16, 16, 64, False, None, True),
    "whisper_cross_train": (4, 448, 1500, 16, 16, 64, False, None, True),
    "h2o_train": (1, 8192, 8192, 32, 8, 80, True, 4096, True),
    "g4_train": (1, 4096, 4096, 8, 4, 256, True, None, True),
    "g4_train_local": (1, 4096, 4096, 8, 4, 256, True, 1024, True),
    "mixtral_train": (1, 8192, 8192, 48, 8, 128, True, 4096, True),
    "zamba2_train": (1, 4096, 4096, 32, 32, 80, True, None, True),
}
# chip_smoke.py phase 3's small bf16 forward cases: (b, t, s, h, kv, d,
# causal, window, softcap)
CASES = [
    (1, 300, 300, 4, 1, 64, True, 128, None),
    (2, 128, 128, 4, 4, 32, False, None, None),
    (1, 256, 256, 2, 2, 32, True, 32, None),
    (2, 100, 100, 4, 2, 16, True, None, None),
    (2, 100, 77, 4, 2, 16, False, 24, None),
    (2, 100, 77, 4, 2, 64, False, 24, None),
    (1, 70, 130, 4, 1, 32, False, None, None),
    (1, 200, 50, 2, 1, 64, True, 16, None),
    (2, 100, 100, 32, 8, 80, True, None, None),
    (2, 100, 77, 4, 2, 80, False, 24, None),
    (1, 300, 300, 32, 8, 80, True, 128, None),
    (1, 200, 50, 4, 1, 80, True, 16, None),
    (1, 70, 130, 64, 8, 128, False, None, None),
    (2, 97, 161, 64, 8, 128, True, None, None),
    (1, 300, 300, 8, 1, 128, True, 100, None),
    (2, 100, 100, 8, 4, 256, True, None, None),
    (2, 100, 77, 4, 2, 256, False, 24, None),
    (1, 300, 300, 8, 4, 256, True, 128, None),
    (1, 70, 130, 8, 4, 256, False, None, None),
    (2, 97, 161, 8, 4, 256, True, None, None),
    (1, 200, 50, 2, 1, 256, True, 16, None),
    (2, 100, 100, 4, 2, 64, True, None, 2.0),
    (1, 300, 300, 8, 4, 256, True, 128, 2.0),
    (1, 300, 300, 48, 8, 128, True, 128, None),
    (2, 100, 100, 56, 8, 128, True, None, None),
    (1, 70, 130, 32, 32, 80, False, None, None),
    (4, 512, 512, 32, 8, 64, True, None, None),
    (4, 1500, 1500, 16, 16, 64, False, None, None),
]
WRONG = ("no_pv", "no_exp", "no_kv_load")  # variants with wrong results
FLASH_TUS = ("flash_attention.cu", *(f"flash_fwd_d{d}.cu"
                                     for d in (16, 32, 64, 80, 128, 256)))


def sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"variant text not found: {old[:60]!r}")
    return text.replace(old, new)


def variants(header: str) -> dict[str, str]:
    """Texts of ``flash_fwd.cuh``: the source and its variants."""
    return {
        "no_overlap": sub(header, "constexpr bool kOverlap = D <= 128;",
                          "constexpr bool kOverlap = false;"),
        "no_pingpong": sub(header, "constexpr bool kPingPong = kOverlap<D>;",
                           "constexpr bool kPingPong = false;"),
        "2_stages": sub(header, "constexpr int kStages = D <= 128 ? 3 : 2;",
                        "constexpr int kStages = 2;"),
        "pv_chunks": sub(header, "constexpr bool kWidePV = true;",
                         "constexpr bool kWidePV = false;"),
        "tk64": sub(header, "constexpr int kTK = D <= 128 ? 128 : 80;",
                    "constexpr int kTK = D <= 128 ? 128 : 64;"),
        "no_pv": sub(header, "    issue_pv_step<D, TK>(o, pa[kc], v_tile, "
                     "kc);", "    ;"),
        "no_exp": sub(header, "fast_exp2(fmaf(s[j][e], scale, -mx[e >> 1]))",
                      "fmaf(s[j][e], scale, -mx[e >> 1])"),
        "no_kv_load": sub(
            header, "        mbar_expect_tx(&sm.full_k[st], TK * D * 2);\n",
            "        if (it >= NS) {\n"
            "          mbar_arrive(&sm.full_k[st]);\n"
            "          mbar_arrive(&sm.full_v[st]);\n"
            "          continue;\n"
            "        }\n"
            "        mbar_expect_tx(&sm.full_k[st], TK * D * 2);\n"),
    }


def stub(d: int) -> str:
    """A flash_fwd_d<D>.cu whose entry builds nothing (``--dims``)."""
    return ('#include "flash_fwd.cuh"\n\ntemplate <>\nint flash_fwd_launch<'
            f'{d}>(const FwdArgs&) {{\n  return (int)cudaErrorNotSupported;'
            '\n}\n')


def entry_kinds(src: str) -> tuple[bool, bool]:
    """(takes a softcap, has the training entry) of a single source."""
    entry = re.search(r"flash_attention_launch\((.*?)\)", src, re.S)
    return (entry is not None and "float softcap" in entry[1],
            "flash_attention_lse_launch" in src)


def build(sources: dict[str, dict[str, str]]) -> dict[str, ctypes.CDLL]:
    """One library a source (files -> text, compiled beside the port's
    headers), built with the port's nvcc flags, every translation unit's
    nvcc started together."""
    from repro_torch.kernels import _build

    procs = []
    for name, files in sources.items():
        where = OUT / name
        shutil.rmtree(where, ignore_errors=True)
        where.mkdir(parents=True)
        for fname, text in files.items():
            (where / fname).write_text(text)
        for fname in [*files, "errors.cu"]:
            if not fname.endswith(".cu"):
                continue
            src = where / fname if fname in files else CSRC / fname
            obj = where / (Path(fname).stem + ".o")
            procs.append((name, obj, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(where), "-I",
                 str(CSRC), "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = {}
    for name, obj, proc in procs:
        out, _ = proc.communicate()
        logs[name] = logs.get(name, "") + out
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name} ({obj.name}):\n{out}")
    libs = {}
    for name in sources:
        objs = sorted(str(p) for p in (OUT / name).glob("*.o"))
        lib = OUT / name / f"lib{name}.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        str(lib), *objs], check=True, capture_output=True)
        (OUT / name / "ptxas.log").write_text(logs[name])
        libs[name] = ctypes.CDLL(str(lib))
    return libs


class Source:
    """One built library's two entry points, called as the wrapper does."""

    def __init__(self, lib, softcap: bool, lse: bool):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        n_float = 2 if softcap else 1
        self.softcap = softcap
        self.fwd = lib.flash_attention_launch
        self.fwd.argtypes = [p] * 4 + [i] * 9 + [f] * n_float + [p]
        self.fwd.restype = i
        self.lse = None
        if lse:
            self.lse = lib.flash_attention_lse_launch
            self.lse.argtypes = [p] * 6 + [i] * 9 + [f] * n_float + [p]
            self.lse.restype = i

    def __call__(self, q, k, v, out, causal, window, cap=None, o32=None,
                 lse=None):
        b, t, h, d = q.shape
        s, kv = k.shape[1], k.shape[2]
        tail = [b, t, s, h, kv, d, int(causal),
                -1 if window is None else window, 1, 1.0 / math.sqrt(d)]
        if self.softcap:
            tail.append(float(cap or 0.0))
        elif cap:
            raise RuntimeError("this source takes no softcap")
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if lse is None:
            code = self.fwd(*ptrs, *tail, stream)
        else:
            code = self.lse(*ptrs, o32.data_ptr(), lse.data_ptr(), *tail,
                            stream)
        if code:
            raise RuntimeError(f"launch failed ({code})")


def inputs(b, t, s, h, kv, d, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda")
            .to(torch.bfloat16)
            for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d))]


def check(name, src, q, k, v, causal, window, cap, train, part):
    """Max abs error of the source's output (and, training, lse and the
    float32 O) against the plain version on q[part], k/v[part kv]."""
    from repro_torch.kernels import ref

    b, t, h, d = q.shape
    out = torch.empty_like(q)
    o32 = lse = None
    if train:
        o32 = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        lse = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
    src(q, k, v, out, causal, window, cap, o32, lse)
    torch.cuda.synchronize()
    (qb, qh), (kb, kh) = part
    qp, kp, vp = (x.contiguous() for x in (q[qb, :, qh], k[kb, :, kh],
                                           v[kb, :, kh]))
    errs = {}
    if train:
        want_o, want_lse, want_o32 = ref.attention_lse(
            qp, kp, vp, causal=causal, window=window, softcap=cap)
        errs["lse"] = float((lse[qb][:, qh] - want_lse).abs().max())
        errs["o32"] = float((o32[qb, :, qh] - want_o32).abs().max())
    else:
        want_o = ref.attention(qp, kp, vp, causal=causal, window=window,
                               softcap=cap)
    errs["o"] = float((out[qb, :, qh].float() - want_o.float()).abs().max())
    bad = {key: e for key, e in errs.items() if not e <= TOL}
    if bad:
        raise RuntimeError(f"{name}: {bad} > {TOL} at q {tuple(q.shape)} k/v "
                           f"{tuple(k.shape)} causal={causal} window={window}"
                           f" softcap={cap}")
    return errs


def run_cases(srcs, cases) -> None:
    for b, t, s, h, kv, d, causal, window, cap in cases:
        q, k, v = inputs(b, t, s, h, kv, d)
        row = []
        for name, src in srcs.items():
            if name in WRONG or (cap and not src.softcap):
                continue
            part = ((slice(None), slice(None)), (slice(None), slice(None)))
            errs = check(name, src, q, k, v, causal, window, cap, False, part)
            if src.lse is not None:
                errs.update({f"train_{key}": e for key, e in check(
                    name, src, q, k, v, causal, window, cap, True,
                    part).items()})
            row.append([name, errs])
        print(json.dumps({"case": [b, t, s, h, kv, d, causal, window, cap],
                          "max_abs_err": row}), flush=True)


PHASES = ("wait_k", "turn", "issue", "wait_s", "softmax", "wait_pv",
          "pack", "epilogue")


def phases(lib, src, name) -> dict:
    """One launch of the FLASH_FWD_PHASES build at a shape: its consumer
    warps' cycles a warp and key tile in each phase (the epilogue's a
    warp), from the sums the kernel's head dim accumulates."""
    b, t, s, h, kv, d, causal, window, train = SHAPES[name]
    take = getattr(lib, f"flash_fwd_phases_d{d}")
    take.argtypes = [ctypes.c_void_p]
    take.restype = ctypes.c_int
    q, k, v = inputs(b, t, s, h, kv, d)
    out = torch.empty_like(q)
    sums = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    src(q, k, v, out, causal, window)          # warm-up
    torch.cuda.synchronize()
    take(sums)
    src(q, k, v, out, causal, window)
    torch.cuda.synchronize()
    if take(sums):
        raise RuntimeError("flash_fwd_phases: copy failed")
    tiles = sums[len(PHASES)]
    warps = b * h * -(-t // 128) * 8
    per = {p: sums[i] / tiles for i, p in enumerate(PHASES)}
    per["epilogue"] = sums[PHASES.index("epilogue")] / warps
    per["tiles_a_warp"] = tiles / warps
    return per


def events_ms(fn, iters) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def time_shape(name, srcs, rounds) -> dict:
    from repro_torch.kernels import flash_attention, ref

    b, t, s, h, kv, d, causal, window, train = SHAPES[name]
    q, k, v = inputs(b, t, s, h, kv, d)
    out = torch.empty_like(q)
    o32 = lse = None
    if train:
        o32 = torch.empty(q.shape, dtype=torch.float32, device="cuda")
        lse = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
    usable = {n: src for n, src in srcs.items()
              if not train or src.lse is not None}
    part = ((slice(0, 1), slice(0, h // kv)), (slice(0, 1), slice(0, 1)))
    errs = {n: check(n, src, q, k, v, causal, window, None, train, part)
            for n, src in usable.items() if n not in WRONG}
    qt = q.transpose(1, 2)
    if window is None:
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        kw = dict(is_causal=causal, enable_gqa=kv != h)
    else:
        kt, vt = (x.repeat_interleave(h // kv, dim=2).transpose(1, 2)
                  for x in (k, v))
        kw = dict(attn_mask=ref._band(t, s, causal, window, "cuda"))
    runs = {n: (lambda src=src: src(q, k, v, out, causal, window, None, o32,
                                    lse))
            for n, src in usable.items()}
    runs["sdpa"] = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, **kw)
    iters = {n: max(3, min(200, round(TARGET_MS / events_ms(fn, 1))))
             for n, fn in runs.items()}
    order = list(usable) + list(usable)[::-1] + ["sdpa"]
    times = {n: [] for n in runs}
    for rnd in range(rounds):
        row = []
        for n in order:
            ms = events_ms(runs[n], iters[n])
            times[n].append(ms)
            row.append([n, ms])
        print(json.dumps({"shape": name, "round": rnd, "ms": row}),
              flush=True)
    n_bytes, flops = flash_attention.fwd_work(q, k, causal, window,
                                              with_lse=train)
    bound = max(n_bytes / BYTES_PER_S, flops / FLOPS_PER_S) * 1e3
    return {"median_ms": {n: statistics.median(x) for n, x in times.items()},
            "bound_ms": bound, "iters": iters, "max_abs_err": errs}


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bf16_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--cases", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dims", default="")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    shapes = args.shape or ["llama"]
    if shapes == ["all"]:
        shapes = list(SHAPES)
    unknown = [n for n in shapes if n not in SHAPES]
    if unknown:
        raise SystemExit(f"unknown shapes {unknown}; known: {list(SHAPES)}")

    header = (CSRC / "flash_fwd.cuh").read_text()
    tus = {f: (CSRC / f).read_text() for f in FLASH_TUS}
    cases = CASES
    if args.dims:
        keep = {int(d) for d in args.dims.split(",")}
        for d in (16, 32, 64, 80, 128, 256):
            if d not in keep:
                tus[f"flash_fwd_d{d}.cu"] = stub(d)
        cases = [c for c in CASES if c[5] in keep]
        missing = [n for n in shapes if SHAPES[n][5] not in keep]
        if missing:
            raise SystemExit(f"shapes {missing} need head dims not built")
    sources = {"as_built": {**tus, "flash_fwd.cuh": header}}
    for name, text in variants(header).items():
        if args.variants or name in args.variant:
            sources[name] = {**tus, "flash_fwd.cuh": text}
    if args.phases:
        accessor = ('\nextern "C" int flash_fwd_phases_d{d}(unsigned long '
                    'long* out) {{\n  return fwd_phases_take(out);\n}}\n')
        sources["phases"] = {
            **{f: text + (accessor.format(d=f[11:-3])
                          if f.startswith("flash_fwd_d") and "launch<" in text
                          and "NotSupported" not in text else "")
               for f, text in tus.items()},
            "flash_fwd.cuh": "#define FLASH_FWD_PHASES\n" + header}
    kinds = {name: (True, True) for name in sources}
    for path in map(Path, args.baseline):
        text = path.read_text()
        sources[path.stem] = {"flash_attention.cu": text}
        kinds[path.stem] = entry_kinds(text)
    libs = build(sources)
    srcs = {name: Source(libs[name], *kinds[name]) for name in sources}
    if args.cases:
        run_cases(srcs, cases)
    result = {}
    if args.phases:
        result["phases"] = {n: phases(libs["phases"], srcs["phases"], n)
                            for n in shapes}
        print(json.dumps({"phases": result["phases"]}), flush=True)
    for name in shapes:
        result[name] = time_shape(name, srcs, args.rounds)
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
