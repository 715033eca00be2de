"""The two training backward kernels, their variants and earlier sources
side by side on one CUDA card.

    python3 scripts/bwd_variants.py [--only flash|scan]
        [--shape NAME ... | --shape all] [--baseline OLD.cu ...]
        [--baseline-fwd OLD_selective_scan.cu]
        [--baseline-bf16-o OLD.cu ...] [--phases] [--rounds N]

The flash backward (``--only flash``, or both): builds it as it is
(``src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, the
``flash_bwd_d<D>.cu`` files and the headers they include) into its own
library under ``build/bwd_variants/``, one ``nvcc`` a translation unit,
all started together, beside

* ``flash_1term`` P and dS as one bf16 term (the lo products dropped from
  ``flash_bwd.cuh``): what the second term costs; past the 2^-8 tolerance
  (reported, not gated);

and, with ``--baseline`` (repeatable), other single-file sources of the
same entry point (earlier versions, such as ``git show
9baf62b:src/repro_torch/kernels/csrc/flash_attention_bwd.cu``, the
``mma.sync`` design), each named by its file's stem, compiled beside the
port's headers.  A flash source given by ``--baseline-bf16-o`` has the
entry point of the sources before the float32 O (no ``o_f32``) and gets
the bf16 output.  ``--shape`` (repeatable; default ``llama``; ``all`` for
every one) picks ``PERF.md`` section 6's backward rows: ``llama`` (5b),
``whisper_enc`` (5b'), ``whisper_cross`` (5b''), ``h2o`` (5b-h2o),
``qwen`` (5b-qwen), ``g4`` (5b-g4), ``g4_local`` (5b-g4'), ``mixtral``
(5b-mx), ``zamba2`` (5b-z), bf16 from the float32 O.  At each, every
source but ``flash_1term`` is held to the plain version
(``ref.attention_bwd``) on batch 0 and the first KV group (dq of its
query heads, dk and dv of its KV head) within 2^-8 of each gradient's
scale, and the source as built to itself bit for bit on a second call;
then all are timed in turns (A B ... B A, ``--rounds`` rounds, default 3)
by CUDA events around back-to-back launches (at least 3, about 100 ms of
them), with SDPA's backward beside them (``torch.autograd.grad`` through
``scaled_dot_product_attention``: causal with GQA, non-causal, or a
boolean band mask over K/V expanded to the query heads for a window).
``--phases`` also builds the source as it is with FLASH_BWD_PHASES defined
and prints, at each shape and for each kernel (the dK/dV kernel, its dV
and dK passes at D = 256, dQ), where a consumer warp's SM cycles go
(``clock64``: ``BwdPhase`` in ``flash_bwd.cuh``) a tile, and from each
CTA's ``%globaltimer`` stamps and SM the launch's makespan, the longest
CTA's share of it, the mean CTA and the busiest SM's summed CTA time
against the mean SM's.

The scan backward (``--only scan``, or both): builds
``selective_scan.cu`` and ``selective_scan_bwd.cu`` as they are and the
design's alternatives, made from them by exact text substitutions:

* ``scan``         as built: checkpoints every 8 steps from the training
  forward, one 8-step part an interval (one exponential per
  (b, t, d, n)), the factors in registers, butterflies four steps at a
  time, 8 compute warps an SM;
* ``scan_i16``     checkpoints every 16 steps (half the checkpoint bytes;
  two parts an interval, part 1's start recomputed through part 0: 1.5
  exponentials);
* ``scan_batch8``  a part's eight steps' butterflies together;
* ``scan_stages5`` a ring of 5 intervals (4 as built);
* ``scan_regs232`` the producer warpgroup at 40 registers, the compute
  warpgroups at 232 (224 as built);

and ``--baseline`` sources of its entry point (channels and checkpoint
interval read from their constants; one that makes its own forward sweep,
such as ``git show d233239:src/repro_torch/kernels/csrc/
selective_scan_bwd.cu``, pairs with the prefill's forward of
``--baseline-fwd``, else of the forward as built).  Each is held to
``ref.selective_scan_bwd`` at ``chip_smoke.py``'s train shape, its
checkpoints to ``ref.selective_scan_states``, and to itself bit for bit;
then every backward, training forward and prefill forward is timed in
turns by CUDA events.  ``--phases`` also builds the source with
SCAN_BWD_PHASES defined and prints where a compute warp's cycles go a
time step (``ScanPhase`` in ``selective_scan_bwd.cu``), each CTA's span
and SM, and the two kernels' times by events; ``ptxas -v``'s registers
and spills of every scan kernel are printed for each build.

Prints one JSON line per check, shape and round and, before the last
line, the card's name and power limit; the last line holds the medians
(and, for flash, the bound from ``bwd_work`` at 3.35 TB/s and 989 TFLOP/s,
its share of each source's time and each source's ratio to the
baselines').  Needs one card and ``nvcc``; exits 1 without a card.
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
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "bwd_variants"
ITERS, ROUNDS = 10, 3
TARGET_MS = 100.0                # launches timed back to back, about
BYTES_PER_S, FLOPS_PER_S = 3.35e12, 989e12
FLASH_ENTRY = "flash_attention_bwd_launch"
SCAN_ENTRY = "selective_scan_bwd_launch"
FLASH_TUS = ("flash_attention_bwd.cu", *(f"flash_bwd_d{d}.cu"
                                         for d in (16, 32, 64, 80, 128, 256)))
# name: (b, t, s, h, kv, d, causal, window), PERF.md section 6's rows
SHAPES = {
    "llama": (4, 512, 512, 32, 8, 64, True, None),
    "whisper_enc": (4, 1500, 1500, 16, 16, 64, False, None),
    "whisper_cross": (4, 448, 1500, 16, 16, 64, False, None),
    "h2o": (1, 8192, 8192, 32, 8, 80, True, 4096),
    "qwen": (4, 512, 512, 64, 8, 128, True, None),
    "g4": (1, 4096, 4096, 8, 4, 256, True, None),
    "g4_local": (1, 4096, 4096, 8, 4, 256, True, 1024),
    "mixtral": (1, 8192, 8192, 48, 8, 128, True, 4096),
    "zamba2": (1, 4096, 4096, 32, 32, 80, True, None),
}
PHASES = ("loop", "wait", "scores", "softmax", "grads", "epilogue")
KERNEL_SLOTS = ("dkdv", "dkdv_dv_pass", "dkdv_dk_pass", "dq")
MAX_CTAS = 1 << 14               # kBwdMaxCtas in flash_bwd.cuh


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"variant text not found once: {old!r}")
    return src.replace(old, new)


def flash_sources(phases: bool) -> dict[str, dict[str, str]]:
    """name -> {file: text} of the flash backward as built, its one-term
    variant and (``phases``) its FLASH_BWD_PHASES build."""
    header = (CSRC / "flash_bwd.cuh").read_text()
    tus = {f: (CSRC / f).read_text() for f in FLASH_TUS}
    out = {
        "flash": {**tus, "flash_bwd.cuh": header},
        "flash_1term": {**tus, "flash_bwd.cuh": sub(
            header, "    issue_pv_step<D, N>(acc, lo[kc], b_tile, kc);\n",
            "")},
    }
    if phases:
        accessor = ('\nextern "C" int flash_bwd_phases_d{d}(unsigned long '
                    'long* sums, unsigned long long* stamps) {{\n  return '
                    'bwd_phases_take(sums, stamps);\n}}\n')
        out["phases"] = {
            **{f: text + (accessor.format(d=f[11:-3])
                          if f.startswith("flash_bwd_d") else "")
               for f, text in tus.items()},
            "flash_bwd.cuh": "#define FLASH_BWD_PHASES\n" + header}
    return out


SCAN_FWD, SCAN_BWD = "selective_scan.cu", "selective_scan_bwd.cu"
SCAN_PHASES = ("fwd_sweep", "wait", "recompute", "reverse", "butterfly",
               "stores", "partials")
SCAN_MAX_CTAS = 1 << 12          # kMaxCtas in selective_scan_bwd.cu


def scan_variants(fwd: str, bwd: str) -> dict[str, dict[str, str]]:
    """The design's own alternatives, made from the sources as built by
    exact text substitutions (name -> {file: text})."""
    if "selective_scan_ckpt_launch" not in fwd:
        return {}
    return {
        # checkpoints every 16 steps: half the checkpoint bytes, two parts
        # an interval, part 1's start recomputed through part 0 (1.5
        # exponentials an element)
        "scan_i16": {
            SCAN_FWD: sub(fwd, "constexpr int kCkptSteps = 8;",
                          "constexpr int kCkptSteps = 16;"),
            SCAN_BWD: sub(bwd, "constexpr int kSteps = 8;",
                          "constexpr int kSteps = 16;")},
        # the part's eight steps' butterflies together (more registers)
        "scan_batch8": {SCAN_FWD: fwd, SCAN_BWD: sub(
            bwd, "constexpr int kBatch = 4;", "constexpr int kBatch = 8;")},
        # a ring of 5 intervals
        "scan_stages5": {SCAN_FWD: fwd, SCAN_BWD: sub(
            bwd, "constexpr int kStages = kSteps == 8 ? 4 : 3;",
            "constexpr int kStages = kSteps == 8 ? 5 : 3;")},
        # the producer warpgroup at 40 registers, the compute ones at 232
        "scan_regs232": {SCAN_FWD: fwd, SCAN_BWD: sub(sub(
            bwd, "constexpr int kProducerRegs = 56;",
            "constexpr int kProducerRegs = 40;"),
            "constexpr int kComputeRegs = 224;",
            "constexpr int kComputeRegs = 232;")},
    }


def scan_sources(phases: bool, baselines: list[Path],
                 baseline_fwd: Path | None) -> dict[str, dict[str, str]]:
    """name -> {file: text}: the scan as built, its variants, its
    SCAN_BWD_PHASES build (``phases``) and the baselines' backward sources
    (one that makes its own forward sweep beside ``baseline_fwd``, else
the forward as built)."""
    fwd, bwd = (CSRC / SCAN_FWD).read_text(), (CSRC / SCAN_BWD).read_text()
    out = {"scan": {SCAN_FWD: fwd, SCAN_BWD: bwd}, **scan_variants(fwd, bwd)}
    if phases:
        out["scan_phases"] = {SCAN_FWD: fwd,
                              SCAN_BWD: "#define SCAN_BWD_PHASES\n" + bwd}
    old_fwd = fwd if baseline_fwd is None else baseline_fwd.read_text()
    for path in baselines:
        text = path.read_text()
        if SCAN_ENTRY in text:
            out[path.stem] = {SCAN_FWD: fwd if takes_ckpt(text) else old_fwd,
                              SCAN_BWD: text}
    return out


def scan_geometry(src: str) -> tuple[int, int]:
    """(channels a CTA, checkpoint interval) from a scan source's
    constants (this version's names or the first version's)."""
    ch = re.search(r"constexpr int (?:kChannels|kCh) = (\d+);", src)
    st = re.search(r"constexpr int (?:kSteps|kT) = (\d+);", src)
    return int(ch[1]), int(st[1])


def takes_ckpt(src: str) -> bool:
    """Whether a backward source's entry point reads the training
    forward's checkpoints (else it makes its own forward sweep)."""
    entry = re.search(rf"{SCAN_ENTRY}\((.*?)\)", src, re.S)
    return entry is not None and "const void* ckpt" in entry[1]


def has_softcap(src: str) -> bool:
    """Whether a flash backward source's entry point takes a softcap."""
    entry = re.search(rf"{FLASH_ENTRY}\((.*?)\)", src, re.S)
    return entry is not None and "float softcap" in entry[1]


def build(sources: dict[str, dict[str, str]]) -> tuple[dict, dict]:
    """One library a source (files -> text, compiled beside the port's
    headers), built with the port's nvcc flags, every translation unit's
    nvcc started together -> (libraries, ptxas output a source)."""
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
    return libs, logs


class FlashSource:
    """A built library's backward entry, called as the wrapper calls it."""

    def __init__(self, lib, softcap: bool, f32_o: bool):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.fn = getattr(lib, FLASH_ENTRY)
        self.fn.argtypes = ([p] * 10 + [i] * (10 if f32_o else 9)
                            + [f] * (2 if softcap else 1) + [p])
        self.fn.restype = i
        self.softcap, self.f32_o = softcap, f32_o

    def __call__(self, q, k, v, o, o32, lse, do, out, causal, window):
        b, t, h, d = q.shape
        s, kv = k.shape[1], k.shape[2]
        ints = [b, t, s, h, kv, d, int(causal),
                -1 if window is None else window, 1]
        if self.f32_o:
            ints.append(1)
        code = self.fn(*(x.data_ptr() for x in (
            q, k, v, o32 if self.f32_o else o, lse, do, *out)), *ints,
            1.0 / math.sqrt(d), *((0.0,) if self.softcap else ()),
            torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed ({code})")
        return out[:3]


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


def flash_inputs(b, t, s, h, kv, d, causal, window):
    """q, k, v, dO in bf16 from a seed; the forward's O (bf16 and float32)
    and lse from the plain version, a KV group at a time."""
    from repro_torch.kernels import ref

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16)
                   for shape in ((b, t, h, d), (b, s, kv, d), (b, s, kv, d),
                                 (b, t, h, d)))
    o32 = torch.empty(q.shape, dtype=torch.float32, device="cuda")
    lse = torch.empty((b, h, t), dtype=torch.float32, device="cuda")
    rep = h // kv
    for gi in range(kv):
        hs = slice(gi * rep, gi * rep + rep)
        _, lse[:, hs], o32[:, :, hs] = ref.attention_lse(
            q[:, :, hs].contiguous(), k[:, :, gi:gi + 1].contiguous(),
            v[:, :, gi:gi + 1].contiguous(), causal=causal, window=window)
    return q, k, v, do, o32.to(torch.bfloat16), o32, lse


def flash_check(name, src, ins, out, causal, window, tol) -> dict:
    """The source against ``ref.attention_bwd`` on batch 0 and the first
    KV group: each gradient's max error as a share of its scale."""
    from repro_torch.kernels import ref

    q, k, v, do, o, o32, lse = ins
    got = [x.clone() for x in src(q, k, v, o, o32, lse, do, out, causal,
                                  window)]
    rep = q.shape[2] // k.shape[2]
    part = (slice(0, 1), slice(0, rep))
    qp, dop, o32p = (x[part[0], :, part[1]].contiguous()
                     for x in (q, do, o32 if src.f32_o else o))
    kp, vp = (x[0:1, :, 0:1].contiguous() for x in (k, v))
    want = ref.attention_bwd(qp.float(), kp.float(), vp.float(), o32p,
                             lse[0:1, part[1]].contiguous(), dop.float(),
                             causal=causal, window=window)
    mine = [got[0][0:1, :, part[1]], got[1][0:1, :, 0:1],
            got[2][0:1, :, 0:1]]
    shares = [float((m.double() - w.double()).abs().max()
                    / max(float(w.abs().max()), 1e-30))
              for m, w in zip(mine, want)]
    same = None
    if name == "flash":
        again = src(q, k, v, o, o32, lse, do, out, causal, window)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = max(shares) <= tol and same is not False
    if name != "flash_1term" and not ok:
        raise RuntimeError(f"{name}: shares {shares} > {tol} or second call "
                           f"differs ({same})")
    return {"share_of_scale": shares, "bit_equal_again": same}


def phase_table(lib, src, ins, out, causal, window, d) -> dict:
    """One launch of the FLASH_BWD_PHASES build: per kernel, a consumer
    warp's cycles a tile in each phase (the epilogue's a warp), and the
    CTAs' makespan, longest CTA, mean CTA and SM loads (ms)."""
    take = getattr(lib, f"flash_bwd_phases_d{d}")
    take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    take.restype = ctypes.c_int
    n_ph = len(PHASES) + 1
    sums = (ctypes.c_ulonglong * (len(KERNEL_SLOTS) * n_ph))()
    stamps = (ctypes.c_ulonglong * (len(KERNEL_SLOTS) * MAX_CTAS * 3))()
    q, k, v, do, o, o32, lse = ins
    src(q, k, v, o, o32, lse, do, out, causal, window)   # warm-up
    torch.cuda.synchronize()
    take(sums, stamps)
    src(q, k, v, o, o32, lse, do, out, causal, window)
    torch.cuda.synchronize()
    if take(sums, stamps):
        raise RuntimeError("flash_bwd_phases: copy failed")
    table = {}
    for slot, kernel in enumerate(KERNEL_SLOTS):
        row = sums[slot * n_ph:(slot + 1) * n_ph]
        base = slot * MAX_CTAS * 3
        ctas = [(stamps[base + 3 * i], stamps[base + 3 * i + 1],
                 stamps[base + 3 * i + 2]) for i in range(MAX_CTAS)
                if stamps[base + 3 * i]]
        if not ctas:
            continue
        tiles = row[len(PHASES)]
        warps = 8 * len(ctas)
        per = {p: row[i] / max(tiles, 1) for i, p in enumerate(PHASES)}
        per["epilogue"] = row[PHASES.index("epilogue")] / warps
        per["tiles_a_warp"] = tiles / warps
        t0 = min(c[0] for c in ctas)
        span = max(c[1] for c in ctas) - t0
        durs = [c[1] - c[0] for c in ctas]
        by_sm: dict[int, int] = {}
        for (a, z, sm), dur in zip(ctas, durs):
            by_sm[sm] = by_sm.get(sm, 0) + dur
        table[kernel] = {
            "cycles_a_warp_tile": per, "ctas": len(ctas),
            "makespan_ms": span / 1e6,
            "longest_cta_ms": max(durs) / 1e6,
            "longest_cta_share": max(durs) / span,
            "mean_cta_ms": statistics.mean(durs) / 1e6,
            "busiest_sm_ms": max(by_sm.values()) / 1e6,
            "mean_sm_ms": statistics.mean(by_sm.values()) / 1e6,
            "sms": len(by_sm),
            "ctas_truncated": len(ctas) >= MAX_CTAS}
    return table


def sdpa_backward(q, k, v, do, causal, window):
    """A call of SDPA's backward on the same inputs (its forward run
    once)."""
    from repro_torch.kernels import ref

    b, t, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if window is None:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        kw = dict(is_causal=causal, enable_gqa=kv != h)
    else:
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k.repeat_interleave(h // kv, dim=2),
                                v.repeat_interleave(h // kv, dim=2)))
        kw = dict(attn_mask=ref._band(t, s, causal, window, "cuda"))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, **kw)
    do_t = do.transpose(1, 2)
    return lambda: torch.autograd.grad(out, (qt, kt, vt), do_t,
                                       retain_graph=True)


def run_flash(args) -> dict:
    from repro_torch.kernels import flash_attention

    shapes = args.shape or ["llama"]
    if shapes == ["all"]:
        shapes = list(SHAPES)
    unknown = [n for n in shapes if n not in SHAPES]
    if unknown:
        raise SystemExit(f"unknown shapes {unknown}; known: {list(SHAPES)}")
    files = flash_sources(args.phases)
    kinds = {name: (True, True) for name in files}
    bf16_o = {Path(p).stem for p in args.baseline_bf16_o}
    for path in map(Path, args.baseline + args.baseline_bf16_o):
        text = path.read_text()
        if FLASH_ENTRY not in text:
            continue
        files[path.stem] = {"flash_attention_bwd.cu": text}
        kinds[path.stem] = (has_softcap(text), path.stem not in bf16_o)
    libs, logs = build(files)
    srcs = {name: FlashSource(libs[name], *kinds[name]) for name in files}
    timed = [n for n in srcs if n != "phases"]
    baselines = [n for n in timed if n not in ("flash", "flash_1term")]
    result = {}
    for shape in shapes:
        b, t, s, h, kv, d, causal, window = SHAPES[shape]
        ins = flash_inputs(b, t, s, h, kv, d, causal, window)
        q, k, v, do = ins[:4]
        out = [torch.empty_like(x) for x in (q, k, v)] + [
            torch.empty((b, h, t), dtype=torch.float32, device="cuda")]
        checks = {n: flash_check(n, srcs[n], ins, out, causal, window,
                                 2 ** -8) for n in timed}
        print(json.dumps({"shape": shape, "checks": checks}), flush=True)
        if args.phases:
            table = phase_table(libs["phases"], srcs["phases"], ins, out,
                                causal, window, d)
            print(json.dumps({"shape": shape, "phases": table}), flush=True)
            result.setdefault("phases", {})[shape] = table
        runs = {n: (lambda n=n: srcs[n](*ins[:3], ins[4], ins[5], ins[6],
                                        ins[3], out, causal, window))
                for n in timed}
        runs["sdpa_bwd"] = sdpa_backward(q, k, v, do, causal, window)
        iters = {n: max(3, min(200, round(TARGET_MS / events_ms(fn, 1))))
                 for n, fn in runs.items()}
        order = timed + timed[::-1] + ["sdpa_bwd"]
        times = {n: [] for n in runs}
        for rnd in range(args.rounds):
            row = []
            for n in order:
                ms = events_ms(runs[n], iters[n])
                times[n].append(ms)
                row.append([n, ms])
            print(json.dumps({"shape": shape, "round": rnd, "ms": row}),
                  flush=True)
        n_bytes, flops = flash_attention.bwd_work(q, k, causal, window)
        bound = max(n_bytes / BYTES_PER_S, flops / FLOPS_PER_S) * 1e3
        med = {n: statistics.median(x) for n, x in times.items()}
        result[shape] = {
            "median_ms": med, "bound_ms": bound,
            "share_of_bound": {n: bound / med[n] for n in timed},
            "speedup_over": {base: med[base] / med["flash"]
                             for base in baselines},
            "iters": iters}
        del ins, q, k, v, do, out, runs
        torch.cuda.empty_cache()
    regs = {n: [int(x) for x in re.findall(r"Used (\d+) registers", log)]
            for n, log in logs.items()}
    result["ptxas_wgmma_serialized"] = {
        n: re.findall(r"C7512\).*?for the function '(\S+)'", log)
        for n, log in logs.items()}
    result["max_registers"] = {n: max(r) for n, r in regs.items() if r}
    return result


class ScanSource:
    """A built library's training forward and backward, called as the
    wrappers call them.  A backward that reads checkpoints pairs with
    ``selective_scan_ckpt_launch``; one that makes its own forward sweep
    with the prefill's ``selective_scan_launch``."""

    def __init__(self, lib, files: dict[str, str]):
        p, i = ctypes.c_void_p, ctypes.c_int
        self.new = takes_ckpt(files[SCAN_BWD])
        self.channels, self.steps = scan_geometry(files[SCAN_BWD])
        self.prefill = lib.selective_scan_launch
        self.prefill.argtypes = [p] * 7 + [i] * 4 + [p]
        self.prefill.restype = i
        if self.new:
            self.fwd = lib.selective_scan_ckpt_launch
            self.fwd.argtypes = [p] * 8 + [i] * 4 + [p]
            self.fwd.restype = i
        self.bwd = getattr(lib, SCAN_ENTRY)
        self.bwd.argtypes = [p] * 16 + [i] * 4 + [p]
        self.bwd.restype = i
        self.take = getattr(lib, "selective_scan_bwd_phases", None)
        self.scratch = None

    def setup(self, ins):
        bs, ts, ds = ins[0].shape
        n = ins[4].shape[1]
        f32 = dict(dtype=torch.float32, device="cuda")
        n_cb = -(-ds // self.channels)
        self.y = torch.empty_like(ins[0])
        self.h = torch.empty((bs, ds, n), **f32)
        self.ckpt = torch.empty((bs, -(-ts // self.steps), ds, n), **f32)
        self.scratch = [torch.empty((bs, n_cb, ts, n), **f32),
                        torch.empty((bs, n_cb, ts, n), **f32),
                        torch.empty((bs, ds, n), **f32)]
        self.out = [torch.empty_like(x) for x in (*ins[:4], ins[4])]

    def _dims(self, ins):
        bs, ts, ds = ins[0].shape
        return bs, ts, ds, ins[4].shape[1], \
            torch.cuda.current_stream().cuda_stream

    def run_prefill(self, ins):
        code = self.prefill(*(x.data_ptr() for x in ins),
                            self.y.data_ptr(), self.h.data_ptr(),
                            *self._dims(ins))
        if code:
            raise RuntimeError(f"selective_scan_launch failed ({code})")

    def run_fwd(self, ins):
        """The training forward (the prefill's for a source that makes its
        own forward sweep)."""
        if not self.new:
            return self.run_prefill(ins)
        code = self.fwd(*(x.data_ptr() for x in ins), self.y.data_ptr(),
                        self.h.data_ptr(), self.ckpt.data_ptr(),
                        *self._dims(ins))
        if code:
            raise RuntimeError(f"selective_scan_ckpt_launch failed ({code})")

    def run_bwd(self, ins, dy):
        ptr = [x.data_ptr() for x in ins]
        outs = [x.data_ptr() for x in self.out]
        part = [x.data_ptr() for x in self.scratch]
        if self.new:   # delta..a, ckpt, dy, dh, outputs, part_b/c/a
            args = [*ptr, self.ckpt.data_ptr(), dy.data_ptr(), None, *outs,
                    *part]
        else:          # delta..a, dy, dh, outputs, ckpt scratch, part_b/c/a
            args = [*ptr, dy.data_ptr(), None, *outs, self.ckpt.data_ptr(),
                    *part]
        code = self.bwd(*args, *self._dims(ins))
        if code:
            raise RuntimeError(f"{SCAN_ENTRY} failed ({code})")
        return self.out


def scan_phase_table(src: ScanSource, ins, dy) -> dict:
    """One launch of the SCAN_BWD_PHASES build: a warp's cycles a time step
    in each phase, the CTAs' makespan, longest and mean CTA and SM loads,
    and the scan and reduce kernels' times by CUDA events (ms)."""
    n_ph = len(SCAN_PHASES) + 1
    sums = (ctypes.c_ulonglong * n_ph)()
    stamps = (ctypes.c_ulonglong * (SCAN_MAX_CTAS * 3))()
    ms = (ctypes.c_float * 2)()
    src.take.argtypes = [ctypes.c_void_p] * 3
    src.take.restype = ctypes.c_int
    src.run_fwd(ins)
    src.run_bwd(ins, dy)
    torch.cuda.synchronize()
    src.take(sums, stamps, ms)
    src.run_bwd(ins, dy)
    torch.cuda.synchronize()
    if src.take(sums, stamps, ms):
        raise RuntimeError("selective_scan_bwd_phases: copy failed")
    warp_intervals = sums[len(SCAN_PHASES)]
    steps = warp_intervals * src.steps
    ctas = [(stamps[3 * i], stamps[3 * i + 1], stamps[3 * i + 2])
            for i in range(SCAN_MAX_CTAS) if stamps[3 * i]]
    t0 = min(c[0] for c in ctas)
    span = max(c[1] for c in ctas) - t0
    durs = [c[1] - c[0] for c in ctas]
    by_sm: dict[int, int] = {}
    for (_, _, sm), dur in zip(ctas, durs):
        by_sm[sm] = by_sm.get(sm, 0) + dur
    per = {p: sums[i] / max(steps, 1) for i, p in enumerate(SCAN_PHASES)}
    return {"cycles_a_warp_step": per,
            "cycles_a_warp_step_total": sum(per.values()),
            "warp_intervals": warp_intervals, "ctas": len(ctas),
            "makespan_ms": span / 1e6, "longest_cta_ms": max(durs) / 1e6,
            "mean_cta_ms": statistics.mean(durs) / 1e6,
            "busiest_sm_ms": max(by_sm.values()) / 1e6,
            "mean_sm_ms": statistics.mean(by_sm.values()) / 1e6,
            "sms": len(by_sm), "scan_kernel_events_ms": ms[0],
            "reduce_kernel_events_ms": ms[1]}


def run_scan(args) -> dict:
    import chip_smoke as cs
    from repro_torch.kernels import ref, selective_scan

    files = scan_sources(args.phases, list(map(Path, args.baseline)),
                         Path(args.baseline_fwd) if args.baseline_fwd
                         else None)
    libs, logs = build(files)
    srcs = {n: ScanSource(libs[n], files[n]) for n in files}
    ptxas = {n: cs.ptxas_scan(log) for n, log in logs.items()}
    print(json.dumps({"scan_ptxas": ptxas}), flush=True)
    ins = cs.scan_inputs(cs.TRAIN_BATCH, cs.TRAIN_SEQ, 8192, 16)
    dy = cs.upstream_grad(ins[0])
    want = ref.selective_scan_bwd(*ins, dy)
    checks = {}
    for name, src in srcs.items():
        src.setup(ins)
        src.run_fwd(ins)
        got = [x.clone() for x in src.run_bwd(ins, dy)]
        again = src.run_bwd(ins, dy)
        torch.cuda.synchronize()
        share = max(cs.max_abs_err([g], [w]) / float(w.float().abs().max())
                    for g, w in zip(got, want))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        checks[name] = {"share_of_scale": share, "tol": cs.SCAN_BWD_RTOL,
                        "deterministic": same}
        if src.new:
            states = ref.selective_scan_states(*ins, src.steps)
            checks[name]["ckpt_share_of_scale"] = cs.max_abs_err(
                [src.ckpt], [states]) / float(states.abs().max())
            same = same and checks[name]["ckpt_share_of_scale"] <= 1e-5
        if not (share <= cs.SCAN_BWD_RTOL and same):
            raise RuntimeError(f"{name}: {checks[name]}")
        del got, again
    print(json.dumps({"scan_checks": checks}), flush=True)
    result = {"checks": checks, "ptxas": ptxas}
    if "scan_phases" in srcs:
        result["phases"] = scan_phase_table(srcs["scan_phases"], ins, dy)
        print(json.dumps({"scan_phases": result["phases"]}), flush=True)
    for name in [n for n in srcs if n != "scan" and srcs[n].take]:
        del srcs[name]     # only the phases build has the accessor
    runs = {}
    for name, src in srcs.items():
        runs[f"{name}:bwd"] = lambda s=src: s.run_bwd(ins, dy)
        runs[f"{name}:fwd"] = lambda s=src: s.run_fwd(ins)
        runs[f"{name}:prefill"] = lambda s=src: s.run_prefill(ins)
    iters = {n: max(3, min(200, round(TARGET_MS / events_ms(fn, 1))))
             for n, fn in runs.items()}
    order = list(runs) + list(runs)[::-1]
    times: dict[str, list[float]] = {n: [] for n in runs}
    for rnd in range(args.rounds):
        row = []
        for name in order:
            ms = events_ms(runs[name], iters[name])
            times[name].append(ms)
            row.append([name, ms])
        print(json.dumps({"scan_round": rnd, "ms": row}), flush=True)
    med = {n: statistics.median(x) for n, x in times.items()}
    spread = {n: [min(x), max(x)] for n, x in times.items()}
    n_bytes, flops = selective_scan.bwd_work(ins[0], ins[2], False)
    bound = max(n_bytes / BYTES_PER_S, flops / cs.HW["peak_f32_flops"]) * 1e3
    pairs = {n: med[f"{n}:fwd"] + med[f"{n}:bwd"] for n in srcs}
    result.update({
        "median_ms": med, "min_max_ms": spread, "iters": iters,
        "fwd_plus_bwd_ms": pairs, "bwd_bound_ms": bound,
        "bwd_share_of_bound": {n: bound / med[f"{n}:bwd"] for n in srcs}})
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("flash", "scan"))
    ap.add_argument("--shape", action="append", default=[])
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--baseline-bf16-o", action="append", default=[])
    ap.add_argument("--baseline-fwd")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    result = {}
    if args.only != "scan":
        result["flash"] = run_flash(args)
    if args.only != "flash":
        result["scan"] = run_scan(args)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
