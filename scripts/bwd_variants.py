"""The two training backward kernels and variants of them side by side on
one CUDA card.

    python3 scripts/bwd_variants.py [--baseline OLD.cu ...]
                                    [--baseline-bf16-o OLD.cu ...]

Builds ``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` and
``selective_scan_bwd.cu`` as they are and variants made from them by exact
text substitutions, each into its own library under
``build/bwd_variants/`` (all ``nvcc`` processes started together, the
shared ``device_helpers.cuh`` on the include path):

* ``flash``       as built: P and dS as two bf16 terms each;
* ``flash_1term`` P and dS as one bf16 term (the lo products dropped):
  faster, but past the 2^-8 tolerance (reported, not gated);
* ``scan``        as built: 2 channels a lane, 128 channels a CTA,
  checkpoints every 16 steps, 8-step parts (2.5 exponentials per
  (b, t, d, n));
* ``scan_steps8`` checkpoints every 8 steps (2 exponentials, twice the
  checkpoint bytes);
* ``scan_k1``     1 channel a lane, 128 channels a CTA: 512 threads with
  at most 128 registers (16 warps an SM, from 8);
* ``scan_k1_c64`` 1 channel a lane, 64 channels a CTA, 2 CTAs an SM;

and, with ``--baseline`` (repeatable), other sources of either entry
point (earlier versions, such as ``git show
<commit>:src/repro_torch/kernels/csrc/selective_scan_bwd.cu``), each named
by its file's stem; a scan baseline's channels and checkpoint interval are
read from its constants.  A flash source given by ``--baseline`` has the
entry point of ``flash_attention_bwd.cu`` as it is (O in q's dtype or in
float32, and the ``o_f32`` flag) and gets the forward's float32 output;
one given by ``--baseline-bf16-o`` has the entry point of the sources
before the float32 O (no ``o_f32``) and gets the bf16 output.  Each is
held to the plain version (``ref.attention_bwd`` fed the same O,
``ref.selective_scan_bwd``) at ``chip_smoke.py``'s
train shapes and tolerances, and to itself bit for bit on a second call,
then timed in turns (A B ... B A, three rounds): the kernels' device time
from the profiler around 10 back-to-back calls.  The as-built kernels'
time is also split by CUDA kernel.  Prints one JSON line per round and,
before the last line, the card's name and power limit; the last line
holds the medians.  Needs one card and ``nvcc``; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
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
FLASH_ENTRY = "flash_attention_bwd_launch"
SCAN_ENTRY = "selective_scan_bwd_launch"


def sub(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"variant text not found once: {old!r}")
    return src.replace(old, new)


def variants() -> dict[str, tuple[str, str]]:
    """name -> (entry point, source)."""
    flash = (CSRC / "flash_attention_bwd.cu").read_text()
    scan = (CSRC / "selective_scan_bwd.cu").read_text()
    k1 = sub(scan, "constexpr int kPerThread = 2;",
             "constexpr int kPerThread = 1;")
    return {
        "flash": (FLASH_ENTRY, flash),
        "flash_1term": (FLASH_ENTRY, sub(
            flash, "      mma_bf16(acc[2 * np], lo, b[0], b[1]);\n"
            "      mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);\n", "")),
        "scan": (SCAN_ENTRY, scan),
        "scan_steps8": (SCAN_ENTRY, sub(scan, "constexpr int kSteps = 16;",
                                        "constexpr int kSteps = 8;")),
        "scan_k1": (SCAN_ENTRY, k1),
        "scan_k1_c64": (SCAN_ENTRY, sub(sub(
            k1, "constexpr int kChannels = 128;",
            "constexpr int kChannels = 64;"),
            "__launch_bounds__(threads_for_lanes(L), 4 / L)",
            "__launch_bounds__(threads_for_lanes(L), 8 / L)")),
    }


def scan_geometry(src: str) -> tuple[int, int]:
    """(channels a CTA, checkpoint interval) from a scan source's
    constants (this version's names or the first version's)."""
    ch = re.search(r"constexpr int (?:kChannels|kCh) = (\d+);", src)
    st = re.search(r"constexpr int (?:kSteps|kT) = (\d+);", src)
    return int(ch[1]), int(st[1])


def has_softcap(src: str) -> bool:
    """Whether a flash backward source's entry point takes a softcap."""
    entry = re.search(rf"{FLASH_ENTRY}\((.*?)\)", src, re.S)
    return entry is not None and "float softcap" in entry[1]


def build(sources: dict[str, tuple[str, str]], bf16_o: set[str]) -> dict:
    """One library a variant, built with the port's nvcc flags; the flash
    sources named in ``bf16_o`` have the entry point without ``o_f32``."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, text) in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC),
             "-Xptxas", "-v", "-shared", "-o", str(OUT / f"lib{name}.so"),
             str(cu), str(CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        # the most registers any kernel of the library takes (ptxas)
        regs[name] = max(map(int, re.findall(r"Used (\d+) registers", log)))
        entry = sources[name][0]
        fn = getattr(ctypes.CDLL(str(OUT / f"lib{name}.so")), entry)
        n_int = 9 if name in bf16_o else 10
        # sources since the softcap take it after the scale
        n_float = 2 if has_softcap(sources[name][1]) else 1
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p]
                       if entry == FLASH_ENTRY else
                       [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[])
    ap.add_argument("--baseline-bf16-o", action="append", default=[])
    args = ap.parse_args()
    import chip_smoke as cs
    from repro_torch.kernels import ref

    torch.backends.cuda.matmul.allow_tf32 = False
    sources = variants()
    geometry = {n: scan_geometry(src) for n, (e, src) in sources.items()
                if e == SCAN_ENTRY}
    bf16_o = {Path(p).stem for p in args.baseline_bf16_o}
    for path in map(Path, args.baseline + args.baseline_bf16_o):
        text = path.read_text()
        entry = FLASH_ENTRY if FLASH_ENTRY in text else SCAN_ENTRY
        if path.stem in bf16_o and entry != FLASH_ENTRY:
            raise ValueError(f"--baseline-bf16-o {path}: not a flash source")
        sources[path.stem] = (entry, text)
        if entry == SCAN_ENTRY:
            geometry[path.stem] = scan_geometry(text)
    fns, regs = build(sources, bf16_o)
    stream = torch.cuda.current_stream().cuda_stream

    q, k, v = cs.attn_inputs(cs.TRAIN_BATCH, cs.TRAIN_SEQ, cs.TRAIN_SEQ, 32,
                             8, 64, torch.bfloat16)
    do = cs.upstream_grad(q)
    o, lse, o32 = ref.attention_lse(q, k, v)
    b, t, h, d = q.shape
    fl_out = [torch.empty_like(x) for x in (q, k, v)] + [
        torch.empty((b, h, t), dtype=torch.float32, device="cuda")]

    def flash(name):
        f32_o = name not in bf16_o
        code = fns[name](*(x.data_ptr() for x in (q, k, v,
                                                   o32 if f32_o else o, lse,
                                                   do, *fl_out)),
                         b, t, t, h, 8, d, 1, -1, 1, *((1,) if f32_o else ()),
                         1.0 / math.sqrt(d),
                         *((0.0,) if has_softcap(sources[name][1]) else ()),
                         stream)
        if code:
            raise RuntimeError(f"{name}: launch failed ({code})")
        return [x.clone() for x in fl_out[:3]]

    ins = cs.scan_inputs(cs.TRAIN_BATCH, cs.TRAIN_SEQ, 8192, 16)
    dy = cs.upstream_grad(ins[0])
    bs, ts, ds = ins[0].shape
    f32 = dict(dtype=torch.float32, device="cuda")
    sc_out = [torch.empty_like(x) for x in (*ins[:4], ins[4])]
    scratch = {}

    def scan(name):
        if name not in scratch:
            ch, st = geometry[name]
            n_cb = -(-ds // ch)
            scratch[name] = [torch.empty((bs, -(-ts // st), ds, 16), **f32),
                             torch.empty((bs, n_cb, ts, 16), **f32),
                             torch.empty((bs, n_cb, ts, 16), **f32),
                             torch.empty((bs, ds, 16), **f32)]
        code = fns[name](*(x.data_ptr() for x in (*ins, dy)), None,
                         *(x.data_ptr() for x in (*sc_out, *scratch[name])),
                         bs, ts, ds, 16, stream)
        if code:
            raise RuntimeError(f"{name}: launch failed ({code})")
        return [x.clone() for x in sc_out]

    want = {FLASH_ENTRY: ref.attention_bwd(q, k, v, o32, lse, do),
            "flash_bf16_o": ref.attention_bwd(q, k, v, o, lse, do),
            SCAN_ENTRY: ref.selective_scan_bwd(*ins, dy)}
    tol = {FLASH_ENTRY: cs.FLASH_BWD_RTOL[torch.bfloat16],
           SCAN_ENTRY: cs.SCAN_BWD_RTOL}
    run = {n: (lambda n=n: flash(n)) if e == FLASH_ENTRY
           else (lambda n=n: scan(n)) for n, (e, _) in sources.items()}
    checks = {}
    for name, (entry, _) in sources.items():
        got, again = run[name](), run[name]()
        torch.cuda.synchronize()
        ref_of = "flash_bf16_o" if name in bf16_o else entry
        share = max(cs.max_abs_err([g], [w]) / float(w.float().abs().max())
                    for g, w in zip(got, want[ref_of]))
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        checks[name] = {"share_of_scale": share, "tol": tol[entry],
                        "deterministic": same, "registers": regs[name]}
        if name != "flash_1term" and not (share <= tol[entry] and same):
            raise RuntimeError(f"{name}: {checks[name]}")
    print(json.dumps({"checks": checks}), flush=True)

    # the as-built kernels' time by CUDA kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    split = {}
    for name, match in (("flash", "flash_bwd"), ("scan", "scan_bwd")):
        run[name]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(cs.PROFILER_SETTLE_S)
            for _ in range(ITERS):
                run[name]()
            torch.cuda.synchronize()
        split[name] = {e.key[:48]: cs.device_us(e) / ITERS / 1e3
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA
                       and match in e.key}
    print(json.dumps({"ms_by_kernel": split}), flush=True)

    order = list(sources) + list(sources)[::-1]
    times: dict[str, list[float]] = {n: [] for n in sources}
    for rnd in range(ROUNDS):
        row = {}
        for name in order:
            match = "flash_bwd" if sources[name][0] == FLASH_ENTRY \
                else "scan_bwd"
            ms, clock = cs.device_ms(run[name], ITERS, match)
            times[name].append(ms)
            row[name] = [ms, clock]
        print(json.dumps({"round": rnd, "ms": row}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"median_ms": {n: statistics.median(x)
                                    for n, x in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
