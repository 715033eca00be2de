"""What holds the radix sort and the lane-split selective scan back:
variants of each kernel side by side on one CUDA card.

    python3 scripts/sort_scan_variants.py

Builds ``src/repro_torch/kernels/csrc/block_sort.cu`` and
``selective_scan.cu`` as they are and variants made from them by exact text
substitutions, each into its own library under ``build/sort_scan_variants/``
(all ``nvcc`` processes started together), and times them with the CUDA
profiler (the device time of the work each call issues, scratch zeroing
included) over 20 calls, in turns (A B C ... C B A, three rounds):

sort, at (1, 2^19) and (16, 2^19) int32 (heavy duplicates, 1% INT32_MAX),
beside ``torch.sort(stable=True)``:

* ``as_built``     256 threads x 16 keys a tile (4096);
* ``items8``       tiles of 2048 keys (twice the CTAs, half the registers);
* ``items8_4ctas`` the same, capped at 64 registers (4 CTAs an SM);
* ``4ctas``        tiles of 4096, capped at 64 registers (4 CTAs an SM, not
  3);

scan, at the falcon-mamba prefill shape (4, 512, 8192, N = 16):

* ``as_built``     4 lanes of 4 states, each lane on 2 channels that share
  its B_t and C_t loads, up to 128 registers;
* ``k2_64regs``    the same capped at 64 registers;
* ``k1``           one channel a lane (every lane loads its own B_t, C_t);
* ``k4_64regs``    four channels a lane, 64 registers;
* ``k4_128regs``   four channels a lane, up to 128 registers;
* ``lanes2``       2 lanes of 8 states;
* ``steps32``      chunks of 32 steps in a 2-stage ring;
* ``stages4``      chunks of 16 steps in a 4-stage ring;

and, with wrong results, timing a part of the kernel:

* ``no_exp``       the exponential replaced by 1 + x: all but the
  special-function unit;
* ``no_loads``     the ring refilled by no chunk after the first two: the
  recurrence and the y stores without the reads of delta, x, B and C;
* ``loads_only``   the recurrence taken out: the reads and the y stores
  (y = x).

Every variant but the last three is held to the plain version (the sort bit for
bit, the scan within 1e-4 of the output's magnitude).  Prints one JSON line
per round and, before the last line, the card's name and power limit; the
last line is the median device time of each variant.  Needs one card and
``nvcc``; exits 1 without a card.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "sort_scan_variants"
ROWS = 1 << 19
SCAN_SHAPE = (4, 512, 8192, 16)
ITERS, ROUNDS = 20, 3
SCAN_RTOL = 1e-4                 # chip_smoke.py
PARTS = ("no_exp", "no_loads", "loads_only")   # timing only: wrong results


def sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"variant text not found: {old[:60]!r}")
    return text.replace(old, new)


def sort_variants(src: str) -> dict[str, tuple[str, int]]:
    """name -> (source, keys a tile)"""
    items8 = sub(src, "constexpr int kItems = 16;", "constexpr int kItems = 8;")
    return {
        "as_built": (src, 4096),
        "items8": (items8, 2048),
        "items8_4ctas": (sub(items8, "__launch_bounds__(kThreads)\nradix_pass",
                             "__launch_bounds__(kThreads, 4)\nradix_pass"),
                         2048),
        "4ctas": (sub(src, "__launch_bounds__(kThreads)\nradix_pass",
                      "__launch_bounds__(kThreads, 4)\nradix_pass"), 4096),
    }


def scan_variants(src: str) -> dict[str, str]:
    exp = "fast_exp2(dt[k] * a2[k][s])"
    return {
        "as_built": src,
        "k1": sub(src, "kPerThread = 2;", "kPerThread = 1;"),
        "k4_64regs": sub(src, "kPerThread = 2;", "kPerThread = 4;").replace(
            "512 / threads_for(N)", "1024 / threads_for(N)"),
        "k4_128regs": sub(src, "kPerThread = 2;", "kPerThread = 4;"),
        "lanes2": sub(src, "return n >= 10 ? 4 : (n >= 5 ? 2 : 1);",
                      "return n >= 5 ? 2 : 1;"),
        "k2_64regs": sub(src, "512 / threads_for(N)",
                         "1024 / threads_for(N)"),
        "steps32": sub(sub(src, "kSteps = 16;", "kSteps = 32;"),
                       "kStages = 3;", "kStages = 2;"),
        "stages4": sub(src, "kStages = 3;", "kStages = 4;"),
        "no_exp": sub(src, exp, "(1.f + dt[k] * a2[k][s])"),
        "no_loads": sub(src, "    if (c + kStages - 1 < chunks)\n      load_chunk",
                        "    if (false)\n      load_chunk"),
        "loads_only": sub(src, "for (int g = 0; g < kSteps; g += L)",
                          "for (int g = 0; g < 0; g += L)"),
    }


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
             "-o", str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def sort_call(lib, tile):
    from repro_torch.kernels import block_sort

    fn = lib.bitonic_sort_launch
    fn.argtypes = block_sort._ARGTYPES
    fn.restype = ctypes.c_int

    def run(keys):
        b, n = keys.shape
        out, perm, tk, tp = (torch.empty_like(keys) for _ in range(4))
        tiles = max(1, n // tile)
        sizes = [b * 4 * 256, 4 * b * tiles * 256, 4 * b]
        scratch = torch.zeros(sum(sizes), dtype=torch.int32, device="cuda")
        hist, status, counters = scratch.split(sizes)
        code = fn(keys.data_ptr(), out.data_ptr(), perm.data_ptr(),
                  tk.data_ptr(), tp.data_ptr(), hist.data_ptr(),
                  status.data_ptr(), counters.data_ptr(), b, n,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"sort launch failed: {code}")
        return out, perm
    return run


def scan_call(lib):
    from repro_torch.kernels import selective_scan

    fn = lib.selective_scan_launch
    fn.argtypes = selective_scan._ARGTYPES
    fn.restype = ctypes.c_int

    def run(delta, x, b, c, a):
        bs, t, d = delta.shape
        n = a.shape[1]
        y = torch.empty_like(delta)
        h = torch.zeros((bs, d, n), dtype=torch.float32, device="cuda")
        code = fn(delta.data_ptr(), x.data_ptr(), b.data_ptr(), c.data_ptr(),
                  a.data_ptr(), y.data_ptr(), h.data_ptr(), bs, t, d, n,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"scan launch failed: {code}")
        return y, h
    return run


def main() -> int:
    if not torch.cuda.is_available():
        print("sort_scan_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import block_sort, ref

    sorts = sort_variants((CSRC / "block_sort.cu").read_text())
    scans = scan_variants((CSRC / "selective_scan.cu").read_text())
    libs = build({**{f"sort_{k}": v[0] for k, v in sorts.items()},
                  **{f"scan_{k}": v for k, v in scans.items()}})
    rng = np.random.default_rng(0)
    cases = {}
    for b in (1, 16):
        keys = cs.sort_inputs(rng, b, ROWS)
        want = ref.sort_by_key(keys)
        plain = block_sort.bitonic_sort_plain(keys)
        for name, (_, tile) in sorts.items():
            run = sort_call(libs[f"sort_{name}"], tile)
            got = run(keys)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, w) for g, w in zip(got, want)) and all(
                torch.equal(g, w) for g, w in zip(got, plain))
            if not ok:
                raise RuntimeError(f"sort variant {name} differs at {b}")
            cases[f"sort_{b}x2^19/{name}"] = (lambda r=run, k=keys: r(k),
                                               None)
        cases[f"sort_{b}x2^19/torch.sort"] = (
            lambda k=keys: torch.sort(k, dim=-1, stable=True), None)
    inputs = cs.scan_inputs(*SCAN_SHAPE)
    want = ref.selective_scan(*inputs)
    tol = SCAN_RTOL * max(1.0, max(float(w.abs().max()) for w in want))
    for name in scans:
        run = scan_call(libs[f"scan_{name}"])
        got = run(*inputs)
        torch.cuda.synchronize()
        err = cs.max_abs_err(got, want)
        if name not in PARTS and not err <= tol:
            raise RuntimeError(f"scan variant {name}: {err} > {tol}")
        print(json.dumps({"scan": name, "max_abs_err": err, "tol": tol}),
              flush=True)
        cases[f"scan/{name}"] = (lambda r=run: r(*inputs),
                                 "selective_scan_lanes")
    names = list(cases)
    times = {k: [] for k in names}
    for rnd in range(ROUNDS):
        order = names if rnd % 2 == 0 else names[::-1]
        row = {}
        for k in order:
            fn, match = cases[k]
            row[k] = cs.device_ms(fn, ITERS, match)
            times[k].append(row[k])
        print(json.dumps({"round": rnd, "ms": row}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({"median_ms": {k: statistics.median(v)
                                    for k, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
