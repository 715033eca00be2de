"""The fused HAIL reader and variants of it side by side on one CUDA card.

    python3 scripts/reader_variants.py [--baseline OLD.cu] [--phases]

Builds ``src/repro_torch/kernels/csrc/hail_reader.cu`` as it is and variants
made from it by exact text substitutions, each into its own library under
``build/reader_variants/`` (all ``nvcc`` processes started together):

* ``as_built``   1,024-row tiles of 256 threads, at least 8 CTAs an SM (32
  registers) for Q <= 8, where a tile's mask is one window, and 6 (40)
  above, the mask staged 8,192 bytes at a time;
* ``tile512``    512-row tiles of 128 threads (twice the CTAs);
* ``one6``       Q <= 8 at 6 CTAs an SM (40 registers), not 8 (32);

and, with ``--baseline`` (repeatable), other sources of the same entry
point (earlier versions of the kernel, such as ``git show
<commit>:src/repro_torch/kernels/csrc/hail_reader.cu``, with or without
the ranges scratch argument), each named by its file's stem.  Each is held
bit for bit to the plain version at the reader's timed shapes of
``chip_smoke.py`` phase 8 (16 blocks at Q = 1, full scan and mixed index,
and at Q = 8, mixed; the server's 2 blocks at Q = 8, C = 3; the eager
job's 2 indexed blocks and the adaptive jobs' one lazy block at Q = 1),
then timed in turns (A B C ... C B A, three rounds): the kernels' device
time from the profiler and CUDA events around 20 back-to-back calls.
Prints one JSON line per round and, before the last line, the card's name
and power limit; the last line holds the medians.

With ``--phases`` it first builds the source as it is with a
``%globaltimer`` stamp at each phase of ``reader_kernel_scan`` (thread 0
of every CTA: start, rows and query entries staged, mask computed, end)
and prints, per shape, one launch's CTA start times, the time of each
phase and the CTAs' lifetimes (10th, 50th and 90th percentiles, us).
Needs one card and ``nvcc``; exits 1 without a card.
"""
from __future__ import annotations

import argparse
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
OUT = ROOT / "build" / "reader_variants"
ROWS, PARTS = 1 << 19, 512
ITERS, ROUNDS = 20, 3
# name, blocks, queries, columns, mixed index, ranges (chip_smoke phase 8)
SHAPES = [("full_scan_q1", 16, 1, 2, False, "edges"),
          ("mixed_q1", 16, 1, 2, True, "edges"),
          ("mixed_q8", 16, 8, 2, True, "edges"),
          ("server_q8", 2, 8, 3, True, "server"),
          ("eager_q1", 2, 1, 2, True, "edges"),
          ("adaptive_q1", 1, 1, 2, False, "edges")]


def sub(text, old, new):
    if old not in text:
        raise RuntimeError(f"variant text not found: {old[:60]!r}")
    return text.replace(old, new)


def variants(src: str) -> dict[str, str]:
    tile, threads = ("constexpr int kTileRows = 1024;",
                     "constexpr int kThreads = 256;")
    return {
        "as_built": src,
        "tile512": sub(sub(src, tile, "constexpr int kTileRows = 512;"),
                       threads, "constexpr int kThreads = 128;"),
        "one6": sub(src, "constexpr int kMinBlocksOne = 8;",
                    "constexpr int kMinBlocksOne = 6;"),
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
             "-o", str(OUT / f"lib{name}.so"), str(cu),
             str(CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


STAMPS = r"""
__device__ unsigned long long g_stamps[65536 * 4];
__device__ __forceinline__ void stamp(int k) {
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamps[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 4 + k] = t;
  }
}
"""
STAMPS_COPY = r"""
extern "C" int stamps_copy(void* dst, size_t bytes) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, bytes);
}
"""


def with_stamps(src: str) -> str:
    """The source with a stamp at each phase of ``reader_kernel_scan``:
    0 start, 1 rows and query entries staged, 2 mask computed, 3 end (a
    pruned tile: 3 after its zeros)."""
    src = sub(src, "namespace {\n", "namespace {\n" + STAMPS)
    src = sub(src, "  const int b = blockIdx.y, t = threadIdx.x;\n",
              "  stamp(0);\n  const int b = blockIdx.y, t = threadIdx.x;\n")
    src = sub(src, "  live = __syncthreads_or(live);\n",
              "  live = __syncthreads_or(live);\n  stamp(1);\n")
    src = sub(src, "    __syncthreads();\n    copy_out(mt,",
              "    __syncthreads();\n    stamp(2);\n    copy_out(mt,")
    src = sub(src, "        __syncthreads();\n        copy_out(dst,",
              "        __syncthreads();\n        stamp(2);\n"
              "        copy_out(dst,")
    src = sub(src, "    zero_range(ot, (int64_t)n * n_cols, 4);\n    return;",
              "    zero_range(ot, (int64_t)n * n_cols, 4);\n"
              "    __syncthreads();\n    stamp(3);\n    return;")
    src = sub(src, "    ot[i] = s_any[i / n_cols] ? __ldg(pt + i) : 0;\n  }\n}",
              "    ot[i] = s_any[i / n_cols] ? __ldg(pt + i) : 0;\n  }\n"
              "  __syncthreads();\n  stamp(3);\n}")
    return src + STAMPS_COPY


def phases(lib, cases) -> None:
    """One launch of each case after a warm-up, its CTAs' stamps read back."""
    fn = lib.stamps_copy
    fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    fn.restype = ctypes.c_int
    for shape, run, ctas in cases:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
        buf = np.zeros(ctas * 4, np.uint64)
        if fn(buf.ctypes.data, buf.nbytes):
            raise RuntimeError("stamps_copy failed")
        d = buf.reshape(ctas, 4).astype(np.int64)
        live = d[:, 2] > d[:, 1]

        def pct(a):
            a = a[~np.isnan(a)] if a.dtype.kind == "f" else a
            return [float(np.percentile(a, p)) / 1e3 for p in (10, 50, 90)] \
                if a.size else None
        print(json.dumps({
            "phases": shape, "ctas": ctas, "live_ctas": int(live.sum()),
            "span_us": float(d[:, 3].max() - d[:, 0].min()) / 1e3,
            "start_us": pct(d[:, 0] - d[:, 0].min()),
            "staged_us": pct(d[:, 1] - d[:, 0]),
            "mask_us": pct((d[:, 2] - d[:, 1])[live]),
            "rest_us": pct(np.where(live, d[:, 3] - d[:, 2],
                                    d[:, 3] - d[:, 1])),
            "life_us": pct(d[:, 3] - d[:, 0])}), flush=True)


def reader_call(lib, with_ranges: bool):
    """The variant's entry point behind ``hail_read_batch``'s arguments."""
    fn = lib.hail_read_launch
    fn.argtypes = ([ctypes.c_void_p] * (10 if with_ranges else 9)
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def run(mins, keys, proj, bad, uidx, lohi, ps):
        b, rows = keys.shape
        n_cols, n_q = proj.shape[2], lohi.shape[0]
        mask = torch.empty((b, rows, n_q), dtype=torch.bool, device="cuda")
        out = torch.empty((b, rows, n_cols), dtype=torch.int32, device="cuda")
        frac = torch.empty((b, n_q), dtype=torch.float32, device="cuda")
        ptrs = [t.data_ptr() for t in (mins, keys, proj, bad, uidx, lohi,
                                       mask, out, frac)]
        if with_ranges:
            ptrs.append(torch.empty((b, n_q, 4), dtype=torch.int32,
                                    device="cuda").data_ptr())
        code = fn(*ptrs, b, rows, mins.shape[1], n_cols, n_q, ps,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"reader launch failed: {code}")
        return mask, out, frac
    return run


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--baseline", type=Path, action="append",
                        default=[])
    parser.add_argument("--phases", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("reader_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import ref

    sources = variants((CSRC / "hail_reader.cu").read_text())
    for path in args.baseline:
        sources[path.stem] = path.read_text()
    if args.phases:
        sources["stamped"] = with_stamps(sources["as_built"])
    libs = build(sources)
    rng = np.random.default_rng(0)
    cases, stamped = {}, []
    for shape, b, n_q, n_cols, mix, ranges in SHAPES:
        uidx = (np.arange(b) % 3 != 2) if mix else np.zeros(b, bool)
        inputs = cs.reader_inputs(rng, b, ROWS, PARTS, n_cols, n_q, uidx,
                                  ranges)
        ps = ROWS // PARTS
        want = ref.hail_read_batch(*inputs, partition_size=ps)
        for name, text in sources.items():
            run = reader_call(libs[name], "void* ranges" in text)
            got = run(*inputs, ps)
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"variant {name} differs at {shape}")
            if name == "stamped":
                stamped.append((shape, lambda r=run, x=inputs: r(*x, ps),
                                b * (ROWS // 1024)))
                continue
            cases[f"{shape}/{name}"] = (
                lambda r=run, x=inputs: r(*x, ps),
                cs.reader_bound(inputs, want, ps)[0])
        print(json.dumps({"shape": shape, "blocks": b, "queries": n_q,
                          "cols": n_cols, "bound_ms": cs.reader_bound(
                              inputs, want, ps)}), flush=True)
    if stamped:
        phases(libs["stamped"], stamped)
    names = list(cases)
    times = {k: {"ms": [], "events_ms": []} for k in names}
    clocks = set()
    for rnd in range(ROUNDS):
        order = names if rnd % 2 == 0 else names[::-1]
        row = {}
        for k in order:
            fn, _ = cases[k]
            ms, clock = cs.device_ms(fn, ITERS, "reader_kernel")
            clocks.add(clock)
            events = cs.cuda_ms(fn, ITERS)
            times[k]["ms"].append(ms)
            times[k]["events_ms"].append(events)
            row[k] = [ms, events]
        print(json.dumps({"round": rnd, "ms_events_ms": row}), flush=True)
    print(cs.nvidia_smi(), flush=True)
    print(json.dumps({
        "ms_by": sorted(clocks), "profiler_misses": cs.PROFILER_MISSES,
        "median": {k: {"ms": statistics.median(v["ms"]),
                       "events_ms": statistics.median(v["events_ms"]),
                       "bound_ms": cases[k][1]}
                   for k, v in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
