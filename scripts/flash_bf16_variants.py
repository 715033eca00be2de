"""What holds the bf16 flash kernel back: variants of it side by side on
one CUDA card.

    python3 scripts/flash_bf16_variants.py

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` as it is and
three variants made from it by exact text substitutions, each into its own
library under ``build/flash_variants/``, and times them at the llama3.2-1b
prefill shape (q (4,512,32,64), k/v (4,512,8,64), bf16, causal) with CUDA
events around 100 raw launches, in turns (A B C D D C B A, three rounds),
beside ``scaled_dot_product_attention``:

* ``as_built``   the kernel as the port runs it;
* ``3_ctas``     without the 128-register cap (3 CTAs an SM, not 4);
* ``exp2f``      with ``exp2f`` in place of one ``ex2.approx``;
* ``no_prefetch`` without the K/V tile loads in the loop (its results are
  wrong: it times everything but those loads).

With ``--baseline OLD.cu`` (repeatable) it also builds and times other
sources of the same entry point as they are (earlier versions, e.g.
from ``git show``; those from before the softcap argument are called
without it), under their file names.

The first three and the baselines are held to the plain version within
2e-2.  Prints one
JSON line per round and, before the last line, the card's name and power
limit; the last line is the median time of each variant.  Needs one card
and ``nvcc``; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "flash_variants"
B, T, H, KV, D = 4, 512, 32, 8, 64
ITERS = 100
TOL = 2e-2                       # FLASH_TOL[bfloat16] in chip_smoke.py

LOADS = ("      load_tile<D, TK>(s_k[buf ^ 1], kb, k0 + TK, s_len, kv_row);\n"
         "      load_tile<D, TK>(s_v[buf ^ 1], vb, k0 + TK, s_len, kv_row);\n")


def variants(src: str) -> dict[str, str]:
    def sub(text, old, new, count=1):
        if text.count(old) < count:
            raise RuntimeError(f"variant text not found: {old[:60]!r}")
        return text.replace(old, new)

    body = src.index("flash_bf16_kernel(")
    return {
        "as_built": src,
        "3_ctas": sub(src, "__launch_bounds__(kThreads, kFwdCtas<D>)",
                      "__launch_bounds__(kThreads)"),
        "exp2f": src[:body] + sub(src[body:], "fast_exp2(", "exp2f(", 2),
        "no_prefetch": sub(src, LOADS, ""),
    }


def has_softcap(src: str) -> bool:
    """Whether a source's ``flash_attention_launch`` takes a softcap."""
    entry = re.search(r"flash_attention_launch\((.*?)\)", src, re.S)
    return entry is not None and "float softcap" in entry[1]


def build(sources: dict[str, str]) -> dict[str, ctypes._CFuncPtr]:
    """One library a variant, built with the port's nvcc flags, all nvcc
    processes started together."""
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC),
             "-o", str(OUT / f"lib{name}.so"), str(cu),
             str(CSRC / "errors.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).flash_attention_launch
        n_float = 2 if has_softcap(sources[name]) else 1
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def events_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / ITERS


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bf16_variants: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", action="append", default=[])
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref

    sources = variants((CSRC / "flash_attention.cu").read_text())
    for path in map(Path, args.baseline):
        sources[path.stem] = path.read_text()
    caps = {name: has_softcap(text) for name, text in sources.items()}
    fns = build(sources)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g, device="cuda")
               .to(torch.bfloat16)
               for shape in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D)))
    out = torch.empty_like(q)
    want = ref.attention(q, k, v, causal=True)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(name):
        code = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), B, T, T, H, KV, D, 1, -1, 1,
                         D ** -0.5, *((0.0,) if caps[name] else ()), stream)
        if code:
            raise RuntimeError(f"{name}: launch failed ({code})")

    errors = {}
    for name in fns:
        launch(name)
        torch.cuda.synchronize()
        errors[name] = float((out.float() - want.float()).abs().max())
        if name != "no_prefetch" and not errors[name] <= TOL:
            raise RuntimeError(f"{name}: {errors[name]} > {TOL}")
    print(json.dumps({"max_abs_err": errors}), flush=True)

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    order = list(fns) + list(fns)[::-1]
    times: dict[str, list[float]] = {n: [] for n in [*fns, "sdpa"]}
    for rnd in range(3):
        row = []
        for name in order:
            ms = events_ms(lambda: launch(name))
            times[name].append(ms)
            row.append([name, ms])
        ms = events_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        times["sdpa"].append(ms)
        row.append(["sdpa", ms])
        print(json.dumps({"round": rnd, "ms": row}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({"median_ms": {n: statistics.median(t)
                                    for n, t in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
