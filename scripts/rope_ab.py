"""RoPE's frequency ladder three ways, side by side in one process on the
card: what each costs the host-bound serving path.

    python3 scripts/rope_ab.py [ROUNDS] [OUT.json]

``models.common._freqs`` is swapped for each variant in turn:

* ``float32_pow``: the ladder as a float32 ``pow`` on the device (the
  port before the full-width repair; an ulp off for some exponents);
* ``host_copy``: the float64 ladder built on the host and copied to the
  device with ``.to(device)``, a blocking copy from pageable memory;
* ``on_device``: the float64 ladder built on the device (the port's
  ``_freqs``).

For each variant: the synchronizing calls one ladder makes (counted by
``torch.cuda.set_sync_debug_mode``), its host time a call (1,000 calls,
one synchronize), its host time a call behind 20 queued bf16 products of
8,192 x 8,192 (what a device-bound step sees), and llama3.2-1b served
through its launcher (4 prompts of 512 tokens, 32 generated, random
weights) ROUNDS times, the variants in a rotating order each round,
after one warm-up run each.  Prints each
run, each variant's medians, and the card's name and power limit, and
writes them to OUT.json (default ``chiprun_out/rope_ab.json``).
"""
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import common  # noqa: E402

GEN = 32
ARGS = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "512",
        "--gen", str(GEN)]


def float32_pow(start, stop, half, theta, device):
    return theta ** (-torch.arange(start, stop, dtype=torch.float32,
                                   device=device) / half)


def host_copy(start, stop, half, theta, device):
    e = -torch.arange(start, stop, dtype=torch.float32) / half
    return (theta ** e.double()).float().to(device)


VARIANTS = {"float32_pow": float32_pow, "host_copy": host_copy,
            "on_device": common._freqs}


def syncs(fn) -> int:
    """Synchronizing calls one ladder makes on the card (after one call
    not counted, which may set up the process's first CUDA work)."""
    fn(0, 32, 32, 5e5, "cuda")
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(0, 32, 32, 5e5, "cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def call_us(fn, n: int = 1000) -> float:
    fn(0, 32, 32, 5e5, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn(0, 32, 32, 5e5, "cuda")
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def behind_queue_us(fn, rounds: int = 5) -> float:
    """Host time of one ladder call made right after 20 products of
    8,192 x 8,192 were queued on the card (median of ``rounds``)."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    got = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        for _ in range(20):
            a @ a
        t0 = time.perf_counter()
        fn(0, 32, 32, 5e5, "cuda")
        got.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return statistics.median(got)


def serve_once() -> tuple[float, float]:
    out = serve.main(ARGS)
    return out["prefill_s"], out["decode_s"] / (GEN - 1) * 1e3


def main(rounds: int, out_path: Path) -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    names = list(VARIANTS)
    rec = {"card": card.strip(), "rounds": rounds, "syncs_a_call": {},
           "us_a_call": {}, "us_behind_queue": {}, "runs": []}
    for name in names:
        rec["syncs_a_call"][name] = syncs(VARIANTS[name])
        rec["us_a_call"][name] = call_us(VARIANTS[name])
        rec["us_behind_queue"][name] = behind_queue_us(VARIANTS[name])
    for name in names:                                  # build, warm up
        common._freqs = VARIANTS[name]
        serve_once()
    for r in range(rounds):
        for name in names[r % 3:] + names[:r % 3]:
            common._freqs = VARIANTS[name]
            prefill_s, decode_ms = serve_once()
            rec["runs"].append({"round": r, "variant": name,
                                "prefill_s": prefill_s,
                                "decode_ms": decode_ms})
            print(json.dumps(rec["runs"][-1]), flush=True)
    common._freqs = VARIANTS["on_device"]
    rec["median"] = {
        name: {k: statistics.median(x[k] for x in rec["runs"]
                                    if x["variant"] == name)
               for k in ("prefill_s", "decode_ms")} for name in names}
    print(json.dumps({k: rec[k] for k in ("syncs_a_call", "us_a_call",
                                          "us_behind_queue", "median")}))
    print(rec["card"])
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
         Path(sys.argv[2]) if len(sys.argv) > 2
         else ROOT / "chiprun_out" / "rope_ab.json")
