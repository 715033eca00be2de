"""Does the dry-run traced in the background slow the host-bound serving
path beside it?

    python3 scripts/trace_interference.py [ROUNDS]

Serves llama3.2-1b through its launcher on the card (4 prompts of 512
tokens, 32 generated; random weights), after one warm-up run, in three
settings a round, in turn:

* alone: this process on every host core but the last, no trace;
* pinned: the same, beside ``chip_smoke.py``'s background trace
  (``python -m repro_torch.launch.dryrun --all --mesh both``) on the last
  core at nice 10, as ``chip_smoke.py`` starts it;
* shared: this process on every core, beside the same trace unpinned.

Prints every run's prefill seconds and decode milliseconds a step, then
each setting's medians, and the card's name and power limit.
"""
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.launch import serve  # noqa: E402

GEN = 32
ARGS = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "512",
        "--gen", str(GEN)]


def start_trace(core):
    """The dry-run in the background, on ``core`` at nice 10 (None: any
    core, default priority)."""
    out = tempfile.mkdtemp(prefix="trace_interference_")
    pin = (f"os.sched_setaffinity(0, {{{core}}}); os.nice(10); "
           if core is not None else "")
    child = (f"import os, runpy; {pin}runpy.run_module("
             f"'repro_torch.launch.dryrun', run_name='__main__')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-c", child, "--all", "--mesh", "both", "--force",
         "--out", out], stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT,
        env=env)


def serve_once() -> tuple[float, float]:
    out = serve.main(ARGS)
    return out["prefill_s"], out["decode_s"] / (GEN - 1) * 1e3


def main(rounds: int) -> None:
    cores = sorted(os.sched_getaffinity(0))
    last, rest = cores[-1], cores[:-1] or cores
    serve_once()                                    # build, warm up
    runs = {"alone": [], "pinned": [], "shared": []}
    for _ in range(rounds):
        for setting in runs:
            os.sched_setaffinity(0, cores if setting == "shared" else rest)
            proc = None
            if setting != "alone":
                proc = start_trace(last if setting == "pinned" else None)
                time.sleep(8)                       # past its imports
            try:
                runs[setting].append(serve_once())
            finally:
                if proc is not None:
                    proc.kill()
                    proc.wait()
            print(setting, runs[setting][-1], flush=True)
    for setting, got in runs.items():
        print(f"{setting}: prefill s median "
              f"{statistics.median(p for p, _ in got)!r}, decode ms a step "
              f"median {statistics.median(d for _, d in got)!r}; runs "
              f"{got!r}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout,
        flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
