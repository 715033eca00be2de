"""Phase 7's serving walls and phase 9's step times of two ``chip_smoke.py``
runs side by side.

    python3 scripts/compare_walls.py BEFORE.log AFTER.log

Each log is a run's standard output (one JSON object a line).  Prints, for
every served model, the prefill's seconds and the decode's milliseconds a
step, and for every trained one the median of its timed steps, with the
ratio after / before.
"""
import json
import statistics
import sys


def records(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith('{"phase"'):
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    pass
    return out


def walls(path: str) -> dict[str, float]:
    got = {}
    for rec in records(path):
        if rec["phase"] == "serve":
            got[f"{rec['arch']} prefill s"] = rec["prefill_s"]
            got[f"{rec['arch']} decode ms a step"] = rec["decode_ms_per_step"]
        elif rec["phase"] == "train":
            for name, run in rec.items():
                if isinstance(run, dict) and "step_s" in run:
                    steps = run["step_s"]
                    got[f"{name} step s (median)"] = (
                        statistics.median(steps) if isinstance(steps, list)
                        else steps)
    return got


def main(before: str, after: str) -> None:
    a, b = walls(before), walls(after)
    for name in a:
        if name in b:
            print(f"{name}: {a[name]!r} -> {b[name]!r} "
                  f"({b[name] / a[name]:.3f})")


if __name__ == "__main__":
    main(*sys.argv[1:3])
