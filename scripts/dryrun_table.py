"""Print PERF.md's dry-run table from the records of
``python -m repro_torch.launch.dryrun --all`` (artifacts/dryrun_torch/).

Per arch: train_4k's counted FLOPs (the whole step), model FLOPs and their
share of the counted, one device's argument + temp GB on the (16, 16)
mesh, its dominant term and lower bound (the (2, 16, 16) mesh's in
parentheses); prefill_32k's bound and model / counted FLOPs; decode_32k's
dominant term, bound and GB read a device.

  PYTHONPATH=src python scripts/dryrun_table.py [DIR]
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma3-4b", "h2o-danube-1.8b", "llama3.2-1b", "gemma3-12b",
         "falcon-mamba-7b", "arctic-480b", "mixtral-8x22b", "zamba2-2.7b",
         "whisper-medium", "qwen2-vl-72b")


def load(d: Path, arch: str, shape: str, mesh: str) -> dict:
    rec = json.loads((d / f"{arch}__{shape}__{mesh}.json").read_text())
    if "error" in rec:
        raise SystemExit(f"{arch} {shape} {mesh}: {rec['error']}")
    return rec


def main(argv) -> int:
    d = Path(argv[0]) if argv else ROOT / "artifacts" / "dryrun_torch"
    print("| Arch | Counted FLOPs | Model FLOPs (/ counted) | GB a device "
          "| Dominant, bound s (2 × 16 × 16) | prefill_32k bound s "
          "(model / counted) | decode_32k bound s, GB read a device |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for arch in ARCHS:
        tr = load(d, arch, "train_4k", "single")
        trm = load(d, arch, "train_4k", "multi")
        pf = load(d, arch, "prefill_32k", "single")
        dc = load(d, arch, "decode_32k", "single")
        counted = tr["traced"]["flops"]
        mem = tr["memory"]
        gb = (mem["argument_bytes"] + mem["temp_bytes"]) / 1e9
        r = tr["roofline"]
        print(f"| {arch} | {counted:.4e} | {tr['model_flops']:.4e} "
              f"({tr['model_flops'] / counted:.3f}) | {gb:.2f} | "
              f"{r['dominant']} {r['step_lower_bound_s']:.4f} "
              f"({trm['roofline']['step_lower_bound_s']:.4f}) | "
              f"{pf['roofline']['dominant']} "
              f"{pf['roofline']['step_lower_bound_s']:.4f} "
              f"({pf['model_over_hlo_flops']:.3f}) | "
              f"{dc['roofline']['dominant']} "
              f"{dc['roofline']['step_lower_bound_s']:.5f}, "
              f"{dc['hlo']['hbm_bytes'] / 1e9:.2f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
