"""Mixtral-8x22b's MoE layer in bf16 compute at several seeds, and its
one-layer training state's memory: the readings behind the bf16 layer
check's expert rule and the optimizer's one update path.

    python3 scripts/moe_layer_witness.py [--seeds 4 44] [--repeats 2]
        [--no-train]

For each seed (added to ``chip_smoke.SEED``), ``repeats`` times, runs
``chip_smoke.layer_grad_check_bf16`` on one mixtral layer at full width
on 1 x 6,144 tokens (past its window of 4,096): every gradient on the
kernel route, on the plain route and on the two witnesses (the plain
route with its attention output moved by the flash forward's own
difference, mirrored or rolled) as a share of the gradient's scale from
float32 compute, and the control fed the bf16 O.  The checks are
recorded, not raised, so a failing seed still reports its numbers.
Then, unless ``--no-train``, ``chip_smoke.train_run`` trains mixtral at
full width on 1 of its 56 layers on 1 x 8,192 tokens with bf16 AdamW
moments, as ``chip_smoke.py`` does, and reports its peak memory (or the
out-of-memory error).  Prints one JSON line per run, the card's name and
power limit, and a summary as the last line; writes everything to
``chiprun_out/moe_layer_witness.json``.  Needs one card and ``nvcc``;
exits 1 without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=[4, 44])
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--no-train", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("moe_layer_witness: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.train.optimizer import OptCfg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    out = {"build_s": time.perf_counter() - t0, "layers": []}
    failures: list = []
    cs.check = lambda ok, what: None if ok else failures.append(what)

    for seed in args.seeds:
        for rep in range(args.repeats):
            del failures[:]
            t0 = time.perf_counter()
            rec = cs.layer_grad_check_bf16(cs.MIXTRAL, cs.MIXTRAL_LAYER_SEQ,
                                           1, seed=cs.SEED + seed)
            row = {"seed": cs.SEED + seed, "repeat": rep,
                   "seconds": time.perf_counter() - t0,
                   "failed_checks": list(failures),
                   "attention_share": rec["attention_calls"][0][
                       "share_of_scale"],
                   "layer_vs_f32": rec["layer_vs_f32"],
                   "witness_moved_share": {
                       m: w["moved_share"]
                       for m, w in rec["witnesses"].items()},
                   "witness_vs_f32": {m: w["expert_vs_f32"]
                                      for m, w in rec["witnesses"].items()},
                   "control_bf16_o": rec["control_bf16_o"]}
            out["layers"].append(row)
            print(json.dumps(row), flush=True)

    if not args.no_train:
        mixtral = get_config(cs.MIXTRAL)
        one = dataclasses.replace(mixtral, stack=dataclasses.replace(
            mixtral.stack, n_groups=1))
        tok = torch.from_numpy(np.random.default_rng(cs.SEED).integers(
            0, mixtral.vocab, (1, cs.MIXTRAL_TRAIN_SEQ + 1)).astype(
                np.int32)).cuda()
        opt = OptCfg(lr=cs.TRAIN_LR, warmup_steps=1, total_steps=100,
                     state_dtype=torch.bfloat16)
        try:
            run = cs.train_run(one, {"tokens": tok[:, :-1].contiguous(),
                                     "labels": tok[:, 1:].contiguous()},
                               cs.MOE_TRAIN_STEPS - 1, "flash_attention",
                               opt, finite_grads=True,
                               specs=cs.cut_specs(mixtral, 1))
            out["train"] = {k: run[k] for k in (
                "params", "state_bytes", "step_s", "losses",
                "peak_mem_bytes", "finite_grad_leaves")}
        except torch.OutOfMemoryError as e:
            out["train"] = {"out_of_memory": str(e)[:600],
                            "peak_mem_bytes":
                            torch.cuda.max_memory_allocated()}
        out["train"]["failed_checks"] = list(failures)
        print(json.dumps(out["train"]), flush=True)

    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "moe_layer_witness.json").write_text(
        json.dumps(out, indent=1))
    print(cs.nvidia_smi())
    print(json.dumps({"expert_excess_over_sound": [
        max(v["kernel"] - v.get("sound", v["plain"])
            for k, v in r["layer_vs_f32"].items() if k.startswith("ffn/w_"))
        for r in out["layers"]],
        "train_peak_gb": out.get("train", {}).get("peak_mem_bytes", 0) / 1e9}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
