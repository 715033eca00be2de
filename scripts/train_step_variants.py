"""How the train step takes each layer's parameters from the group-stacked
leaves: two ways side by side on one CUDA card.

    python3 scripts/train_step_variants.py [--arch llama3.2-1b] [--rounds 3]
        [--groups N]

Runs the port's train step (``train.step.make_train_step``, remat "none",
bf16 compute, float32 parameters and AdamW state) of the model at full
width and depth (``--groups`` cuts the depth: falcon-mamba-7b's state
fits the card at 8 of its 64 groups) on one repeated batch of 4 x 512
numpy tokens, in turns (A B B A a round), with each way of taking a
layer's view of a stacked leaf:

* ``unbind``  the port's: one ``torch.unbind`` a leaf (``stack._unbind``),
  whose backward stacks the groups' gradients once;
* ``index``   a view ``leaf[g]`` per layer, whose backward scatters each
  layer's gradient into a zero tensor of the whole leaf, n_groups times.

Each turn times 3 steps after one warm-up step (host clock, ending in a
synchronise) and checks that the two ways give the same losses.  Prints
one JSON line per turn and, before the last line, the card's name and
power limit; the last line is the median step wall of each way.  Needs
one card and ``nvcc``; exits 1 without a card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
B, T, STEPS = 4, 512, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--groups", type=int, default=0,
                    help="layer groups to keep (0: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import stack
    from repro_torch.train.optimizer import OptCfg
    from repro_torch.train.step import (StepCfg, init_train_state,
                                        make_train_step)

    def by_index(tree, n):
        return [stack._index(tree, g) for g in range(n)]

    ways = {"unbind": stack._unbind, "index": by_index}
    cfg = get_config(args.arch)
    if args.groups:
        cfg = dataclasses.replace(cfg, stack=dataclasses.replace(
            cfg.stack, n_groups=args.groups))
    opt = OptCfg(lr=1e-3, warmup_steps=1, total_steps=100)
    step = make_train_step(cfg, opt, StepCfg(remat="none"))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, T + 1)).astype(np.int32)).cuda()
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}

    walls: dict[str, list] = {w: [] for w in ways}
    losses: dict[str, list] = {}
    for r in range(args.rounds):
        for name in (["unbind", "index", "index", "unbind"] if r % 2 == 0
                     else ["index", "unbind", "unbind", "index"]):
            stack._unbind = ways[name]
            try:
                gen = torch.Generator(device="cuda").manual_seed(0)
                state = init_train_state(cfg, opt, gen, "cuda")
                state, m = step(state, batch)                 # warm-up
                run_losses = [float(m["loss"])]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(STEPS):
                    state, m = step(state, batch)
                    run_losses.append(float(m["loss"]))
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / STEPS
            finally:
                stack._unbind = ways["unbind"]
            del state, m
            torch.cuda.empty_cache()
            walls[name].append(wall)
            losses.setdefault(name, run_losses)
            print(json.dumps({"round": r, "way": name, "step_s": wall,
                              "losses": run_losses}), flush=True)
    if losses["unbind"] != losses["index"]:
        print(f"losses differ: {losses}", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"arch": args.arch, "layers": cfg.n_layers,
                      "batch": [B, T],
                      "median_step_s": {w: statistics.median(v)
                                        for w, v in walls.items()},
                      "walls": walls}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
