"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --reduced --device cpu --steps 50 --batch 8 --seq 128 \\
      --ckpt-dir /tmp/ckpt

The port of the JAX package's ``launch/train.py``: the train step over a
host mesh (``make_host_mesh``; the production mesh waits for the dry-runs),
optional HAIL-selected training data (``--hail-select col:lo:hi``, through
the port's ``data.pipeline``), asynchronous checksummed checkpoints every
``--ckpt-every`` steps, and resume from the latest good checkpoint in
``--ckpt-dir``.  ``--device`` defaults to ``cuda``: it runs on the card
unless asked for the CPU, and raises where there is no card.

Parameters are float32 from a ``torch.Generator`` seeded with ``--seed``.
Random batches (without ``--hail-select``) come from a ``torch.Generator``
seeded per step from (``--seed``, step), so a resumed run sees the batches
an uninterrupted one would; their numbers differ from ``jax.random``'s, so
a run does not reproduce the JAX launcher's batches.  The batches are
tokens only, as the JAX launcher's: a model that takes encoder inputs or
embeddings (whisper, qwen2-vl) is refused before any step, where the JAX
launcher fails inside its first.
"""
from __future__ import annotations

import argparse
import gc
import time

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train.optimizer import OptCfg
from repro_torch.train.step import (StepCfg, init_train_state,
                                    make_train_step, train_state_specs)


def _batches(args, cfg, device):
    """step -> {"tokens", "labels"} (B, seq) int32 on ``device``."""
    if args.hail_select:
        from repro_torch.data.pipeline import (CorpusConfig, HailDataSource,
                                               build_corpus)
        col, lo, hi = args.hail_select.split(":")
        ccfg = CorpusConfig(n_docs=max(2048, args.batch * 64),
                            seq_width=args.seq + 1, rows_per_block=256,
                            partition_size=64, vocab=cfg.vocab)
        store, _ = build_corpus(ccfg, seed=args.seed, device=device)
        src = iter(HailDataSource(store, ccfg, select=(col, int(lo), int(hi)),
                                  batch_size=args.batch, seed=args.seed))
        return lambda i: next(src)

    def get_batch(i):
        seed = int(np.random.SeedSequence([args.seed, i]).generate_state(1)[0])
        gen = torch.Generator(device=device).manual_seed(seed)
        tok = torch.randint(0, cfg.vocab, (args.batch, args.seq + 1),
                            generator=gen, device=device, dtype=torch.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    return get_batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none", choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--hail-select", default="",
                    help="col:lo:hi training-data selection via HAIL index")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device (pass --device cpu to run "
                           "on the CPU)")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if cfg.encoder is not None or not cfg.embed_inputs:
        raise ValueError(f"train: {cfg.name} takes encoder inputs or "
                         f"embeddings, and this launcher's batches are "
                         f"tokens only (as the JAX launcher's); train it "
                         f"through train.step.make_train_step with a batch "
                         f"that holds them")
    mesh = make_host_mesh(device)
    print(f"arch={cfg.name} device={device} mesh={mesh.shape}")

    opt = OptCfg(lr=args.lr, warmup_steps=min(20, args.steps // 4),
                 total_steps=args.steps)
    step_cfg = StepCfg(remat=args.remat)
    specs = train_state_specs(cfg, opt)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = init_train_state(cfg, opt, gen, device)
    if args.ckpt_dir:
        restored, step0 = ck.restore_latest(args.ckpt_dir, state, specs=specs,
                                            mesh=mesh)
        if restored is not None:
            state = restored
            print(f"resumed from step {step0}")

    step_fn = make_train_step(cfg, opt, step_cfg, mesh)
    get_batch = _batches(args, cfg, device)
    saver = ck.AsyncSaver()
    losses: dict[int, float] = {}
    start = int(state["step"])
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        state, metrics = step_fn(state, get_batch(i))
        if i == start:
            # the first checkpoint call (remat, the chunked loss) of a
            # process imports torch._dynamo, and that import keeps the
            # step's frames, old state and gradients included, alive until
            # a collection
            gc.collect()
        losses[i + 1] = float(metrics["loss"])
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            toks = args.batch * args.seq * (i + 1 - start)
            print(f"step {i + 1:5d} loss={losses[i + 1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"tok/s={toks / (time.perf_counter() - t0):.0f}",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            saver.save(state, args.ckpt_dir, i + 1)
    saver.wait()
    print("done")
    return {"arch": cfg.name, "start": start, "losses": losses,
            "state": state}


if __name__ == "__main__":
    main()
