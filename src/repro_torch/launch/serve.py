"""Serving launcher: batched prefill + greedy (or sampled) decode loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16

The port of the JAX package's ``launch/serve.py``, with ``--device``
(default ``cuda``: it runs on the card unless asked for the CPU, and never
falls back) and ``--seed`` (parameters from a seeded ``torch.Generator`` on
the device, prompt tokens from numpy).  Parameters are bfloat16, as in the
JAX launcher.  The batch is the JAX launcher's: prompt tokens, or
embeddings for a model fed by a stub frontend (qwen2-vl's patch
embeddings, (B, T, D); its decode steps embed the generated tokens), and
for an encoder-decoder (whisper) also ``prompt_len`` frame embeddings for
the encoder, normal draws from numpy in bfloat16.  A sliding-window model
(h2o-danube) whose prompt and generation outrun the window decodes
through ring caches of the window's length.  The mesh is the JAX
launcher's: the production mesh over the first 256 cards where there are
that many (the parameters placed on it, ``dist.sharding.place``, and the
steps sharded), else the host mesh of one device.  Prints the prefill and
decode walls and tokens per second.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.dist.sharding import init_params, place
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models.model import model_specs
from repro_torch.train.step import (is_sharded_mesh, make_decode_step,
                                    make_prefill_step)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve: no CUDA device (pass --device cpu to run "
                           "on the CPU)")
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = (make_production_mesh(devices=[torch.device("cuda", i)
                                          for i in range(256)])
            if n_dev >= 256 else make_host_mesh(device))
    max_len = args.prompt_len + args.gen
    prefill = make_prefill_step(cfg, mesh=mesh, max_len=max_len)
    decode = make_decode_step(cfg, mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(model_specs(cfg), gen, device, dtype=torch.bfloat16)
    if is_sharded_mesh(mesh):
        params = place(params, model_specs(cfg), mesh)

    rng = np.random.default_rng(args.seed + 1)
    shape = (args.batch, args.prompt_len)

    def normal():
        return torch.from_numpy(rng.standard_normal(
            (*shape, cfg.d_model), dtype=np.float32)).to(
                device=device, dtype=torch.bfloat16)

    batch = {}
    if cfg.embed_inputs:
        batch["tokens"] = torch.from_numpy(rng.integers(
            0, cfg.vocab, shape)).to(device)
    else:
        batch["inputs"] = normal()
    if cfg.encoder is not None:
        batch.setdefault("tokens", torch.from_numpy(rng.integers(
            0, cfg.vocab, shape)).to(device))
        batch["enc_inputs"] = normal()

    def sample(lg):
        if args.temperature <= 0:
            return torch.argmax(lg, -1)
        probs = torch.softmax(lg / args.temperature, -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    tok = sample(logits)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    toks = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        logits, cache = decode(params, cache,
                               {"tokens": tok, "pos": args.prompt_len + i})
        tok = sample(logits)
        toks.append(tok)
    _sync(device)
    t_decode = time.perf_counter() - t0

    n_prefill = args.batch * args.prompt_len
    n_decode = args.batch * (args.gen - 1)
    out = {"arch": cfg.name, "batch": args.batch, "device": str(device),
           "mesh": mesh.shape,
           "prefill_s": t_prefill,
           "prefill_tok_s": n_prefill / max(t_prefill, 1e-9),
           "decode_s": t_decode,
           "decode_tok_s": n_decode / max(t_decode, 1e-9),
           "tokens": torch.stack(toks, 1).cpu().numpy()}
    print(f"arch={cfg.name} batch={args.batch} device={device} "
          f"mesh={n_dev if is_sharded_mesh(mesh) else 1}dev")
    print(f"prefill: {t_prefill * 1e3:.0f} ms "
          f"({out['prefill_tok_s']:.0f} tok/s)")
    print(f"decode:  {t_decode * 1e3:.0f} ms "
          f"({out['decode_tok_s']:.1f} tok/s)")
    return out


if __name__ == "__main__":
    main()
