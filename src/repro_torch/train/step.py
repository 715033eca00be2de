"""Step builders for serving: prefill_step / decode_step.

The serving part of the JAX package's ``train/step.py``; the train step,
losses and optimizer come with the training slice.  PyTorch runs eagerly,
so a step is a plain function under ``torch.no_grad()`` (the JAX package
jits it).  The decode step writes the cache in place and returns it, where
the JAX package donates the cache to the jitted step.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelCfg
from repro_torch.models.model import decode_positions, forward


@dataclasses.dataclass(frozen=True)
class StepCfg:
    """Step options.  The JAX package's (remat, loss, loss chunks) shape
    only the train step and come with it; serving has none: decode always
    updates the cache in place."""


def make_prefill_step(cfg: ModelCfg, step_cfg: StepCfg = StepCfg(),
                      max_len: int | None = None):
    """max_len: KV-cache capacity for subsequent decode steps (defaults to
    the prompt length — pass prompt+generation budget when serving)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            logits, cache = forward(params, cfg, batch["tokens"],
                                    mode="prefill", cache_len=max_len)
            return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelCfg, step_cfg: StepCfg = StepCfg()):
    def decode_step(params, cache, batch):
        with torch.no_grad():
            tokens = batch["tokens"][:, None]                 # (B,1)
            pos = decode_positions(batch["pos"], tokens.shape[0],
                                   tokens.device)
            logits, cache = forward(params, cfg, tokens, mode="decode",
                                    cache=cache, positions=pos)
            return logits[:, 0], cache

    return decode_step
