"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) of head dim 80,
d_ff=6912 vocab=32000 — llama+mistral mix with sliding-window attention
(4096): a prompt longer than the window leaves a ring cache of its last
4096 positions.  Untied embeddings.  [arXiv:2401.16818]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelCfg, StackCfg, dense_layer

D, H, KV, FF, V, W = 2560, 32, 8, 6912, 32000, 4096

_layer = dense_layer(D, H, KV, FF, window=W)

CONFIG = ModelCfg(
    name="h2o-danube-1.8b",
    family="dense",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_layer,), n_groups=24),
    tie_embeddings=False,
)


def reduced() -> ModelCfg:
    l = dense_layer(64, 4, 2, 128, head_dim=16, window=8)
    return dataclasses.replace(
        CONFIG, name="h2o-danube-1.8b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(l,), n_groups=3))
