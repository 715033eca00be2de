"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256, full attention, rope theta 500k, tied embeddings.
long_500k skipped: pure full attention. [hf:meta-llama]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelCfg, StackCfg, dense_layer

D, H, KV, FF, V = 2048, 32, 8, 8192, 128256

_layer = dense_layer(D, H, KV, FF, rope_theta=500_000.0)

CONFIG = ModelCfg(
    name="llama3.2-1b",
    family="dense",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_layer,), n_groups=16),
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)


def reduced() -> ModelCfg:
    l = dense_layer(64, 4, 2, 128, head_dim=16)
    return dataclasses.replace(
        CONFIG, name="llama3.2-1b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(l,), n_groups=3))
