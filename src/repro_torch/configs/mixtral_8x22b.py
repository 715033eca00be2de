"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelCfg, StackCfg, moe_layer

D, H, KV, FF, V, E, K, W = 6144, 48, 8, 16384, 32768, 8, 2, 4096

_layer = moe_layer(D, H, KV, FF, n_experts=E, top_k=K, window=W)

CONFIG = ModelCfg(
    name="mixtral-8x22b",
    family="moe",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_layer,), n_groups=56),
    tie_embeddings=False,
)


def reduced() -> ModelCfg:
    l = moe_layer(64, 4, 2, 128, n_experts=4, top_k=2, window=8,
                  capacity_factor=4.0)
    return dataclasses.replace(
        CONFIG, name="mixtral-8x22b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(l,), n_groups=2))
