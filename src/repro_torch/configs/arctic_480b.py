"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual MLP in parallel (Snowflake Arctic's
dense-MoE hybrid).  long_500k skipped: pure full attention.
[hf:Snowflake/snowflake-arctic-base]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelCfg, StackCfg, moe_layer

D, H, KV, FF, V, E, K = 7168, 56, 8, 4864, 32000, 128, 2

_layer = moe_layer(D, H, KV, FF, n_experts=E, top_k=K, dense_residual_ff=FF)

CONFIG = ModelCfg(
    name="arctic-480b",
    family="moe",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_layer,), n_groups=35),
    tie_embeddings=False,
    skip_shapes=("long_500k",),
)


def reduced() -> ModelCfg:
    # generous capacity: smoke tests assert prefill/decode consistency,
    # which requires drop-free routing
    l = moe_layer(64, 4, 2, 128, n_experts=4, top_k=2, dense_residual_ff=128,
                  capacity_factor=4.0)
    return dataclasses.replace(
        CONFIG, name="arctic-480b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(l,), n_groups=2))
