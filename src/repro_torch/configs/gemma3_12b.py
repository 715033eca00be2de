"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
5:1 local(SWA-1024):global, head_dim=256, qk-norm. [hf:google/gemma-3-*-pt]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelCfg, StackCfg, dense_layer

D, H, KV, FF, V, HD, W = 3840, 16, 8, 15360, 262144, 256, 1024

_local = dense_layer(D, H, KV, FF, head_dim=HD, window=W,
                     rope_theta=10_000.0, qk_norm=True)
_global = dense_layer(D, H, KV, FF, head_dim=HD, window=None,
                      rope_theta=1_000_000.0, qk_norm=True)

# 48 layers = 8 x (5 local + 1 global)
CONFIG = ModelCfg(
    name="gemma3-12b",
    family="dense",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_local,) * 5 + (_global,), n_groups=8),
    tie_embeddings=True,
    embed_scale=True,
)


def reduced() -> ModelCfg:
    lo = dense_layer(64, 4, 2, 128, head_dim=16, window=8, qk_norm=True)
    gl = dense_layer(64, 4, 2, 128, head_dim=16, window=None, qk_norm=True)
    return dataclasses.replace(
        CONFIG, name="gemma3-12b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(lo, lo, gl), n_groups=2))
