"""qwen2-vl-72b [vlm]: 80L d_model=8192 64H (GQA kv=8) of head dim 128,
d_ff=29568 vocab=152064, rope theta 1e6, M-RoPE (t/h/w sections 16/24/24
of head_dim/2 = 64).  The vision frontend is a stub, as in the JAX
package: train and prefill take precomputed patch embeddings
(embed_inputs=False); decode embeds generated text tokens through the
table.  Untied embeddings.  long_500k skipped: pure full attention.
[arXiv:2409.12191]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelCfg, StackCfg, dense_layer

D, H, KV, FF, V = 8192, 64, 8, 29568, 152064

_layer = dense_layer(D, H, KV, FF, rope_theta=1_000_000.0, mrope=(16, 24, 24))

CONFIG = ModelCfg(
    name="qwen2-vl-72b",
    family="vlm",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_layer,), n_groups=80),
    tie_embeddings=False,
    embed_inputs=False,
    skip_shapes=("long_500k",),
)


def reduced() -> ModelCfg:
    l = dense_layer(64, 4, 2, 128, head_dim=16, mrope=(2, 3, 3))
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-72b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(l,), n_groups=3))
