"""zamba2-2.7b [hybrid]: 54L d_model=2560, Mamba2 backbone (ssm_state=64) +
shared-weight attention blocks (32H, kv=32 i.e. MHA) interleaved 5:1.
54 = 9 x (5 mamba2 + 1 shared attn block).  [arXiv:2411.15242]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AttnCfg, LayerCfg, Mamba2Cfg,
                                      MlpCfg, ModelCfg, StackCfg)

D, V = 2560, 32000

_mamba = LayerCfg(kind="mamba2",
                  ssm=Mamba2Cfg(d_inner=2 * D, d_state=64, head_dim=64))
_shared_impl = LayerCfg(
    kind="attn_mlp",
    attn=AttnCfg(n_heads=32, n_kv=32, head_dim=80),
    mlp=MlpCfg(d_ff=10240),
)
_shared_slot = LayerCfg(kind="shared")

CONFIG = ModelCfg(
    name="zamba2-2.7b",
    family="hybrid",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_mamba,) * 5 + (_shared_slot,), n_groups=9,
                   shared=_shared_impl),
    tie_embeddings=True,
)


def reduced() -> ModelCfg:
    m = LayerCfg(kind="mamba2",
                 ssm=Mamba2Cfg(d_inner=128, d_state=16, head_dim=16, chunk=16))
    sh = LayerCfg(kind="attn_mlp",
                  attn=AttnCfg(n_heads=4, n_kv=4, head_dim=16),
                  mlp=MlpCfg(d_ff=128))
    return dataclasses.replace(
        CONFIG, name="zamba2-2.7b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(m, m, LayerCfg(kind="shared")), n_groups=2,
                       shared=sh))
