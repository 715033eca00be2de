"""falcon-mamba-7b [ssm]: 64L d_model=4096, attention-free Mamba1,
d_inner=8192, d_state=16, dt_rank=256, conv4, vocab=65024.
[arXiv:2410.05355]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import LayerCfg, Mamba1Cfg, ModelCfg, StackCfg

D, V = 4096, 65024

_layer = LayerCfg(kind="mamba1",
                  ssm=Mamba1Cfg(d_inner=2 * D, d_state=16, dt_rank=D // 16))

CONFIG = ModelCfg(
    name="falcon-mamba-7b",
    family="ssm",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_layer,), n_groups=64),
    tie_embeddings=True,
)


def reduced() -> ModelCfg:
    l = LayerCfg(kind="mamba1",
                 ssm=Mamba1Cfg(d_inner=128, d_state=8, dt_rank=8, chunk=16))
    return dataclasses.replace(
        CONFIG, name="falcon-mamba-7b-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(l,), n_groups=3))
