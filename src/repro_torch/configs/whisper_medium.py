"""whisper-medium [audio]: enc-dec, 24L encoder + 24L decoder, d_model=1024
16H (kv=16, MHA) d_ff=4096 vocab=51865, plain-GeLU MLPs.  The conv audio
frontend is a stub, as in the JAX package: the encoder takes precomputed
frame embeddings (B, S, D); the transformer backbone is fully real.
long_500k skipped: pure full attention + enc-dec.  [arXiv:2212.04356]"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AttnCfg, LayerCfg, MlpCfg, ModelCfg,
                                      StackCfg)

D, H, KV, FF, V = 1024, 16, 16, 4096, 51865


def _enc_layer(d, h, kv, ff, hd=None):
    return LayerCfg(kind="attn_mlp",
                    attn=AttnCfg(n_heads=h, n_kv=kv, head_dim=hd or d // h,
                                 causal=False),
                    mlp=MlpCfg(d_ff=ff, gated=False))


def _dec_layer(d, h, kv, ff, hd=None):
    return LayerCfg(kind="attn_mlp",
                    attn=AttnCfg(n_heads=h, n_kv=kv, head_dim=hd or d // h,
                                 cross=True),
                    mlp=MlpCfg(d_ff=ff, gated=False))


CONFIG = ModelCfg(
    name="whisper-medium",
    family="audio",
    d_model=D,
    vocab=V,
    stack=StackCfg(pattern=(_dec_layer(D, H, KV, FF),), n_groups=24),
    encoder=StackCfg(pattern=(_enc_layer(D, H, KV, FF),), n_groups=24),
    tie_embeddings=True,
    skip_shapes=("long_500k",),
)


def reduced() -> ModelCfg:
    return dataclasses.replace(
        CONFIG, name="whisper-medium-reduced", d_model=64, vocab=512,
        stack=StackCfg(pattern=(_dec_layer(64, 4, 4, 128, 16),), n_groups=2),
        encoder=StackCfg(pattern=(_enc_layer(64, 4, 4, 128, 16),), n_groups=2))
