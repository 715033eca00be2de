"""Config dataclasses for the served models + the four assigned input shapes.

The port of the JAX package's ``configs/base.py``: every family, dense GQA,
MoE (``MoECfg``, ``moe_layer``), Mamba1, the Mamba2 hybrid with its shared
attention block (``Mamba2Cfg``, ``StackCfg.shared``), and the
encoder-decoder (whisper: ``ModelCfg.encoder`` and
``ModelCfg.embed_inputs``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# Sub-layer configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    n_heads: int
    n_kv: int
    head_dim: int
    window: Optional[int] = None          # None = full attention
    rope_theta: float = 10000.0
    mrope_section: Optional[tuple[int, ...]] = None
    causal: bool = True
    cross: bool = False                   # cross-attention (enc-dec decoder)
    qk_norm: bool = False                 # gemma3-style per-head RMS on q,k
    softcap: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MlpCfg:
    d_ff: int
    gated: bool = True                    # SwiGLU (gated) vs plain GeLU MLP


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    dense_residual_ff: Optional[int] = None   # arctic: parallel dense MLP


@dataclasses.dataclass(frozen=True)
class Mamba1Cfg:
    d_inner: int
    d_state: int = 16
    dt_rank: int = 0                      # 0 -> d_model // 16
    conv_width: int = 4
    chunk: int = 64


@dataclasses.dataclass(frozen=True)
class Mamba2Cfg:
    d_inner: int
    d_state: int = 64
    head_dim: int = 64
    conv_width: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    """One position in the stack pattern."""

    kind: str                 # 'attn_mlp' | 'mamba1' | 'mamba2' | 'shared'
    attn: Optional[AttnCfg] = None
    mlp: Optional[MlpCfg] = None
    moe: Optional[MoECfg] = None
    ssm: Optional[Mamba1Cfg | Mamba2Cfg] = None


@dataclasses.dataclass(frozen=True)
class StackCfg:
    pattern: tuple[LayerCfg, ...]
    n_groups: int
    tail: tuple[LayerCfg, ...] = ()
    shared: Optional[LayerCfg] = None     # weights for kind='shared' positions

    @property
    def n_layers(self) -> int:
        return self.n_groups * len(self.pattern) + len(self.tail)


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    d_model: int
    vocab: int
    stack: StackCfg
    encoder: Optional[StackCfg] = None    # whisper
    tie_embeddings: bool = True
    embed_scale: bool = False             # gemma: x *= sqrt(d_model)
    embed_inputs: bool = True             # False: input_specs feeds embeddings
    norm_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.bfloat16
    # which assigned shapes apply (long_500k skipped for pure full-attention)
    skip_shapes: tuple[str, ...] = ()

    @property
    def n_layers(self) -> int:
        return self.stack.n_layers

    @property
    def mrope(self) -> bool:
        """Whether an attention layer rotates by M-RoPE sections (qwen2-vl):
        the model then runs on (3, B, T) positions."""
        return any(lc.attn is not None and lc.attn.mrope_section
                   for lc in self.stack.pattern + self.stack.tail)


# ---------------------------------------------------------------------------
# Assigned input shapes (identical for every LM-family arch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                             # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def dense_layer(d_model: int, n_heads: int, n_kv: int, d_ff: int,
                head_dim: int | None = None, window: int | None = None,
                rope_theta: float = 10000.0, qk_norm: bool = False,
                mrope: tuple[int, ...] | None = None, cross: bool = False,
                causal: bool = True) -> LayerCfg:
    return LayerCfg(
        kind="attn_mlp",
        attn=AttnCfg(n_heads=n_heads, n_kv=n_kv,
                     head_dim=head_dim or d_model // n_heads, window=window,
                     rope_theta=rope_theta, qk_norm=qk_norm,
                     mrope_section=mrope, cross=cross, causal=causal),
        mlp=MlpCfg(d_ff=d_ff),
    )


def moe_layer(d_model: int, n_heads: int, n_kv: int, d_ff: int,
              n_experts: int, top_k: int, head_dim: int | None = None,
              window: int | None = None, dense_residual_ff: int | None = None,
              capacity_factor: float = 1.25) -> LayerCfg:
    return LayerCfg(
        kind="attn_mlp",
        attn=AttnCfg(n_heads=n_heads, n_kv=n_kv,
                     head_dim=head_dim or d_model // n_heads, window=window),
        moe=MoECfg(n_experts=n_experts, top_k=top_k, d_ff=d_ff,
                   capacity_factor=capacity_factor,
                   dense_residual_ff=dense_residual_ff),
    )
