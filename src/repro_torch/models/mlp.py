"""Dense feed-forward: SwiGLU (gated) or GeLU MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MlpCfg
from repro_torch.dist.sharding import TensorSpec, constrain, tspec


def mlp_specs(cfg: MlpCfg, d_model: int) -> dict[str, TensorSpec]:
    if cfg.gated:
        return {
            "w_gate": tspec((d_model, cfg.d_ff), ("embed", "mlp")),
            "w_up": tspec((d_model, cfg.d_ff), ("embed", "mlp")),
            "w_down": tspec((cfg.d_ff, d_model), ("mlp", "embed")),
        }
    return {
        "w_up": tspec((d_model, cfg.d_ff), ("embed", "mlp")),
        "w_down": tspec((cfg.d_ff, d_model), ("mlp", "embed")),
    }


def mlp(params, x: torch.Tensor, cfg: MlpCfg) -> torch.Tensor:
    dt = x.dtype
    up = x @ params["w_up"].to(dt)
    if cfg.gated:
        gate = x @ params["w_gate"].to(dt)
        h = F.silu(gate) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    h = constrain(h, ("batch", "seq", "act_mlp"), weight=params["w_up"])
    out = h @ params["w_down"].to(dt)
    return constrain(out, ("batch", "seq", "act_embed"),
                     weight=params["w_down"])
