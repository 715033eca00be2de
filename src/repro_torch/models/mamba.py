"""Selective state-space layer: Mamba1 (falcon-mamba).

The port of the JAX package's ``models/mamba.py`` for Mamba1; Mamba2 waits
for zamba2.

* **Prefill and train** (no cache: the state starts at zero) run the
  recurrence through ``ops.selective_scan``: the fused CUDA kernel on the
  card, ``ref.selective_scan`` on the CPU.  This replaces the JAX package's
  chunked associative scan; both compute h_t = exp(delta_t A) h_{t-1} +
  delta_t B_t x_t, y_t = sum_N(h_t C_t) from h_0 = 0.
* **Decode** stays the plain one-step recurrence, and writes the conv tail
  and the state into the caller's cache IN PLACE (the JAX package donates
  the cache to the decode step instead).

The depthwise causal conv stays a sum of shifted products, as in the JAX
package, so nothing goes through cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import Mamba1Cfg
from repro_torch.dist.sharding import TensorSpec, tspec
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Depthwise causal conv (width w) over (B, T, C)
# ---------------------------------------------------------------------------


def causal_conv(x, w, b, tail=None):
    """x (B,T,C), w (W,C), b (C,). tail (B,W-1,C) prepended (decode)."""
    width = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                           dtype=x.dtype, device=x.device)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0].to(x.dtype)
    for i in range(1, width):
        out = out + xp[:, i:i + t] * w[i].to(x.dtype)
    return out + b.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba1
# ---------------------------------------------------------------------------


def mamba1_specs(cfg: Mamba1Cfg, d_model: int) -> dict[str, TensorSpec]:
    di, n, w = cfg.d_inner, cfg.d_state, cfg.conv_width
    r = cfg.dt_rank or d_model // 16
    return {
        "in_proj": tspec((d_model, 2 * di), ("embed", "ssm_inner")),
        "conv_w": tspec((w, di), (None, "conv_dim"), scale=0.2),
        "conv_b": tspec((di,), ("conv_dim",), init="zeros"),
        "x_proj": tspec((di, r + 2 * n), ("ssm_inner", None)),
        "dt_proj": tspec((r, di), ("dt_rank", "ssm_inner"), scale=r**-0.5),
        "dt_bias": tspec((di,), ("ssm_inner",), init="zeros"),
        "A_log": tspec((di, n), ("ssm_inner", "ssm_state"), init="zeros"),
        "D": tspec((di,), ("ssm_inner",), init="ones"),
        "out_proj": tspec((di, d_model), ("ssm_inner", "embed")),
    }


def mamba1_cache_specs(cfg: Mamba1Cfg, d_model: int, batch: int,
                       dtype=torch.bfloat16) -> dict[str, TensorSpec]:
    di, n, w = cfg.d_inner, cfg.d_state, cfg.conv_width
    return {
        "conv": tspec((batch, w - 1, di), ("batch", None, "ssm_inner"), dtype,
                      init="zeros"),
        "state": tspec((batch, di, n), ("batch", "ssm_inner", "ssm_state"),
                       torch.float32, init="zeros"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba1(params, x, cfg: Mamba1Cfg, *, mode: str, cache):
    dt_ = x.dtype
    t, d_model = x.shape[1], x.shape[2]
    di, n = cfg.d_inner, cfg.d_state
    r = cfg.dt_rank or d_model // 16

    xz = x @ params["in_proj"].to(dt_)
    xa, z = xz[..., :di], xz[..., di:]

    conv_tail = cache["conv"] if cache is not None else None
    xa_raw = xa
    xa = F.silu(causal_conv(xa, params["conv_w"], params["conv_b"],
                            conv_tail))

    dbc = xa @ params["x_proj"].to(dt_)
    dt_r, bc, cc = dbc[..., :r], dbc[..., r:r + n], dbc[..., r + n:]
    delta = _softplus((dt_r @ params["dt_proj"].to(dt_)).float()
                      + params["dt_bias"].float())           # (B,T,di) f32
    A = -torch.exp(params["A_log"].float())                  # (di,N)
    bc32 = bc.float().contiguous()
    cc32 = cc.float().contiguous()
    xa32 = xa.float()

    if mode == "decode":
        if cache is None or t != 1:
            raise ValueError("mamba1: decode takes T == 1 and a cache")
        a = torch.exp(delta[:, 0, :, None] * A)                # (B,di,N)
        b = (delta[:, 0] * xa32[:, 0])[..., None] * bc32[:, 0, None, :]
        h = a * cache["state"] + b
        y = torch.einsum("bdn,bn->bd", h, cc32[:, 0])[:, None]  # (B,1,di)
        conv_new = torch.cat([conv_tail[:, 1:], xa_raw], dim=1)
        cache["conv"].copy_(conv_new)
        cache["state"].copy_(h)
        new_cache = cache
    else:
        y, h_last = ops.selective_scan(delta, xa32.contiguous(), bc32, cc32,
                                       A)
        if mode == "prefill":
            tail_len = cfg.conv_width - 1
            new_cache = {"conv": xa_raw[:, t - tail_len:].to(dt_),
                         "state": h_last}
        else:
            new_cache = None

    y = y.to(dt_) + params["D"].to(dt_) * xa
    y = y * F.silu(z)
    return y @ params["out_proj"].to(dt_), new_cache
