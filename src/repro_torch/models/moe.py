"""Top-k routed Mixture-of-Experts with grouped, capacity-bounded dispatch.

The port of the JAX package's ``models/moe.py``, with its semantics:

* **Groups.** The B*T tokens, batch-major, form ``group_count(B*T)``
  contiguous groups; positions and capacity are counted within a group.
* **Capacity.** ``capacity`` rounds up to a multiple of 4.  It decides
  which assignments are dropped, so it is part of the result.
* **Router.** Float32 logits; the top k in descending order; the gates
  are the softmax over the k kept logits (mixtral-style).
* **Positions.** An assignment's position within its (group, expert) is
  the exclusive cumsum over the group's (token, slot) assignments,
  token-major and slot-minor; it is kept while ``pos < cap``.
* **Combine.** Each token sums its k expert outputs weighted by
  ``gates * keep`` in the compute dtype.
* **Arctic's dense residual** (``cfg.dense_residual_ff``): a dense MLP
  (``res_*``) on the same input, added to the mixture.

Dropped assignments: the JAX package scatters every assignment with
``mode="drop"`` (destinations past ``E*cap`` are skipped) and gathers
with clamped indices.  A PyTorch index past the end raises on the CPU and
asserts on the card, so the port clamps every destination into
``[0, E*cap)``: a dropped assignment scatters its zeroed input (a no-op
add) and gathers a finite row that its weight of 0 cancels.  The numbers
are the JAX package's.

The expert products run one expert at a time, its weights cast to the
compute dtype at use, so no copy of a whole (E, D, F) expert tensor in
another dtype is ever made (arctic's ``w_gate`` of one layer is 17.8 GB
in float32).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MlpCfg, MoECfg
from repro_torch.dist.sharding import TensorSpec, tspec
from repro_torch.models.mlp import mlp, mlp_specs

DEFAULT_GROUPS = 32


def moe_specs(cfg: MoECfg, d_model: int) -> dict[str, TensorSpec]:
    e, f = cfg.n_experts, cfg.d_ff
    s = {
        "router": tspec((d_model, e), ("embed", "expert"),
                        scale=d_model**-0.5),
        "w_gate": tspec((e, d_model, f), ("expert", "embed", "expert_mlp")),
        "w_up": tspec((e, d_model, f), ("expert", "embed", "expert_mlp")),
        "w_down": tspec((e, f, d_model), ("expert", "expert_mlp", "embed")),
    }
    if cfg.dense_residual_ff:
        for k, v in mlp_specs(MlpCfg(cfg.dense_residual_ff), d_model).items():
            s["res_" + k] = v
    return s


def group_count(n_tokens: int, want: int | None = None) -> int:
    """Groups scale with token count: decode-sized batches (<= 256 tokens)
    use one group, so per-(group, expert) capacity floors do not inflate
    the dispatch buffer for one-token steps."""
    if want is None:
        want = min(DEFAULT_GROUPS, max(1, n_tokens // 256))
    g = min(want, n_tokens)
    while n_tokens % g:
        g -= 1
    return g


def capacity(cfg: MoECfg, group_tokens: int) -> int:
    c = int(math.ceil(cfg.capacity_factor * group_tokens * cfg.top_k
                      / cfg.n_experts))
    return max(4, -(-c // 4) * 4)  # round up to a multiple of 4


def route(params, xg: torch.Tensor, cfg: MoECfg):
    """xg (G, ng, D) -> (logits (G,ng,E) float32, top_idx (G,ng,k),
    gates (G,ng,k) float32, pos (G,ng,k)): the router and each
    assignment's position within its (group, expert)."""
    g, ng, _ = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    logits = xg.float() @ params["router"].float()
    top_logits, top_idx = torch.topk(logits, k, dim=-1)
    gates = torch.softmax(top_logits, dim=-1)
    flat = F.one_hot(top_idx.reshape(g, ng * k), e)        # (G, ng*k, E)
    excl = torch.cumsum(flat, dim=1) - flat
    pos = excl.gather(-1, top_idx.reshape(g, ng * k, 1)).reshape(g, ng, k)
    return logits, top_idx, gates, pos


def moe(params, x: torch.Tensor, cfg: MoECfg, *, return_aux: bool = False):
    """x (B,T,D) -> (B,T,D). Router in float32; experts in x's dtype."""
    dt = x.dtype
    b, t, d = x.shape
    n = b * t
    e, k = cfg.n_experts, cfg.top_k
    g = group_count(n)
    ng = n // g                                  # tokens per group
    cap = capacity(cfg, ng)

    xg = x.reshape(g, ng, d)
    logits, top_idx, gates, pos = route(params, xg, cfg)
    keep = pos < cap

    # dispatch: every assignment into its group's (E*cap, D) buffer at
    # expert * cap + pos, clamped in range; a dropped one adds zeros
    dest = (top_idx * cap + pos).clamp(max=e * cap - 1)
    dest = dest + torch.arange(g, device=x.device).view(g, 1, 1) * (e * cap)
    dest = dest.reshape(-1)
    src = (xg[:, :, None, :] * keep[..., None].to(dt)).reshape(-1, d)
    disp = x.new_zeros((g * e * cap, d)).index_add(0, dest, src)
    disp = disp.view(g, e, cap, d)

    outs = []
    for i in range(e):
        xe = disp[:, i]                                        # (G, cap, D)
        h = F.silu(xe @ params["w_gate"][i].to(dt)) * (
            xe @ params["w_up"][i].to(dt))
        outs.append(h @ params["w_down"][i].to(dt))
    out = torch.stack(outs, dim=1).reshape(g * e * cap, d)
    del outs

    # combine: each assignment's row back to its token, weighted
    gathered = out.index_select(0, dest).view(g, ng, k, d)
    w = (gates.to(dt) * keep.to(dt))[..., None]
    y = (gathered * w).sum(dim=2).reshape(b, t, d)

    if cfg.dense_residual_ff:
        res = {kk[4:]: v for kk, v in params.items() if kk.startswith("res_")}
        y = y + mlp(res, x, MlpCfg(cfg.dense_residual_ff))

    if return_aux:
        aux = {
            "kept_fraction": keep.float().mean(),
            "router_entropy": -(torch.softmax(logits, -1)
                                * torch.log_softmax(logits, -1)
                                ).sum(-1).mean(),
            "load_balance_loss": load_balance_loss(logits, top_idx),
            "top_idx": top_idx.reshape(n, k),
            "pos": pos.reshape(n, k),
            "gates": gates.reshape(n, k),
        }
        return y, aux
    return y


def load_balance_loss(router_logits: torch.Tensor,
                      top_idx: torch.Tensor) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e, where f_e is the
    fraction of assignments routed to expert e and p_e the mean router
    probability.  1 at perfectly uniform routing."""
    e = router_logits.shape[-1]
    probs = torch.softmax(router_logits.float(), dim=-1)     # (G,ng,E)
    frac = F.one_hot(top_idx.long(), e).float().mean(dim=(0, 1, 2))
    pmean = probs.mean(dim=(0, 1))
    return e * torch.sum(frac * pmean)
