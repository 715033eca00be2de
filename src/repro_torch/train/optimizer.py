"""AdamW with global-norm clipping and a warmup + cosine learning-rate
schedule, written out (no ``torch.optim``).

The port of the JAX package's ``train/optimizer.py``.  The update is
functional, as there: ``adamw_update`` takes the parameter, gradient and
moment trees and returns new ones, with the same arithmetic in float32.
The moments are kept in ``OptCfg.state_dtype`` (float32 by default;
bfloat16 halves the optimizer's memory).  Every number stays a tensor on
the parameters' device, so a step needs no host sync.  A leaf of more
than ``_SLICE_ELEMS`` values is updated a slice at a time into its new
tensors (the update is elementwise, so the numbers are the same): the
float32 temporaries of one slice, not of the whole leaf, sit beside the
old and the new state (a mixtral layer's expert leaves are 3.2 GB each:
its one-layer step with bf16 moments ran out of an H100's 80 GB in an
unsliced update).
"""
from __future__ import annotations

import dataclasses
import math

import torch

_SLICE_ELEMS = 1 << 26      # update big leaves in slices of 64 M values


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    state_dtype: torch.dtype = torch.float32   # bf16 halves optimizer memory


def tree_leaves(tree) -> list:
    """Leaves in the JAX package's flattening order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_rebuild(tree, leaves):
    """A tree shaped like ``tree`` with ``leaves`` in flattening order."""
    return _rebuild(tree, iter(leaves))


def _rebuild(node, it):
    # a module-level recursion: a nested one would close over itself, and
    # the cycle would keep every new leaf alive until a garbage collection
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    return next(it)


def lr_at(cfg: OptCfg, step) -> torch.Tensor:
    """Linear warmup to ``lr`` over ``warmup_steps``, then cosine decay to
    ``min_lr_frac * lr`` at ``total_steps``; a float32 scalar tensor on
    ``step``'s device (the CPU for a Python number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac)
                    * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptCfg) -> dict:
    def z(tree):
        if isinstance(tree, dict):
            return {k: z(v) for k, v in tree.items()}
        return torch.zeros(tree.shape, dtype=cfg.state_dtype,
                           device=tree.device)
    dev = tree_leaves(params)[0].device
    return {"m": z(params), "v": z(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                          for g in tree_leaves(tree)))


def adamw_update(params, grads, opt_state, cfg: OptCfg):
    """-> (new_params, new_opt_state, metrics {"grad_norm", "lr"}).
    Decoupled weight decay on matrices only (ndim >= 2)."""
    step = opt_state["step"]
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_at(cfg, step)
    t = (step + 1).to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=t.device), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=t.device), t)

    def upd(p, g, m, v, wd):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.to(torch.float32) * cfg.b2 + (1 - cfg.b2) * g * g
        step_ = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        p32 = p.to(torch.float32)
        p32 = p32 - lr * (step_ + wd * p32)
        return (p32.to(p.dtype), m32.to(cfg.state_dtype),
                v32.to(cfg.state_dtype))

    def upd_leaf(p, g, m, v):
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        if p.numel() <= _SLICE_ELEMS:
            return upd(p, g, m, v, wd)
        out = (torch.empty_like(p),
               torch.empty(p.shape, dtype=cfg.state_dtype, device=p.device),
               torch.empty(p.shape, dtype=cfg.state_dtype, device=p.device))
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        dst = [t.view(-1) for t in out]
        for i in range(0, p.numel(), _SLICE_ELEMS):
            part = upd(*(t[i:i + _SLICE_ELEMS] for t in flat), wd)
            for d, r in zip(dst, part):
                d[i:i + _SLICE_ELEMS] = r
        return out

    flat_p = tree_leaves(params)
    flat_g = tree_leaves(grads)
    flat_m = tree_leaves(opt_state["m"])
    flat_v = tree_leaves(opt_state["v"])
    out = [upd_leaf(p, g, m, v)
           for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v)]
    new_p = tree_rebuild(params, [o[0] for o in out])
    new_m = tree_rebuild(params, [o[1] for o in out])
    new_v = tree_rebuild(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step + 1}, metrics
