"""Layer-stack pattern machinery.

The port of the JAX package's ``models/stack.py``.  A model stack is a
repeated *pattern* of layer configs, with group-stacked parameters and
caches: every leaf has a leading ``n_groups`` axis, as in the JAX package.
Where the JAX package runs ``lax.scan`` over the groups, the port runs a
Python loop: each layer takes its group's view of every parameter (one
``unbind`` a leaf) and the view ``[g]`` of every cache leaf.  Decode
caches are written through those views, in place; prefill stacks the
layers' new caches once at the end.  A partial ``tail`` runs after the
groups.  A layer whose attention is ``cross`` (the whisper decoder's) runs
causal self-attention (``_no_cross``), then cross-attention over the
encoder's hidden states (``aux["enc"]``, under ``ln_x`` / ``xattn``), then
its MLP, with a "self" and a "cross" cache.  An ``attn_mlp`` layer with
``moe`` set runs the MoE layer (``models.moe``) as its feed-forward.  A
``shared`` position (zamba2's shared attention block) owns no parameters:
it runs ``StackCfg.shared`` with the stack's one ``params["shared"]``
tree, wherever it occurs, and keeps a cache of its own per occurrence in
the group's (or tail's) cache tree.  Unknown kinds raise ``ValueError``.

Remat in train mode, as the JAX package's ``jax.checkpoint`` around each
group: ``"full"`` wraps each group in ``torch.utils.checkpoint.checkpoint``
(non-reentrant: the parameters the group closes over, the shared ones
too, get their gradients through it), so only the group's input is kept
and the group is run again in the backward; ``"dots"`` is a selective
checkpoint that keeps the outputs of the products without batch
dimensions (``aten.mm``, what a weight product ``x @ w`` lowers to) and
recomputes everything else, the counterpart of
``dots_with_no_batch_dims_saveable``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LayerCfg, StackCfg
from repro_torch.dist.sharding import TensorSpec, map_specs
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models.attention import (attn_cache_specs, attn_specs,
                                          cache_len_for, cross_cache_specs)
from repro_torch.models.common import rmsnorm, rmsnorm_spec
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.moe import moe, moe_specs


# ---------------------------------------------------------------------------
# Per-layer specs / caches / apply
# ---------------------------------------------------------------------------


def layer_specs(lc: LayerCfg, d_model: int) -> dict[str, Any]:
    """A layer's parameter specs; a ``shared`` position owns none (its
    parameters are the stack's ``shared`` tree)."""
    if lc.kind == "shared":
        return {}
    if lc.kind == "attn_mlp":
        s: dict[str, Any] = {"ln1": rmsnorm_spec(d_model),
                             "attn": attn_specs(lc.attn, d_model),
                             "ln2": rmsnorm_spec(d_model)}
        if lc.attn.cross:
            s["ln_x"] = rmsnorm_spec(d_model)
            s["xattn"] = attn_specs(lc.attn, d_model)
        s["ffn"] = (moe_specs(lc.moe, d_model) if lc.moe
                    else mlp_specs(lc.mlp, d_model))
        return s
    if lc.kind in ("mamba1", "mamba2"):
        fn = (mamba_mod.mamba1_specs if lc.kind == "mamba1"
              else mamba_mod.mamba2_specs)
        return {"ln": rmsnorm_spec(d_model), "ssm": fn(lc.ssm, d_model)}
    raise ValueError(lc.kind)


def _effective(lc: LayerCfg, shared: Optional[LayerCfg]) -> LayerCfg:
    """The config a position runs: the stack's ``shared`` one at a
    ``shared`` position."""
    if lc.kind != "shared":
        return lc
    if shared is None:
        raise ValueError("a 'shared' layer needs the stack's shared config")
    return shared


def layer_cache_specs(lc: LayerCfg, d_model: int, batch: int, seq_len: int,
                      enc_len: int | None = None, dtype=torch.bfloat16,
                      shared: Optional[LayerCfg] = None) -> dict[str, Any]:
    """A layer's cache specs; a ``shared`` position keeps a cache of its
    own for the ``shared`` config it runs."""
    eff = _effective(lc, shared)
    if eff.kind == "attn_mlp":
        c = {"self": attn_cache_specs(eff.attn, batch,
                                      cache_len_for(eff.attn, seq_len),
                                      dtype)}
        if eff.attn.cross:
            c["cross"] = cross_cache_specs(eff.attn, batch, enc_len, dtype)
        return c
    if eff.kind in ("mamba1", "mamba2"):
        fn = (mamba_mod.mamba1_cache_specs if eff.kind == "mamba1"
              else mamba_mod.mamba2_cache_specs)
        return {"ssm": fn(eff.ssm, d_model, batch, dtype)}
    raise ValueError(eff.kind)


def apply_layer(lc: LayerCfg, params, x, *, mode: str, cache, aux: dict,
                eps: float, shared: Optional[LayerCfg] = None):
    """One layer; at a ``shared`` position ``params`` are the stack's
    shared parameters and ``shared`` their config."""
    eff = _effective(lc, shared)
    if eff.kind == "attn_mlp":
        a_cfg = eff.attn
        h = rmsnorm(x, params["ln1"], eps)
        a, c_self = attn_mod.attention(
            params["attn"], h, _no_cross(a_cfg) if a_cfg.cross else a_cfg,
            positions=aux["positions"], mode=mode,
            cache=cache.get("self") if cache else None,
            cache_len=aux.get("cache_len"))
        x = x + a
        new_cache = {} if c_self is None else {"self": c_self}
        if a_cfg.cross:
            h = rmsnorm(x, params["ln_x"], eps)
            a, c_cross = attn_mod.attention(
                params["xattn"], h, a_cfg, positions=None, mode=mode,
                cache=cache.get("cross") if cache else None,
                enc_kv=aux.get("enc"))
            x = x + a
            if c_cross is not None:
                new_cache["cross"] = c_cross
        h = rmsnorm(x, params["ln2"], eps)
        f = (moe(params["ffn"], h, eff.moe) if eff.moe
             else mlp(params["ffn"], h, eff.mlp))
        x = x + f
        return x, (new_cache or None)
    if eff.kind in ("mamba1", "mamba2"):
        h = rmsnorm(x, params["ln"], eps)
        fn = mamba_mod.mamba1 if eff.kind == "mamba1" else mamba_mod.mamba2
        y, c = fn(params["ssm"], h, eff.ssm, mode=mode,
                  cache=cache.get("ssm") if cache else None)
        x = x + y
        return x, ({"ssm": c} if c is not None else None)
    raise ValueError(eff.kind)


def _no_cross(a_cfg):
    """The cross layer's own self-attention config: causal, no cross."""
    return dataclasses.replace(a_cfg, cross=False)


# ---------------------------------------------------------------------------
# Stack-level specs
# ---------------------------------------------------------------------------


def _stack_tree(tree, n: int):
    return map_specs(
        lambda s: TensorSpec((n,) + s.shape, ("layers",) + s.axes, s.dtype,
                             s.init, s.scale), tree)


def stack_specs(sc: StackCfg, d_model: int) -> dict[str, Any]:
    out: dict[str, Any] = {}
    group = {f"p{i}": layer_specs(lc, d_model)
             for i, lc in enumerate(sc.pattern)}
    group = {k: v for k, v in group.items() if v}
    if sc.n_groups > 0 and group:
        out["groups"] = _stack_tree(group, sc.n_groups)
    if sc.tail:
        out["tail"] = {f"t{i}": layer_specs(lc, d_model)
                       for i, lc in enumerate(sc.tail)}
        out["tail"] = {k: v for k, v in out["tail"].items() if v}
    if sc.shared is not None:
        out["shared"] = layer_specs(sc.shared, d_model)
    return out


def stack_cache_specs(sc: StackCfg, d_model: int, batch: int, seq_len: int,
                      enc_len: int | None = None,
                      dtype=torch.bfloat16) -> dict[str, Any]:
    out: dict[str, Any] = {}
    group = {f"p{i}": layer_cache_specs(lc, d_model, batch, seq_len, enc_len,
                                        dtype, sc.shared)
             for i, lc in enumerate(sc.pattern)}
    if sc.n_groups > 0:
        out["groups"] = _stack_tree(group, sc.n_groups)
    if sc.tail:
        out["tail"] = {f"t{i}": layer_cache_specs(lc, d_model, batch,
                                                  seq_len, enc_len, dtype,
                                                  sc.shared)
                       for i, lc in enumerate(sc.tail)}
    return out


# ---------------------------------------------------------------------------
# Stack apply
# ---------------------------------------------------------------------------


def _index(tree, g: int):
    """The view [g] of every leaf of a group-stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def _unbind(tree, n: int) -> list:
    """The n per-group trees of views of a group-stacked tree, one
    ``unbind`` a leaf: its backward stacks the groups' gradients once,
    where n views ``[g]`` would each scatter theirs into a zero tensor of
    the whole leaf and add the n of them up."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][g] for k in tree} for g in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees: list):
    """Per-group trees -> one tree with a leading group axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# the products that "dots" keeps: weight products (B*T, D) @ (D, F)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


REMAT = ("none", "full", "dots")


def apply_stack(params, x, sc: StackCfg, *, mode: str, cache, aux: dict,
                eps: float, remat: str = "none"):
    """Returns (x, new_cache_or_None).  Decode updates ``cache`` in place
    and returns it.  ``remat`` ("none" | "full" | "dots") applies in train
    mode only."""
    if remat not in REMAT:
        raise ValueError(f"apply_stack: remat {remat!r} not in {REMAT}")

    shared_params = params.get("shared")

    def group_body(x, gp, gc):
        new_c: dict[str, Any] = {}
        for i, lc in enumerate(sc.pattern):
            key = f"p{i}"
            p = shared_params if lc.kind == "shared" else gp[key]
            x, nc = apply_layer(lc, p, x, mode=mode,
                                cache=gc.get(key) if gc else None,
                                aux=aux, eps=eps, shared=sc.shared)
            if nc is not None:
                new_c[key] = nc
        return x, new_c

    if mode == "train" and remat != "none":
        kw = {} if remat == "full" else {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)}

        def run_group(x, gp, gc):
            out = checkpoint(lambda y: group_body(y, gp, None)[0], x,
                             use_reentrant=False, **kw)
            return out, {}
    else:
        run_group = group_body

    new_cache: dict[str, Any] = {}
    if sc.n_groups > 0:
        gp_all = _unbind(params["groups"], sc.n_groups)
        gc_all = cache.get("groups") if cache is not None else None
        built = []
        for g in range(sc.n_groups):
            gp = gp_all[g]
            gc = _index(gc_all, g) if gc_all is not None else None
            x, new_c = run_group(x, gp, gc)
            built.append(new_c)
        if mode == "decode":
            new_cache["groups"] = gc_all
        elif mode == "prefill":
            new_cache["groups"] = _stack(built)

    for i, lc in enumerate(sc.tail):
        key = f"t{i}"
        c: Optional[dict] = ((cache.get("tail") or {}).get(key)
                             if cache is not None else None)
        p = shared_params if lc.kind == "shared" else params["tail"][key]
        x, nc = apply_layer(lc, p, x, mode=mode, cache=c, aux=aux, eps=eps,
                            shared=sc.shared)
        if nc is not None:
            new_cache.setdefault("tail", {})[key] = nc

    return x, (new_cache if mode in ("prefill", "decode") else None)
