"""Step builders: train_step / prefill_step / decode_step, and the specs of
their inputs and state.

The port of the JAX package's ``train/step.py``.  PyTorch runs eagerly, so
a step is a plain function (the JAX package jits it).  The train step
differentiates the parameter tree with ``torch.autograd.grad`` where the
JAX package calls ``jax.value_and_grad``, and applies the functional AdamW
update; on the card, attention and the Mamba1 scan run forward and
backward through the hand-written kernels (``kernels/ops.py``).  The
serving steps run under ``torch.no_grad()``; the decode step writes the
cache in place and returns it, where the JAX package donates the cache to
the jitted step.

The serving steps take the JAX package's ``mesh`` and ``rules``.  With a
mesh of more than one slot they run sharded (``sharded_forward``): the
parameters and caches are trees of ``dist.sharding.Sharded`` leaves laid
out as ``resolve_pspec`` lays them (``dist.sharding.place``), each slot
runs the model on its parts in its own thread (``DeviceMesh.run_spmd``),
the batch is split over "data" where it divides, and the logits come back
whole on the mesh's first device, as the JAX step returns them.  A config
or layout the sharded steps do not run raises ``NotImplementedError``
when the step is made (``check_sharded_serving``).  With no mesh, or a
mesh of one slot, nothing changes.  Training is not sharded yet:
``make_train_step`` refuses a mesh of more than one slot.

Batches as the JAX package's: "tokens" (B,T), or "inputs" (B,T,D)
embeddings for a model with ``embed_inputs=False``; an encoder-decoder
(whisper) takes "tokens" and "enc_inputs" (B,S_enc,D) frame embeddings in
train and prefill, and decode runs no encoder.  Decode embeds its tokens
through the table for every model, and an M-RoPE model (qwen2-vl) decodes
at (3,B,1) positions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelCfg, ShapeCfg
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import (TensorSpec, init_params, map_specs,
                                       tspec)
from repro_torch.models.losses import chunked_xent, xent
from repro_torch.models.model import (decode_positions, forward, lm_head,
                                      model_cache_specs, model_specs)
from repro_torch.train.optimizer import (OptCfg, adamw_update,
                                        init_opt_state, tree_leaves,
                                        tree_rebuild)


@dataclasses.dataclass(frozen=True)
class StepCfg:
    """Train-step options, the JAX package's fields and defaults.
    ``donate_cache`` has no effect in the port: decode always writes the
    cache in place."""
    remat: str = "full"              # 'none' | 'full' | 'dots'
    loss: str = "plain"              # 'plain' | 'chunked'
    loss_chunks: int = 8
    donate_cache: bool = True


# ---------------------------------------------------------------------------
# Input and state specs
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelCfg, shape: ShapeCfg) -> dict[str, Any]:
    """TensorSpec tree of every model input of (arch x shape)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs: dict[str, Any] = {}
        if cfg.embed_inputs:
            specs["tokens"] = tspec((b, s), ("batch", "seq"), torch.int32)
        else:  # vlm stub: precomputed patch/frame embeddings
            specs["inputs"] = tspec((b, s, cfg.d_model),
                                    ("batch", "seq", "act_embed"),
                                    torch.bfloat16)
        if cfg.encoder is not None:  # whisper: frame embeddings + text tokens
            specs["tokens"] = tspec((b, s), ("batch", "seq"), torch.int32)
            specs["enc_inputs"] = tspec((b, s, cfg.d_model),
                                        ("batch", "seq", "act_embed"),
                                        torch.bfloat16)
        if shape.kind == "train":
            specs["labels"] = tspec((b, s), ("batch", "seq"), torch.int32)
        return specs
    if shape.kind == "decode":
        return {"tokens": tspec((b,), ("batch",), torch.int32),
                "pos": tspec((), (), torch.int32)}
    raise ValueError(shape.kind)


def cache_specs_for(cfg: ModelCfg, shape: ShapeCfg) -> dict[str, Any]:
    if shape.kind != "decode":
        raise ValueError(f"cache_specs_for: a decode shape, got "
                         f"{shape.kind!r}")
    return model_cache_specs(cfg, shape.global_batch, shape.seq_len,
                             enc_len=min(shape.seq_len, 32768))


def train_state_specs(cfg: ModelCfg, opt: OptCfg) -> dict[str, Any]:
    p = model_specs(cfg)

    def zero(s: TensorSpec) -> TensorSpec:
        return TensorSpec(s.shape, s.axes, opt.state_dtype, "zeros")
    return {"params": p, "m": map_specs(zero, p), "v": map_specs(zero, p),
            "step": tspec((), (), torch.int32, init="zeros")}


def init_train_state(cfg: ModelCfg, opt: OptCfg, generator: torch.Generator,
                     device) -> dict:
    """Parameters from ``init_params`` (float32, drawn by ``generator``,
    which lives on ``device``), zero moments in ``opt.state_dtype``, step
    0."""
    params = init_params(model_specs(cfg), generator, device)
    st = init_opt_state(params, opt)
    return {"params": params, "m": st["m"], "v": st["v"], "step": st["step"]}


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------


def _inputs(cfg: ModelCfg, batch: dict) -> tuple[torch.Tensor, dict]:
    """(the model's inputs, forward's keyword arguments) of a batch, as the
    JAX package's steps pick them."""
    if cfg.encoder is not None:
        need = ("tokens", "enc_inputs")
    else:
        need = ("tokens",) if cfg.embed_inputs else ("inputs",)
    missing = [k for k in need if k not in batch]
    if missing:
        raise ValueError(f"step: {cfg.name} takes a batch with {need}, "
                         f"missing {missing}")
    if cfg.encoder is not None:
        return batch["tokens"], {"enc_inputs": batch["enc_inputs"]}
    return batch[need[0]], {}


def loss_and_grads(cfg: ModelCfg, step_cfg: StepCfg, params, batch):
    """-> (loss, grads): the scalar loss of ``batch`` and its gradient
    tree (the parameters' structure and dtypes), as
    ``jax.value_and_grad`` of the JAX package's loss."""
    if step_cfg.loss not in ("plain", "chunked"):
        raise ValueError(f"train step: unknown loss {step_cfg.loss!r}")
    inputs, kw = _inputs(cfg, batch)
    flat = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    live = tree_rebuild(params, flat)
    # the one leaf the loss does not reach by construction: the embedding
    # table of an untied model fed embeddings (qwen2-vl), which gets a zero
    # gradient as jax.value_and_grad gives it; any other leaf left
    # unreached is a fault, and autograd raises for it
    unreached = (live["embed"] if not cfg.embed_inputs
                 and not cfg.tie_embeddings else None)
    reached = [x for x in flat if x is not unreached]
    with torch.enable_grad():
        if step_cfg.loss == "chunked":
            hidden = forward(live, cfg, inputs, mode="train",
                             remat=step_cfg.remat, return_hidden=True, **kw)
            head = lm_head(live, cfg).to(hidden.dtype)
            loss = chunked_xent(hidden, head, batch["labels"],
                                step_cfg.loss_chunks)
        else:
            logits = forward(live, cfg, inputs, mode="train",
                             remat=step_cfg.remat, **kw)
            loss = xent(logits, batch["labels"])
            del logits
        grads = iter(torch.autograd.grad(loss, reached))
    return loss.detach(), tree_rebuild(params, [
        torch.zeros_like(x) if x is unreached else next(grads)
        for x in flat])


def make_train_step(cfg: ModelCfg, opt: OptCfg, step_cfg: StepCfg = StepCfg(),
                    mesh=None):
    """The step ``(state, batch) -> (new_state, {"loss", "grad_norm",
    "lr"})`` over ``state = {params, m, v, step}``; the metrics are 0-d
    tensors on the state's device.  ``mesh`` is the JAX package's
    argument: training runs on one device, so a mesh of one slot (the
    host mesh) is taken as is and a mesh of more than one slot raises
    ``NotImplementedError`` (sharded training is later work)."""
    if is_sharded_mesh(mesh):
        raise NotImplementedError("sharded training: the train step runs "
                                  "on one device (a mesh of one slot)")

    def train_step(state, batch):
        loss, grads = loss_and_grads(cfg, step_cfg, state["params"], batch)
        new_p, new_opt, metrics = adamw_update(
            state["params"], grads,
            {"m": state["m"], "v": state["v"], "step": state["step"]}, opt)
        metrics["loss"] = loss
        new_state = {"params": new_p, "m": new_opt["m"], "v": new_opt["v"],
                     "step": new_opt["step"]}
        return new_state, metrics

    return train_step


def make_prefill_step(cfg: ModelCfg, step_cfg: StepCfg = StepCfg(),
                      mesh=None, rules=None, max_len: int | None = None):
    """max_len: KV-cache capacity for subsequent decode steps (defaults to
    the prompt length — pass prompt+generation budget when serving).
    With a mesh of more than one slot the step takes placed parameters
    and returns the last position's logits whole and the cache placed
    (``sharded_forward``)."""
    if is_sharded_mesh(mesh):
        check_sharded_serving(cfg, mesh, rules)

        def sharded_prefill(params, batch):
            inputs, _ = _inputs(cfg, batch)
            with torch.no_grad():
                return sharded_forward(params, cfg, mesh, rules, inputs,
                                       mode="prefill", cache_len=max_len,
                                       last=True)
        return sharded_prefill

    def prefill_step(params, batch):
        inputs, kw = _inputs(cfg, batch)
        with torch.no_grad():
            logits, cache = forward(params, cfg, inputs, mode="prefill",
                                    cache_len=max_len, **kw)
            return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelCfg, step_cfg: StepCfg = StepCfg(),
                     mesh=None, rules=None):
    """The step ``(params, cache, {"tokens" (B,), "pos"}) -> (logits (B,V),
    cache)``, the cache written in place.  With a mesh of more than one
    slot it takes placed parameters and cache and whole tokens, which it
    splits over "data" as the cache's batch is split."""
    if is_sharded_mesh(mesh):
        check_sharded_serving(cfg, mesh, rules)

        def sharded_decode(params, cache, batch):
            with torch.no_grad():
                return sharded_forward(params, cfg, mesh, rules,
                                       batch["tokens"][:, None],
                                       mode="decode", cache=cache,
                                       pos=batch["pos"], last=True)
        return sharded_decode

    def decode_step(params, cache, batch):
        with torch.no_grad():
            tokens = batch["tokens"][:, None]                 # (B,1)
            pos = decode_positions(batch["pos"], tokens.shape[0],
                                   tokens.device, cfg.mrope)
            logits, cache = forward(params, cfg, tokens, mode="decode",
                                    cache=cache, positions=pos)
            return logits[:, 0], cache

    return decode_step


# ---------------------------------------------------------------------------
# Sharded serving over a ("data", "model") mesh
# ---------------------------------------------------------------------------

# mesh axis -> the logical axes a parameter may be split over there
_SPLITS = {"data": ("embed",),
           "model": ("heads", "kv_heads", "mlp", "vocab", "ssm_inner",
                     "conv_dim")}


def is_sharded_mesh(mesh) -> bool:
    """A mesh of more than one slot (the sharded steps' meshes)."""
    return mesh is not None and mesh.devices.size > 1


def check_sharded_serving(cfg: ModelCfg, mesh, rules=None):
    """Raise ``NotImplementedError`` for a config or layout the sharded
    serving steps do not run (before any work): a mesh other than
    ("data", "model"); an encoder-decoder (cross-attention), embedding
    inputs, a shared block, Mamba2, MoE, ring caches (a window) or M-RoPE;
    heads that the "model" axis does not divide (the JAX package's
    ``act_seq_tp``); query heads and KV heads split differently; a Mamba1
    layer whose fused ``in_proj`` and channel leaves split differently;
    and any parameter split other than "embed" over "data" and the heads,
    MLP, vocabulary and SSM channels over "model"."""
    def refuse(what):
        raise NotImplementedError(f"sharded serving of {cfg.name} on "
                                  f"{dict(mesh.shape)}: {what}")

    if tuple(mesh.axis_names) != ("data", "model"):
        refuse(f"mesh axes {mesh.axis_names}, not ('data', 'model')")
    if cfg.encoder is not None:
        refuse("cross-attention (an encoder-decoder)")
    if not cfg.embed_inputs:
        refuse("embedding inputs")
    if cfg.stack.shared is not None:
        refuse("a shared block")
    msize = mesh.shape["model"]
    for lc in cfg.stack.pattern + cfg.stack.tail:
        if lc.kind not in ("attn_mlp", "mamba1"):
            refuse(f"{lc.kind} layers")
        if lc.moe is not None:
            refuse("MoE experts")
        a = lc.attn
        if a is None:
            continue
        if a.n_heads % msize:
            refuse(f"{a.n_heads} heads on a {msize}-wide 'model' axis "
                   f"(act_seq_tp: the query sequence over 'model')")
        if a.cross:
            refuse("cross-attention")
        if a.window is not None:
            refuse("ring caches (a window)")
        if a.mrope_section:
            refuse("M-RoPE")
    specs = model_specs(cfg)

    def lay(spec):
        return sh.layout_of(sh.resolve_pspec(spec.shape, spec.axes, mesh,
                                             rules), len(spec.shape))

    for spec in sh._leaves(specs):
        for name, axes in zip(spec.axes, lay(spec)):
            for a in axes:
                if len(axes) > 1 or name not in _SPLITS.get(a, ()):
                    refuse(f"a parameter's {name!r} axis split over "
                           f"{axes}")
    groups = specs["stack"].get("groups", {})
    for layer in list(groups.values()) + list(
            specs["stack"].get("tail", {}).values()):
        if "attn" in layer:
            at = layer["attn"]
            if lay(at["wq"])[-2] != lay(at["wk"])[-2]:
                refuse("query heads and KV heads split differently")
        if "ssm" in layer:
            ssm = layer["ssm"]
            ways = {lay(ssm["in_proj"])[-1]} | {
                lay(ssm[k])[-1] for k in ("conv_b", "dt_bias", "D")}
            if len(ways) > 1:
                refuse("a Mamba1 layer's in_proj and channel leaves split "
                       "differently")


def _vocab_layout(cfg: ModelCfg, mesh, rules) -> tuple:
    """The axes the logits' vocabulary is split over: the head's."""
    specs = model_specs(cfg)
    spec, dim = ((specs["embed"], 0) if cfg.tie_embeddings
                 else (specs["lm_head"], 1))
    return sh.layout_of(sh.resolve_pspec(spec.shape, spec.axes, mesh, rules),
                        len(spec.shape))[dim]


def sharded_forward(params, cfg: ModelCfg, mesh, rules, tokens, *,
                    mode: str, cache=None, pos=None,
                    cache_len: int | None = None, last: bool = False):
    """``forward`` in prefill or decode on every slot of ``mesh`` at once:
    ``params`` and ``cache`` trees of ``Sharded`` leaves (``place``),
    ``tokens`` (B,T) whole, split over the axes ``resolve_pspec`` gives
    ("batch", "seq"), ``pos`` decode's position.  Returns (the logits,
    whole on the mesh's first device, (B,V) of the last position with
    ``last`` else (B,T,V); the cache: prefill's placed as
    ``model_cache_specs`` lays it out, decode's the one given, written in
    place)."""
    leaves = [x for x in _tree_leaves(params)]
    if not leaves or not all(sh.is_sharded(x) and x.mesh is mesh
                             for x in leaves):
        raise ValueError("sharded_forward: the parameters are not placed "
                         "on this mesh (dist.sharding.place)")
    sizes = mesh.shape
    tok_layout = sh.layout_of(sh.resolve_pspec(
        tuple(tokens.shape), ("batch", "seq"), mesh, rules), 2)

    def run(coords):
        with sh.slot_ctx(mesh, rules, tok_layout[0]):
            p = sh.shard_tree(params, coords)
            c = None if cache is None else sh.shard_tree(cache, coords)
            reg = sh.region(tokens.shape, tok_layout, sizes, coords)
            device = mesh.slot_at(tuple(coords[a] for a in
                                        mesh.axis_names)).device
            tok = tokens[reg[0][0]:reg[0][1]].to(device)
            positions = (None if mode == "prefill" else
                         decode_positions(pos, tok.shape[0], device))
            logits, new_cache = forward(p, cfg, tok, mode=mode, cache=c,
                                        positions=positions,
                                        cache_len=cache_len)
            return (logits[:, -1] if last else logits), new_cache

    out = mesh.run_spmd(run)
    parts = np.empty(mesh.devices.shape, dtype=object)
    for i in np.ndindex(mesh.devices.shape):
        parts[i] = out[i][0]
    b, t = tokens.shape
    vocab = _vocab_layout(cfg, mesh, rules)
    shape, layout = (((b, cfg.vocab), (tok_layout[0], vocab)) if last else
                     ((b, t, cfg.vocab), (tok_layout[0], (), vocab)))
    logits = sh.gather(sh.Sharded(parts, shape, layout, mesh))
    if mode == "decode":
        return logits, cache
    clen = max(cache_len or t, t)
    for i in np.ndindex(mesh.devices.shape):
        parts[i] = out[i][1]
    return logits, sh.assemble(parts, model_cache_specs(cfg, b, clen), mesh,
                               rules)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]
