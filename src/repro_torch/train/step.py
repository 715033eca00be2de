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

import torch

from repro_torch.configs.base import ModelCfg, ShapeCfg
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
    tensors on the state's device.  ``mesh`` is taken for the JAX
    package's signature; the port's parameters live on one device."""
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
                      max_len: int | None = None):
    """max_len: KV-cache capacity for subsequent decode steps (defaults to
    the prompt length — pass prompt+generation budget when serving)."""
    def prefill_step(params, batch):
        inputs, kw = _inputs(cfg, batch)
        with torch.no_grad():
            logits, cache = forward(params, cfg, inputs, mode="prefill",
                                    cache_len=max_len, **kw)
            return logits[:, -1], cache

    return prefill_step


def make_decode_step(cfg: ModelCfg, step_cfg: StepCfg = StepCfg()):
    def decode_step(params, cache, batch):
        with torch.no_grad():
            tokens = batch["tokens"][:, None]                 # (B,1)
            pos = decode_positions(batch["pos"], tokens.shape[0],
                                   tokens.device, cfg.mrope)
            logits, cache = forward(params, cfg, tokens, mode="decode",
                                    cache=cache, positions=pos)
            return logits[:, 0], cache

    return decode_step
