"""Top-level models: decoder-only LM and encoder-decoder (whisper).

The port of the JAX package's ``models/model.py``.  Pure-function API over
parameter trees (nested dicts of tensors, the JAX package's paths and
layouts):

  model_specs(cfg)                        -> param spec tree (no allocation)
  model_cache_specs(cfg, batch, S, S_enc) -> KV/SSM cache spec tree
  encode(params, cfg, enc_inputs)         -> the encoder's hidden states
  forward(params, cfg, inputs, ...)       -> logits (+ cache for
                                             prefill/decode)

An encoder-decoder (``cfg.encoder``, whisper) runs its encoder stack over
frame embeddings (B, S_enc, D) in train mode at default positions,
non-causal, then the decoder with cross-attention over the result;
``forward`` also takes embeddings (B, T, D) as its inputs, for the models
fed by a stub frontend (``cfg.embed_inputs`` False: qwen2-vl's patch
embeddings).  An M-RoPE model (qwen2-vl, ``cfg.mrope``) runs on (3, B, T)
positions, one stream each for time, height and width: the defaults
repeat the index in all three, and train and prefill also take streams
of the caller's whose temporal stream is the index.

``LM`` is the same model as an ``nn.Module`` that owns the tree as
parameters under the tree's paths.  ``params_from_numpy`` carries a JAX
parameter tree across (a copy, no transposes) and ``params_to_numpy``
carries one back; ``cache_from_numpy`` and
``cache_to_numpy`` do the same for caches, ``train_state_from_numpy`` and
``train_state_to_numpy`` for train states ``{params, m, v, step}``.

``draw_params`` draws a parameter tree from a counter-based hash
(``hashed_uniform``): each value is a function of (seed, leaf index in the
JAX flattening order, element index) alone, so a numpy twin of the hash
draws the same bits on a host without torch, and a leaf can be drawn
slice by slice on any device.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelCfg
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import TensorSpec, constrain
from repro_torch.models.common import (default_positions, embed_spec,
                                       embed_tokens, rmsnorm, rmsnorm_spec,
                                       unembed_spec)
from repro_torch.models.stack import (apply_stack, stack_cache_specs,
                                      stack_specs)


def model_specs(cfg: ModelCfg) -> dict[str, Any]:
    d = cfg.d_model
    s: dict[str, Any] = {
        "embed": embed_spec(cfg.vocab, d),
        "stack": stack_specs(cfg.stack, d),
        "final_norm": rmsnorm_spec(d),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = unembed_spec(d, cfg.vocab)
    if cfg.encoder is not None:
        s["encoder"] = stack_specs(cfg.encoder, d)
        s["enc_norm"] = rmsnorm_spec(d)
    return s


def model_cache_specs(cfg: ModelCfg, batch: int, seq_len: int,
                      enc_len: int | None = None,
                      dtype=torch.bfloat16) -> dict[str, Any]:
    return stack_cache_specs(cfg.stack, cfg.d_model, batch, seq_len,
                             enc_len, dtype)


def encode(params, cfg: ModelCfg, enc_inputs, *, remat: str = "none"):
    """Encoder forward (whisper): enc_inputs (B, S_enc, D) stub frame
    embeddings -> the normed hidden states (B, S_enc, D) in the compute
    dtype."""
    x = enc_inputs.to(cfg.compute_dtype)
    b, s, _ = x.shape
    aux = {"positions": default_positions(b, s, x.device), "enc": None}
    x, _ = apply_stack(params["encoder"], x, cfg.encoder, mode="train",
                       cache=None, aux=aux, eps=cfg.norm_eps, remat=remat)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def lm_head(params, cfg: ModelCfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _slot_head(params, cfg: ModelCfg):
    """A slot's part of the head, gathered over "data": the tied head
    ``embed.T`` splits the vocabulary as the table does, so the logits
    come out split over it ("act_vocab")."""
    if not cfg.tie_embeddings:
        return sh.gather_tree(params["lm_head"], "data")
    table = sh.gather_tree(params["embed"], "data")
    return sh.register(table.T, sh.slot_layout(table)[::-1])


def forward(params, cfg: ModelCfg, inputs, *, mode: str = "train",
            cache=None, positions=None, enc_inputs=None,
            cache_len: Optional[int] = None, remat: str = "none",
            return_hidden: bool = False):
    """inputs: tokens (B,T) int, or embeddings (B,T,D) (the stub frontends
    of models with ``cfg.embed_inputs`` False) in train/prefill;
    ``enc_inputs`` (B,S_enc,D), the encoder's frame embeddings, for an
    encoder-decoder in train/prefill (decode reads the cross caches
    instead).  Returns float32 logits (B,T,V) for train; (logits, cache)
    for prefill/decode.  ``return_hidden`` returns the final-normed hidden
    states (B,T,D) in the compute dtype instead of the logits (the chunked
    training loss applies the head itself); ``remat`` ("none" | "full" |
    "dots") checkpoints each group in train mode, the encoder's too
    (``stack.apply_stack``).  (The JAX package's ``logits_f32`` has no
    counterpart: logits are always float32.)

    Train and prefill run at ``default_positions`` (the attention kernel
    masks by index): they take no ``positions``, except (3,B,T) M-RoPE
    streams whose temporal stream ``positions[0]`` is the index (the
    height and width streams only rotate q and k); any other positions
    raise ``ValueError``.  Decode takes (B,1) positions, (3,B,1) for
    M-RoPE (``decode_positions``), and updates ``cache`` in place."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"forward: unknown mode {mode!r}")
    dt = cfg.compute_dtype
    if inputs.dim() == 2:  # token ids
        scale = math.sqrt(cfg.d_model) if cfg.embed_scale else None
        x = embed_tokens(params["embed"], inputs, scale, dt)
    else:
        x = inputs.to(dt)
        if cfg.embed_scale:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt,
                                 device=x.device)
    x = constrain(x, ("batch", "seq", "act_embed"))
    b, t = x.shape[:2]

    mrope = cfg.mrope
    if mode == "decode":
        if positions is None:
            raise ValueError("forward: decode needs (B,1) positions "
                             "((3,B,1) for M-RoPE)")
    elif positions is None:
        positions = default_positions(b, t, x.device, mrope)
    elif not (mrope and tuple(positions.shape) == (3, b, t) and torch.equal(
            positions[0].to(torch.int32),
            default_positions(b, t, positions.device))):
        raise ValueError("forward: train and prefill run at default "
                         "positions (for M-RoPE, any (3,B,T) streams whose "
                         "temporal stream is the index)")

    enc = None
    if cfg.encoder is not None and mode != "decode":
        if enc_inputs is None:
            raise ValueError("forward: an encoder-decoder model needs "
                             "encoder inputs")
        enc = encode(params, cfg, enc_inputs, remat=remat)

    aux = {"positions": positions, "enc": enc, "cache_len": cache_len}
    x, new_cache = apply_stack(params["stack"], x, cfg.stack, mode=mode,
                               cache=cache, aux=aux, eps=cfg.norm_eps,
                               remat=remat)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if return_hidden:
        return x if mode == "train" else (x, new_cache)
    head = _slot_head(params, cfg) if sh.in_slot() else lm_head(params, cfg)
    logits = x @ head.to(dt)
    logits = constrain(logits, ("batch", "seq", "act_vocab"),
                       weight=head).float()
    if mode == "train":
        return logits
    return logits, new_cache


def decode_positions(pos, batch: int, device=None,
                     mrope: bool = False) -> torch.Tensor:
    """pos: scalar int, or a 0-d integer tensor -> (B,1) int32 positions,
    or (3,B,1) for M-RoPE (text tokens: the same position in every
    stream).  A tensor is broadcast on its device, never read on the host
    (the dry-run traces decode on the meta device)."""
    if torch.is_tensor(pos):
        p = pos.to(device=device, dtype=torch.int32).reshape(1, 1).expand(
            batch, 1).contiguous()
    else:
        p = torch.full((batch, 1), int(pos), dtype=torch.int32,
                       device=device)
    return p[None].expand(3, batch, 1) if mrope else p


# ---------------------------------------------------------------------------
# The model as an nn.Module, and trees carried across from numpy
# ---------------------------------------------------------------------------


class _Node(nn.Module):
    """One dict of the parameter tree: tensors as parameters, sub-dicts as
    child modules, so ``named_parameters()`` yields the tree's paths."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Node(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        out: dict[str, Any] = dict(self._parameters)
        for k, m in self._modules.items():
            out[k] = m.tree()
        return out


class LM(_Node):
    """The LM (decoder-only or encoder-decoder): owns ``params`` (a tree
    from ``init_params`` or ``params_from_numpy``) as parameters under the
    tree's paths, e.g.
    ``stack.groups.p0.attn.wq``.  Parameters take no gradients by default:
    serving needs none, and training differentiates the parameter tree
    itself, as the JAX package does (``train.step.make_train_step`` works
    on ``{params, m, v, step}``, not on a module)."""

    def __init__(self, cfg: ModelCfg, params: dict):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, inputs, *, mode: str = "train", cache=None,
                positions=None, enc_inputs=None,
                cache_len: Optional[int] = None):
        return forward(self.tree(), self.cfg, inputs, mode=mode, cache=cache,
                       positions=positions, enc_inputs=enc_inputs,
                       cache_len=cache_len)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _from_numpy(a, device) -> torch.Tensor:
    """One numpy array -> a tensor on ``device``; bfloat16 arrays
    (ml_dtypes, as JAX hands them out) travel as float32, exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device, dtype=None) -> dict:
    """A JAX parameter tree as nested dicts of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, init_params(model_specs(cfg), key))``) ->
    the port's tree on ``device``: same paths and layouts, values copied.
    ``dtype`` casts floating leaves."""
    def one(a):
        t = _from_numpy(a, device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return _tree_map(one, tree)


def cache_from_numpy(tree, device) -> dict:
    """A cache tree of numpy arrays -> tensors on ``device``."""
    return _tree_map(lambda a: _from_numpy(a, device), tree)


def train_state_from_numpy(state, device) -> dict:
    """A JAX train state ``{params, m, v, step}`` of numpy arrays (e.g.
    ``jax.tree.map(np.asarray, init_train_state(...))``) -> the port's on
    ``device``: every leaf copied with its dtype (bfloat16 moments stay
    bfloat16), ``step`` a 0-d int32 tensor."""
    return _tree_map(lambda a: _from_numpy(a, device), state)


def params_to_numpy(tree) -> dict:
    """The port's parameter tree (any tree of tensors) -> numpy arrays the
    JAX package takes, the same paths and layouts: bfloat16 leaves as
    ml_dtypes bfloat16 (the same bits)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return _tree_map(one, tree)


def train_state_to_numpy(state) -> dict:
    """The port's train state -> numpy arrays the JAX package takes:
    bfloat16 leaves as ml_dtypes bfloat16 (the same bits)."""
    return params_to_numpy(state)


def cache_to_numpy(tree) -> dict:
    """A cache tree of tensors -> numpy arrays; bfloat16 as float32."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _tree_map(one, tree)


# ---------------------------------------------------------------------------
# Counter-based draws (the same bits from numpy and from torch on any device)
# ---------------------------------------------------------------------------

HASH_P = 2_147_483_647          # 2^31 - 1: every value stays below 2^31
_HASH_STEPS = ((1_103_515_245, 12_345, 15), (48_271, 0, 13),
               (69_621, 1, 16))
_DRAW_SLICE = 1 << 24           # values drawn at a time


def hash_mix(x):
    """int64 values in [0, 2^31) -> int64 values in [0, 2^31): three rounds
    of a multiply-add modulo 2^31 - 1 and an xor-shift.  No product passes
    2^62, so the int64 arithmetic never overflows, and numpy arrays, torch
    tensors and Python ints give the same values."""
    for mul, add, shift in _HASH_STEPS:
        x = (x * mul + add) % HASH_P
        x = x ^ (x >> shift)
    return x


def hash_key(seed: int, leaf: int) -> int:
    """The key of one leaf (or one stream) of one seed."""
    return hash_mix(hash_mix(seed % HASH_P) ^ (leaf % HASH_P))


def hash_ints(seed: int, leaf: int, start: int, count: int,
              device=None) -> torch.Tensor:
    """(count,) int64 hashes in [0, 2^31) of elements start .. start+count
    of stream ``leaf`` of ``seed``."""
    e = torch.arange(start, start + count, dtype=torch.int64, device=device)
    return hash_mix(hash_mix((e % HASH_P) ^ hash_key(seed, leaf))
                    ^ (e // HASH_P))


def hashed_uniform(seed: int, leaf: int, start: int, count: int,
                   device=None) -> torch.Tensor:
    """(count,) float64 values, uniform on (-1, 1), of elements start ..
    start+count of stream ``leaf``: (2h + 1) / 2^31 - 1, exact in float64."""
    h = hash_ints(seed, leaf, start, count, device)
    return (h * 2 + 1).double() / float(1 << 31) - 1.0


def fan_in(spec: TensorSpec) -> int:
    """The fan-in of a weight: its first axis past the stacking ("layers")
    and expert axes, times the head dim where that axis is the heads of an
    output projection ((heads, head_dim, embed)).  (The JAX package's
    ``init_params`` takes the leading axis, which for a stacked leaf is
    the number of groups.)"""
    i = 0
    while i < len(spec.shape) - 1 and spec.axes[i] in ("layers", "expert"):
        i += 1
    n = spec.shape[i] if spec.shape else 1
    if i + 1 < len(spec.shape) - 1 and spec.axes[i + 1] == "head_dim":
        n *= spec.shape[i + 1]
    return n


def draw_recipe(spec: TensorSpec) -> tuple[float, float]:
    """(offset, half-width) of a leaf's uniform draw, value = offset +
    half-width * u: the JAX package's recipes at their standard deviation
    (embed 0.5 d^-1/2, normal at ``spec.scale`` or fan-in^-1/2), with
    zeros drawn as 0.1 u and ones as 1 + 0.1 u so that no path sees a
    constant."""
    if spec.init == "zeros":
        return 0.0, 0.1
    if spec.init == "ones":
        return 1.0, 0.1
    if spec.init == "embed":
        std = 0.5 * spec.shape[-1] ** -0.5
    elif spec.scale is not None:
        std = spec.scale
    else:
        std = fan_in(spec) ** -0.5
    return 0.0, std * math.sqrt(3.0)


def draw_leaf(spec: TensorSpec, seed: int, leaf: int, device=None,
              start: int = 0, count: int | None = None) -> torch.Tensor:
    """Elements start .. start+count of one leaf, flat, drawn by
    ``hashed_uniform`` and ``draw_recipe``: float64 offset + half * u,
    rounded once to float32, in the spec's dtype."""
    count = spec.size - start if count is None else count
    offset, half = draw_recipe(spec)
    out = torch.empty(count, dtype=spec.dtype, device=device)
    for s0 in range(0, count, _DRAW_SLICE):
        n = min(_DRAW_SLICE, count - s0)
        v = hashed_uniform(seed, leaf, start + s0, n, device) * half
        if offset:
            v = v + offset
        out[s0:s0 + n] = v.float()
    return out


def draw_params(specs, seed: int, device=None) -> dict:
    """A parameter tree from a TensorSpec tree (``model_specs``), each leaf
    drawn by ``draw_leaf`` under its index in the JAX package's flattening
    order (dict keys sorted)."""
    counter = iter(range(1 << 30))

    def walk(node):
        if isinstance(node, dict):   # sorted: the JAX flattening order
            return {k: walk(node[k]) for k in sorted(node)}
        return draw_leaf(node, seed, next(counter), device).view(node.shape)
    return walk(specs)
