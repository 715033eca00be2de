"""GQA self-attention with full-length and ring KV caches, and
cross-attention.

The port of the JAX package's ``models/attention.py`` for self-attention
and for the encoder-decoder's cross-attention (whisper).  Cache layout per
layer: {"k": (B, S, KV, Dh), "v": (B, S, KV, Dh), "pos": (B, S) int32
absolute positions (-1 = empty)}.  A *ring* cache is the same structure
with S = window; slot = pos % window.  Keys are stored post-RoPE (absolute
rotary), the standard serving convention.  Positions are (B, T), or
(3, B, T) for M-RoPE (qwen2-vl), whose temporal stream ``positions[0]``
does the masking and the cache bookkeeping, as in the JAX package.

* **Prefill and train** call ``ops.attention(q, k, v, causal=cfg.causal,
  window=cfg.window, softcap=cfg.softcap)``: the flash kernel on the card,
  ``ref.attention`` on the CPU.  This computes what the JAX package's
  ``_sdpa_full``, ``_sdpa_chunked`` and ``_sdpa_banded`` compute over the
  prompt: prefill
  positions are always the default ones (the model's ``forward`` takes no
  others whose temporal stream is not the index), so query and key
  position ``i`` is index ``i``, and the kernel's masks by index
  (``k <= q`` causal, ``k > q - window``) equal ``_mask`` over those
  positions, with no empty slots among the prompt's keys.  The kernel
  skips the key tiles outside a window's band, as ``_sdpa_banded`` skips
  its chunks.
* **Prefill's cache** (``_prefill_cache``), the JAX package's rule: with
  ``clen = cache_len_for(cfg, max(cache_len, T))`` below T (a window
  shorter than the prompt), the last ``clen`` positions, rolled so that
  slot = pos % clen (``_ring_tail``); else the prompt padded to ``clen``
  slots, which for a window shorter than ``cache_len`` is a ring that
  decode wraps.
* **Decode** (T = 1 against the padded or ring cache, empty slots pos =
  -1) stays a plain product over the whole cache (``_sdpa_full``), as in
  the JAX package, which computes it outside any Pallas kernel; the new
  key lands in slot pos % S, which wraps a ring.
* **The cache is written in place at decode**: ``_write_slot`` stores the
  new key, value and position into the caller's cache tensors, where the
  JAX package donates the cache to the decode step and gets a new one.
* **Cross-attention** (``cfg.cross``, ``_cross_attention``): queries from
  the decoder, keys and values projected from the encoder's hidden states
  (``enc_kv``, (B, S_enc, D)), no RoPE and no mask.  Prefill and train run
  ``ops.attention(q, k, v, causal=False, softcap=cfg.softcap)``, the flash
  kernel with T != S,
  where the JAX package runs ``_sdpa_full`` (every key position is valid);
  prefill caches the projected keys and values wholesale
  (``cross_cache_specs``).  Decode reads that cache through ``_sdpa_full``
  and never writes it.

* **qk-norm** (``cfg.qk_norm``, gemma3): q and k pass through ``rmsnorm``
  over the head dim (``q_norm``, ``k_norm``, shape (Dh,), ones at init) at
  its default eps of 1e-6, not ``cfg.norm_eps``, before RoPE, as in the
  JAX package; cross-attention normalises q only.
* **Softcap** (``cfg.softcap`` c, off when falsy): every path caps the
  scaled scores at c tanh(s/c) before the mask: the flash kernels given
  ``softcap``, decode's ``_sdpa_full`` in plain torch.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import AttnCfg
from repro_torch.dist.sharding import (TensorSpec, constrain, ctx_axis_size,
                                       tspec)
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rmsnorm

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Parameter / cache specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: AttnCfg, d_model: int) -> dict[str, TensorSpec]:
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.head_dim
    s = {
        "wq": tspec((d_model, h, dh), ("embed", "heads", "head_dim")),
        "wk": tspec((d_model, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wv": tspec((d_model, kv, dh), ("embed", "kv_heads", "head_dim")),
        "wo": tspec((h, dh, d_model), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = tspec((dh,), ("head_dim",), init="ones")
        s["k_norm"] = tspec((dh,), ("head_dim",), init="ones")
    return s


def attn_cache_specs(cfg: AttnCfg, batch: int, cache_len: int,
                     dtype=torch.bfloat16) -> dict[str, TensorSpec]:
    kv, dh = cfg.n_kv, cfg.head_dim
    axes = ("batch", "kv_seq", "act_kv_heads", "head_dim")
    return {
        "k": tspec((batch, cache_len, kv, dh), axes, dtype, init="zeros"),
        "v": tspec((batch, cache_len, kv, dh), axes, dtype, init="zeros"),
        "pos": tspec((batch, cache_len), ("batch", "kv_seq"), torch.int32,
                     init="zeros"),
    }


def cross_cache_specs(cfg: AttnCfg, batch: int, enc_len: int,
                      dtype=torch.bfloat16) -> dict[str, TensorSpec]:
    return attn_cache_specs(cfg, batch, enc_len, dtype)


def cache_len_for(cfg: AttnCfg, seq_len: int) -> int:
    if cfg.window is not None and seq_len > cfg.window:
        return cfg.window
    return seq_len


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,T,D) @ w (D,H,Dh) -> (B,T,H,Dh), contiguous."""
    b, t, _ = x.shape
    return (x @ w.to(x.dtype).reshape(w.shape[0], -1)).view(
        b, t, w.shape[1], w.shape[2])


def _project(params, x, cfg: AttnCfg, positions):
    """x (B,T,D) -> q (B,T,H,Dh), k,v (B,T,KV,Dh); qk-norm (if set), then
    rope applied."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_section)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_section)
    return q, k, v


def _mask(q_pos, k_pos, cfg: AttnCfg):
    """(..., T, S) boolean validity from absolute positions."""
    m = k_pos[..., None, :] >= 0
    if cfg.causal and not cfg.cross:
        m = m & (k_pos[..., None, :] <= q_pos[..., :, None])
    if cfg.window is not None and not cfg.cross:
        m = m & (k_pos[..., None, :] > q_pos[..., :, None] - cfg.window)
    return m


def _sdpa_full(q, k, v, q_pos, k_pos, cfg: AttnCfg):
    """Materialized-scores attention. q (B,T,H,Dh), k/v (B,S,KV,Dh)."""
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    rep = h // kvh
    qg = q.reshape(b, t, kvh, rep, dh)
    scores = torch.einsum("btgrk,bsgk->bgrts", qg, k).float()
    scores = scores / math.sqrt(dh)
    if cfg.softcap:
        scores = torch.tanh(scores / cfg.softcap) * cfg.softcap
    mask = _mask(q_pos, k_pos, cfg)[:, None, None]        # (B,1,1,T,S)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrts,bsgk->btgrk", w, v)
    return out.reshape(b, t, h, dh)


# ---------------------------------------------------------------------------
# Layer-level entry point
# ---------------------------------------------------------------------------


def attention(params, x, cfg: AttnCfg, *, positions, mode: str,
              cache: Optional[dict], enc_kv=None,
              cache_len: Optional[int] = None):
    """Returns (out (B,T,D), new_cache).

    mode='train'   : no cache.
    mode='prefill' : builds the cache (a ring of the last ``window``
                     positions when the window is shorter than the
                     prompt) with capacity ``cache_len`` (>= T; empty
                     slots pos=-1) so decode steps append.
    mode='decode'  : T == 1; writes the cache IN PLACE at ``positions``
                     (B,1) or (3,B,1), slot pos % S, and returns it.
    Cross-attention (cfg.cross): keys/values come from ``enc_kv``, the
    encoder's hidden states (B, S_enc, D), cached wholesale at prefill and
    read, not written, at decode.
    """
    if cfg.cross:
        return _cross_attention(params, x, cfg, cache=cache, enc_kv=enc_kv,
                                mode=mode)
    b, t, _ = x.shape
    q, k, v = _project(params, x, cfg, positions)
    # The JAX package's tensor-parallel choice: heads over "model" where
    # they divide it, else (gemma3-4b's 8 heads on a 16-wide axis) the
    # query sequence over "model" instead of the attention replicated
    heads_tp = cfg.n_heads % ctx_axis_size("model") == 0
    q_axes = (("batch", "seq", "act_heads", "head_dim") if heads_tp
              else ("batch", "act_seq_tp", "act_heads", "head_dim"))
    q = constrain(q, q_axes, weight=params["wq"])
    k = constrain(k, ("batch", "seq", "act_kv_heads", "head_dim"),
                  weight=params["wk"])
    # masking and cache bookkeeping use the temporal stream for M-RoPE
    mask_pos = positions[0] if positions.dim() == 3 else positions

    if mode == "decode":
        if cache is None or t != 1:
            raise ValueError("attention: decode takes T == 1 and a cache")
        slot = mask_pos[:, 0].long() % cache["k"].shape[1]   # ring or full
        _write_slot(cache["k"], k[:, 0], slot)
        _write_slot(cache["v"], v[:, 0], slot)
        _write_slot(cache["pos"], mask_pos[:, 0], slot)
        new_cache = cache
        out = _sdpa_full(q, cache["k"], cache["v"], mask_pos, cache["pos"],
                         cfg)
    else:
        new_cache = None
        if mode == "prefill":
            new_cache = _prefill_cache(
                k, v, mask_pos, cache_len_for(cfg, max(cache_len or t, t)))
        out = ops.attention(q, k, v, causal=cfg.causal, window=cfg.window,
                            softcap=cfg.softcap)

    wo = params["wo"]
    out = out.reshape(b, t, -1) @ wo.to(x.dtype).reshape(-1, wo.shape[-1])
    out = constrain(out, ("batch", "seq", "act_embed"), weight=wo)
    return out, new_cache


def _prefill_cache(k, v, pos, clen: int) -> dict:
    """The cache prefill leaves, of ``clen`` slots: a ring of the last
    ``clen`` positions where the prompt is longer, else the prompt padded
    (empty slots pos = -1)."""
    t = k.shape[1]
    if clen < t:
        return {"k": _ring_tail(k, clen), "v": _ring_tail(v, clen),
                "pos": _ring_tail(pos.to(torch.int32), clen)}
    pad = clen - t
    return {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
            "v": F.pad(v, (0, 0, 0, 0, 0, pad)),
            "pos": F.pad(pos.to(torch.int32), (0, pad), value=-1)}


def _ring_tail(arr, clen: int):
    """The last ``clen`` positions of (B, T, ...), laid out so that
    absolute position p sits at slot p % clen (contiguous)."""
    t = arr.shape[1]
    return torch.roll(arr[:, t - clen:], shifts=(t - clen) % clen, dims=1)


def _write_slot(buf, val, slot):
    """buf (B,S,...) <- val (B,...) at per-batch slot (B,), in place."""
    bidx = torch.arange(buf.shape[0], device=buf.device)
    buf[bidx, slot] = val.to(buf.dtype)


def _cross_attention(params, x, cfg: AttnCfg, *, cache, enc_kv, mode):
    b, t, _ = x.shape
    q = _proj(x, params["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
    if mode == "decode":
        new_cache = cache
        q_pos = torch.zeros((b, t), dtype=torch.int32, device=x.device)
        out = _sdpa_full(q, cache["k"], cache["v"], q_pos, cache["pos"], cfg)
    else:
        if enc_kv is None:
            raise ValueError("cross-attention needs the encoder's hidden "
                             "states (enc_kv)")
        k = _proj(enc_kv, params["wk"])
        v = _proj(enc_kv, params["wv"])
        new_cache = None
        if mode == "prefill":
            kp = torch.arange(k.shape[1], dtype=torch.int32,
                              device=x.device)[None].expand(b, -1)
            new_cache = {"k": k, "v": v, "pos": kp.contiguous()}
        out = ops.attention(q, k, v, causal=False, softcap=cfg.softcap)
    wo = params["wo"]
    out = out.reshape(b, t, -1) @ wo.to(x.dtype).reshape(-1, wo.shape[-1])
    return out, new_cache
