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

* **Sharded** (inside a slot's context, ``dist.sharding.slot_ctx``): q,
  k and v are column-parallel over the heads, and the flash kernel runs
  on the slot's heads at their local shape; ``wo`` is row-parallel, its
  partial sums all-reduced at its ``constrain``.  Prefill writes the cache
  in its ``resolve_pspec`` layout (``_slot_prefill_cache``: split by
  sequence where "kv_seq" takes an axis, by heads where
  "act_kv_heads" does); decode writes the new row on the slot holding its
  slot index and, on a cache split by sequence, combines each slot's
  partial softmax (``_slot_decode``, split-KV).

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
from repro_torch.dist import sharding as sh
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
        new_cache = cache
        if sh.in_slot():
            out = _slot_decode(params, q, k, v, mask_pos, cache, cfg)
        else:
            slot = mask_pos[:, 0].long() % cache["k"].shape[1]  # ring/full
            _write_slot(cache["k"], k[:, 0], slot)
            _write_slot(cache["v"], v[:, 0], slot)
            _write_slot(cache["pos"], mask_pos[:, 0], slot)
            out = _sdpa_full(q, cache["k"], cache["v"], mask_pos,
                             cache["pos"], cfg)
    else:
        new_cache = None
        if mode == "prefill":
            clen = cache_len_for(cfg, max(cache_len or t, t))
            new_cache = (_slot_prefill_cache(params, k, v, mask_pos, clen,
                                             cfg) if sh.in_slot()
                         else _prefill_cache(k, v, mask_pos, clen))
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


def _write_slot(buf, val, slot, owned=None):
    """buf (B,S,...) <- val (B,...) at per-batch slot (B,), in place;
    with ``owned`` (B,), only in the rows where it is set (the others keep
    what the slot held)."""
    bidx = torch.arange(buf.shape[0], device=buf.device)
    val = val.to(buf.dtype)
    if owned is not None:
        mask = owned.view(-1, *([1] * (val.dim() - 1)))
        val = torch.where(mask, val, buf[bidx, slot])
    buf[bidx, slot] = val


# ---------------------------------------------------------------------------
# Sharded (a slot's part, inside dist.sharding.slot_ctx)
# ---------------------------------------------------------------------------


def _slot_layouts(params) -> tuple[tuple, tuple]:
    """The layouts of the slot's q (B,T,H,Dh) and k, v (B,T,KV,Dh): the
    batch as the activations split it, the heads as wq and wk do."""
    b = sh.batch_axes()
    return ((b, (), sh.slot_layout(params["wq"])[1], ()),
            (b, (), sh.slot_layout(params["wk"])[1], ()))


def _slot_prefill_cache(params, k, v, pos, clen: int, cfg: AttnCfg) -> dict:
    """The prefill cache in its ``resolve_pspec`` layout: the slot's heads
    padded to ``clen`` slots, then resharded; where the layout splits the
    sequence, the heads' parts go all-to-all into sequence parts."""
    if clen < k.shape[1]:
        raise NotImplementedError("sharded serving: a ring cache")
    _, kv_have = _slot_layouts(params)
    local = _prefill_cache(k, v, pos, clen)
    batch = sh.slot_whole_shape(k.shape, kv_have)[0]
    specs = attn_cache_specs(cfg, batch, clen)
    names = ("k", "v", "pos")
    return dict(zip(names, sh.reshard_many([
        (local[n], kv_have[:local[n].dim()], sh.spec_layout(specs[n]))
        for n in names])))


def _slot_decode(params, q, k, v, mask_pos, cache, cfg: AttnCfg):
    """One decode step on the slot's part of the cache: the new key,
    value and position land on the slot that holds slot index pos % S of
    the row; where the cache is split by heads as the slot's q is, the
    attention is the slot's own (``_sdpa_full``); where it is split by
    sequence, split-KV: q resharded to the cache's batch and heads, each
    slot's partial softmax over its keys, the maxima, sums and outputs
    combined over the sequence's axes in slot order, and the result
    resharded back to the slot's heads for ``wo``."""
    q_have, kv_have = _slot_layouts(params)
    lay = sh.slot_layout(cache["k"])
    whole = sh.slot_whole_shape(cache["k"].shape, lay)
    row = (lay[0], (), lay[2], ())
    p_row, k_row, v_row, qc = sh.reshard_many([
        (mask_pos, kv_have[:2], row[:2]), (k, kv_have, row),
        (v, kv_have, row), (q, q_have, row)])
    s0, s1 = sh.slot_region(whole, lay)[1]
    slot = p_row[:, 0].long() % whole[1]
    owned = (slot >= s0) & (slot < s1)
    local = (slot - s0).clamp(0, s1 - s0 - 1)
    _write_slot(cache["k"], k_row[:, 0], local, owned)
    _write_slot(cache["v"], v_row[:, 0], local, owned)
    _write_slot(cache["pos"], p_row[:, 0], local, owned)
    if lay[1] == () and row == q_have:
        return _sdpa_full(q, cache["k"], cache["v"], mask_pos, cache["pos"],
                          cfg)
    o, m, l = _sdpa_partial(qc, cache["k"], cache["v"], p_row, cache["pos"],
                            cfg)
    if lay[1]:
        parts = sh.all_gather(
            torch.cat([o, m[..., None], l[..., None]], dim=-1), lay[1])
        mx = parts[0][..., -2]
        for p in parts[1:]:
            mx = torch.maximum(mx, p[..., -2])
        o = l = 0
        for p in parts:
            w = torch.exp(p[..., -2] - mx)
            o = o + p[..., :-2] * w[..., None]
            l = l + p[..., -1] * w
    out = (o / l[..., None]).to(q.dtype)
    return sh.reshard_many([(out, row, q_have)])[0]


def _sdpa_partial(q, k, v, q_pos, k_pos, cfg: AttnCfg):
    """``_sdpa_full``'s softmax over a part of the keys, unnormalised:
    (the float32 output sum (B,T,H,Dh), the row maximum (B,T,H), the row
    sum (B,T,H))."""
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, dh)
    scores = torch.einsum("btgrk,bsgk->bgrts", qg, k).float()
    scores = scores / math.sqrt(dh)
    if cfg.softcap:
        scores = torch.tanh(scores / cfg.softcap) * cfg.softcap
    mask = _mask(q_pos, k_pos, cfg)[:, None, None]        # (B,1,1,T,S)
    scores = torch.where(mask, scores, NEG_INF)
    mx = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - mx)
    out = torch.einsum("bgrts,bsgk->btgrk", p, v.float()).reshape(b, t, h, dh)

    def heads(x):                                         # (B,G,R,T) ->
        return x.permute(0, 3, 1, 2).reshape(b, t, h)     # (B,T,H)
    return out, heads(mx[..., 0]), heads(p.sum(-1))


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
