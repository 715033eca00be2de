"""Selective state-space layers: Mamba1 (falcon-mamba) and Mamba2 (zamba2).

The port of the JAX package's ``models/mamba.py``.  Mamba1:

* **Prefill and train** (no cache: the state starts at zero) run the
  recurrence through ``ops.selective_scan``: the fused CUDA kernel on the
  card, ``ref.selective_scan`` on the CPU.  This replaces the JAX package's
  chunked associative scan; both compute h_t = exp(delta_t A) h_{t-1} +
  delta_t B_t x_t, y_t = sum_N(h_t C_t) from h_0 = 0.
* **Decode** stays the plain one-step recurrence, and writes the conv tail
  and the state into the caller's cache IN PLACE (the JAX package donates
  the cache to the decode step instead).

Sharded (inside a slot's context, ``dist.sharding.slot_ctx``), Mamba1
runs on the slot's range of d_inner channels: ``in_proj`` is split over
"model" in contiguous ranges of its 2 d_inner columns, so its output is
exchanged all-to-all (``_pair_halves``) until each slot holds xa and z of
its own channels; ``x_proj`` sums over the channels, and dt_r, B and C are
all-reduced (the JAX package has no ``constrain`` there; XLA adds the
reduction); ``dt_proj`` is column-parallel, the scan runs on the slot's
channels, ``out_proj`` is row-parallel and the decode state and conv tail
stay the slot's.

Mamba2 (the SSD form: a scalar decay a head) runs in plain torch, as the
JAX package runs it in plain jnp: train and prefill cut the sequence into
chunks of ``_chunk_len(T, cfg.chunk)`` steps, each chunk an intra-chunk
quadratic term plus the carried (B, H, P, N) state's term; decode is the
one-step recurrence, written into the caller's cache in place.  Where the
JAX package scans the chunks one after another, the port computes a
slab of chunks' quadratic terms and their states from zero at once and
carries only the states across the chunks in order (``_ssd``): the same
sums, a few dozen launches a slab instead of a few dozen a chunk.  A slab
holds at most ``_SLAB_ELEMS`` values of a (B, chunks, Tc, Tc, H) tensor,
so the transient memory stays bounded however long the batch.  Two
deliberate differences from the JAX package:

* **The decay matrix.**  L[i, j] = exp(cum_i - cum_j) for j <= i, else 0.
  The JAX package computes ``where(tri, exp(li), 0)``: for j > i, li is
  the decay summed the wrong way, positive, and at a chunk of 128 steps
  (A = -1, delta ~ 0.8) it reaches ~100, where exp overflows float32.  The
  forward discards those entries, but the backward multiplies their zero
  cotangent by inf: NaN gradients.  The port computes
  ``exp(where(tri, li, -inf))``: the same forward bit for bit, finite
  gradients.
* **The contractions** ``"bij,bijh,bjhp->bihp"`` run as a product of the
  first two (B, Tc, Tc, H), then one batched matmul, so no
  (B, Tc, Tc, H, P) tensor forms; every three-operand contraction is
  written as such two steps.

In train mode (with grad) each slab runs under
``torch.utils.checkpoint``, the counterpart of the JAX package's
``jax.checkpoint`` of the chunk body: the backward recomputes the
(Tc, Tc, H) tensors instead of keeping them for every chunk and layer.

The depthwise causal conv stays a sum of shifted products, as in the JAX
package, so nothing goes through cuDNN.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import Mamba1Cfg, Mamba2Cfg
from repro_torch.dist import sharding as sh
from repro_torch.dist.sharding import TensorSpec, constrain, tspec
from repro_torch.kernels import ops
from repro_torch.models.common import rmsnorm


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
    xz = constrain(xz, ("batch", "seq", "ssm_inner"),
                   weight=params["in_proj"])
    if sh.in_slot():
        xz = _pair_halves(xz, sh.slot_layout(params["in_proj"])[1])
        di = xz.shape[-1] // 2
    xa, z = xz[..., :di], xz[..., di:]

    conv_tail = cache["conv"] if cache is not None else None
    xa_raw = xa
    xa = F.silu(causal_conv(xa, params["conv_w"], params["conv_b"],
                            conv_tail))

    dbc = sh.reduce_partials(xa @ params["x_proj"].to(dt_),
                             params["x_proj"])
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
    out = y @ params["out_proj"].to(dt_)
    return constrain(out, ("batch", "seq", "act_embed"),
                     weight=params["out_proj"]), new_cache


def _pair_halves(xz, axes: tuple):
    """A slot's columns of the fused projection (xa | z), split over
    ``axes`` in contiguous ranges of the 2 d_inner columns, exchanged
    all-to-all so that the slot holds xa and z of one channel range, its
    range of the "ssm_inner" leaves (conv, dt, A, D, out_proj): slot j of
    n gets columns [j c, (j+1) c) and [d + j c, d + (j+1) c), c = d / n.
    The leaf's layout stays ``resolve_pspec``'s."""
    if not axes:
        return xz
    k, n = sh.slot_index(axes)
    width = xz.shape[-1]
    d, c = width * n // 2, width * n // (2 * n)
    lo = k * width

    def piece(j):
        parts = [xz[..., max(a, lo) - lo:min(b, lo + width) - lo]
                 for a, b in ((j * c, (j + 1) * c),
                              (d + j * c, d + (j + 1) * c))
                 if max(a, lo) < min(b, lo + width)]
        return (torch.cat(parts, dim=-1) if parts
                else xz[..., :0]).contiguous()

    got = sh.all_to_all([piece(j) for j in range(n)], axes)
    return torch.cat(got, dim=-1)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


def mamba2_specs(cfg: Mamba2Cfg, d_model: int) -> dict[str, TensorSpec]:
    di, n, p, w = cfg.d_inner, cfg.d_state, cfg.head_dim, cfg.conv_width
    h = di // p
    conv_dim = di + 2 * n
    return {
        "in_proj": tspec((d_model, 2 * di + 2 * n + h),
                         ("embed", "ssm_inner")),
        "conv_w": tspec((w, conv_dim), (None, "conv_dim"), scale=0.2),
        "conv_b": tspec((conv_dim,), ("conv_dim",), init="zeros"),
        "A_log": tspec((h,), ("ssm_heads",), init="zeros"),
        "dt_bias": tspec((h,), ("ssm_heads",), init="zeros"),
        "D": tspec((h,), ("ssm_heads",), init="ones"),
        "norm": tspec((di,), ("ssm_inner",), init="ones"),
        "out_proj": tspec((di, d_model), ("ssm_inner", "embed")),
    }


def mamba2_cache_specs(cfg: Mamba2Cfg, d_model: int, batch: int,
                       dtype=torch.bfloat16) -> dict[str, TensorSpec]:
    di, n, p, w = cfg.d_inner, cfg.d_state, cfg.head_dim, cfg.conv_width
    h = di // p
    return {
        "conv": tspec((batch, w - 1, di + 2 * n), ("batch", None, "conv_dim"),
                      dtype, init="zeros"),
        "state": tspec((batch, h, p, n),
                       ("batch", "ssm_heads", None, "ssm_state"),
                       torch.float32, init="zeros"),
    }


def _chunk_len(t: int, chunk: int) -> int:
    """Largest divisor of t that is <= chunk (odd prefill lengths fall back
    to shorter chunks rather than failing)."""
    tc = min(chunk, t)
    while t % tc:
        tc -= 1
    return tc


# (B, chunks, Tc, Tc, H) float32 values that one slab of chunks may hold:
# zamba2's 4 x 4,096-token prefill (168 M) is one slab; at 32 x 32,768
# tokens its chunks go 6 a slab, 43 slabs of 1.0 GB a tensor
_SLAB_ELEMS = 1 << 28


def _ssd(s, da, xs, b32, c32, delta, tc: int, *, grad: bool,
         slab_elems: int = _SLAB_ELEMS):
    """The chunked scan over T = nc * tc steps: s (B,H,P,N), da/delta
    (B,T,H), xs (B,T,H,P), b32/c32 (B,T,N) -> (the final state, y
    (B,T,H,P)).  The chunks go in slabs of at most ``slab_elems``
    (B, chunks, Tc, Tc, H) values, the state carried from slab to slab in
    order; with ``grad`` each slab runs under ``torch.utils.checkpoint``
    (the JAX package's ``jax.checkpoint`` of its chunk body), so the
    backward rebuilds one slab's (Tc, Tc, H) tensors at a time."""
    bsz, t, nh = da.shape
    step = tc * max(1, slab_elems // (bsz * tc * tc * nh))
    ys = []
    for i in range(0, t, step):
        part = [a[:, i:i + step] for a in (da, xs, b32, c32, delta)]
        if grad:
            s, y = checkpoint(_ssd_slab, s, *part, tc, use_reentrant=False)
        else:
            s, y = _ssd_slab(s, *part, tc)
        ys.append(y)
    return s, ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)


def _ssd_slab(s_init, da, xs, b32, c32, delta, tc: int):
    """``_ssd`` on one slab: every chunk's intra-chunk term and its state
    from zero at once; then the states carried across the chunks in
    order, as the JAX package's scan carries them; then each chunk's
    carried-state term."""
    bsz, t, nh = da.shape
    nc, p, n = t // tc, xs.shape[-1], b32.shape[-1]
    da_c = da.reshape(bsz, nc, tc, nh)
    x_c = xs.reshape(bsz, nc, tc, nh, p)
    b_c, c_c = b32.reshape(bsz, nc, tc, n), c32.reshape(bsz, nc, tc, n)
    dl_c = delta.reshape(bsz, nc, tc, nh)
    cum = torch.cumsum(da_c, dim=2)                           # (B,c,Tc,H)
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (B,c,i,j,H)
    tri = torch.ones((tc, tc), dtype=torch.bool,
                     device=da.device).tril()[:, :, None]
    L = torch.exp(torch.where(tri, li, float("-inf")))
    del li
    sc = torch.einsum("bcin,bcjn->bcij", c_c, b_c)
    xw = x_c * dl_c[..., None]                                # (B,c,Tc,H,P)
    y = torch.einsum("bcijh,bcjhp->bcihp", sc[..., None] * L, xw)
    del L
    # each chunk's state from zero: sum_j exp(cum_last - cum_j) delta_j
    # B_j x_j
    w = (torch.exp(cum[:, :, -1:, :] - cum) * dl_c)[..., None] * b_c[
        :, :, :, None, :]                                     # (B,c,Tc,H,N)
    local = torch.einsum("bcjhn,bcjhp->bchpn", w, x_c)
    decay = torch.exp(cum[:, :, -1])                          # (B,c,H)
    s, starts = s_init, []
    for c in range(nc):
        starts.append(s)
        s = decay[:, c, :, None, None] * s + local[:, c]
    s0 = torch.stack(starts, dim=1)                           # (B,c,H,P,N)
    cw = torch.exp(cum)[..., None] * c_c[:, :, :, None, :]    # (B,c,Tc,H,N)
    y = y + torch.einsum("bcihn,bchpn->bcihp", cw, s0)
    return s, y.reshape(bsz, t, nh, p)


def mamba2(params, x, cfg: Mamba2Cfg, *, mode: str, cache):
    dt_ = x.dtype
    bsz, t, _ = x.shape
    di, n, p = cfg.d_inner, cfg.d_state, cfg.head_dim
    nh = di // p

    zxd = x @ params["in_proj"].to(dt_)
    zxd = constrain(zxd, ("batch", "seq", "ssm_inner"),
                    weight=params["in_proj"])
    z, xbc, dt_head = (zxd[..., :di], zxd[..., di:2 * di + 2 * n],
                       zxd[..., 2 * di + 2 * n:])

    conv_tail = cache["conv"] if cache is not None else None
    xbc_raw = xbc
    xbc = F.silu(causal_conv(xbc, params["conv_w"], params["conv_b"],
                             conv_tail))
    xs = xbc[..., :di].reshape(bsz, t, nh, p).float()
    b32, c32 = xbc[..., di:di + n].float(), xbc[..., di + n:].float()

    delta = _softplus(dt_head.float() + params["dt_bias"].float())  # (B,T,H)
    A = -torch.exp(params["A_log"].float())                         # (H,)
    da = delta * A
    d_skip = params["D"].float()[:, None]

    if mode == "decode":
        if cache is None or t != 1:
            raise ValueError("mamba2: decode takes T == 1 and a cache")
        decay = torch.exp(da[:, 0])                                   # (B,H)
        upd = torch.einsum("bh,bhp,bn->bhpn", delta[:, 0], xs[:, 0],
                           b32[:, 0])
        s = decay[..., None, None] * cache["state"] + upd
        y = torch.einsum("bn,bhpn->bhp", c32[:, 0], s)[:, None]   # (B,1,H,P)
        y = y + d_skip * xs[:, :1]
        conv_new = torch.cat([conv_tail[:, 1:], xbc_raw], dim=1)
        cache["conv"].copy_(conv_new)
        cache["state"].copy_(s)
        new_cache = cache
    else:
        tc = _chunk_len(t, cfg.chunk)
        s = (cache["state"] if cache is not None
             else x.new_zeros((bsz, nh, p, n), dtype=torch.float32))
        s, y = _ssd(s, da, xs, b32, c32, delta, tc,
                    grad=mode == "train" and torch.is_grad_enabled())
        y = y + d_skip * xs
        if mode == "prefill":
            tail_len = cfg.conv_width - 1
            new_cache = {"conv": xbc_raw[:, t - tail_len:].to(dt_),
                         "state": s}
        else:
            new_cache = None

    y = y.reshape(bsz, t, di).to(dt_)
    y = rmsnorm(y * F.silu(z), params["norm"])
    out = y @ params["out_proj"].to(dt_)
    return constrain(out, ("batch", "seq", "act_embed"),
                     weight=params["out_proj"]), new_cache
