"""MoE routing held fixed, so that two runs can be compared on one routing.

The router takes its top k from float32 logits.  Two routes of one model
(the kernel and the plain route, the port and the JAX package) differ in
attention by ~1e-7 of scale, so a token whose k-th and (k+1)-th logits
lie that close may take another expert on one of them, and shift the
capacity positions after it in its group: an order-one difference and no
fault.  So a comparison records one run's routing (``Routing()``), runs
the other on it (``Routing(records)``) and counts the tokens that would
have routed otherwise (``Routing.flips``), each with its margin on the
reference run: at most ``ROUTE_FLIPS_MAX`` of them, each margin within
``ROUTE_GAP_SHARE`` of the router logits' largest magnitude.
"""
from __future__ import annotations

import numpy as np
import torch

ROUTE_FLIPS_MAX = 8
ROUTE_GAP_SHARE = 1e-5


def margins(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, float]:
    """(each token's k-th minus (k+1)-th logit, flat; the logits' largest
    magnitude)."""
    top = torch.topk(logits, k + 1, dim=-1).values
    return ((top[..., k - 1] - top[..., k]).reshape(-1),
            float(logits.abs().max()))


class Routing:
    """Within the block, every call of ``models.moe.route`` is recorded in
    ``records``: its float32 ``logits``, ``top_idx`` and ``pos`` and the
    capacity ``cap``.  Given ``forced``, the records of a reference run in
    call order (each with ``top_idx`` and ``pos``, tensors or arrays of
    any leading shape, and either its ``logits`` or its ``margin`` per
    token and ``scale``), each call instead takes the next record's
    top_idx and pos (its gates then the softmax of its own logits at
    those experts) and keeps its own choice beside them ("own").  A block
    without MoE layers records nothing."""

    def __init__(self, forced: list | None = None):
        self.forced = None if forced is None else list(forced)
        self.records: list = []

    def __enter__(self):
        from repro_torch.models import moe as moe_mod

        self.real = moe_mod.route

        def route(params, xg, cfg):
            logits, top_idx, gates, pos = self.real(params, xg, cfg)
            rec = {"logits": logits.detach(), "top_idx": top_idx, "pos": pos,
                   "cap": moe_mod.capacity(cfg, xg.shape[1])}
            if self.forced is not None:
                i = len(self.records)
                if i >= len(self.forced):
                    raise RuntimeError("Routing: more routing calls than the "
                                       "reference made")
                want = self.forced[i]
                rec["own"] = (top_idx, pos)
                top_idx = _like(want["top_idx"], top_idx)
                pos = _like(want["pos"], pos)
                gates = torch.softmax(logits.gather(-1, top_idx), dim=-1)
                rec["top_idx"], rec["pos"] = top_idx, pos
            self.records.append(rec)
            return logits, top_idx, gates, pos

        moe_mod.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as moe_mod

        moe_mod.route = self.real
        return False

    def flips(self) -> dict:
        """Of a forced run against its reference: the tokens whose own
        top_idx differed ("flips"), their margins on the reference as
        shares of its logits' largest magnitude ("gap_shares"), and the
        assignments whose own keep (pos < cap) differed ("keep_shifts")."""
        if len(self.records) != len(self.forced):
            raise RuntimeError(f"Routing: {len(self.records)} routing calls, "
                               f"the reference made {len(self.forced)}")
        flips, gaps, shifts = 0, [], 0
        for rec, ref in zip(self.records, self.forced):
            own_idx, own_pos = rec["own"]
            k = own_idx.shape[-1]
            ref_idx = _like(ref["top_idx"], own_idx)
            moved = (own_idx != ref_idx).reshape(-1, k).any(-1)
            flips += int(moved.sum())
            ref_pos = _like(ref["pos"], own_pos)
            shifts += int(((own_pos < rec["cap"])
                           != (ref_pos < rec["cap"])).sum())
            if bool(moved.any()):
                if "logits" in ref:
                    margin, scale = margins(ref["logits"], k)
                else:
                    margin = torch.as_tensor(np.asarray(ref["margin"]))
                    scale = float(ref["scale"])
                gaps += (margin.to(moved.device).reshape(-1)[moved]
                         / scale).tolist()
        return {"layers": len(self.records), "flips": flips,
                "gap_shares": gaps, "keep_shifts": shifts}


def _like(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor or an array) as a tensor of ``like``'s shape, dtype
    and device."""
    x = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return x.to(like.device, like.dtype).reshape(like.shape)
