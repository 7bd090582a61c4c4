"""Mixture-of-Experts: top-k router and sort-free capacity dispatch, the
port's ``repro/models/transformer/moe.py``.

The reference's dense capacity dispatch, kept as it is: the router in
float32, softmax, top-k, the weights renormalised, each (token, choice)
placed at its exclusive-cumsum position in its expert's queue, a static
(E_local, C, d) buffer (choices past C are dropped), three batched
expert products, then the combine back to tokens. Two writes differ in
form, not in result:

- the dispatch scatter is a plain index write: every kept (expert,
  slot) is written exactly once, and only the discarded drop row takes
  many writes;
- the combine is no atomic ``index_add_``: the choices of token t sit at
  rows t*k .. t*k + k - 1, so it sums the k weighted rows of each token
  in choice order, the order the reference's scatter-add takes, and a
  second run on the card gives the same bits.

At decode (T = B tokens, C = 4) the batched products still read every
expert's weights, as the reference's do. Expert parallelism over a mesh
(the reference's ``shard_map`` over the ``model`` axis) is not ported.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.models.transformer.common import ArchConfig, dense_init


def init_moe_params(cfg: ArchConfig, generator: torch.Generator, dtype,
                    device=None) -> Dict[str, torch.Tensor]:
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    return {
        "router": dense_init(generator, (d, E), 0, dtype, device),
        "w1": dense_init(generator, (E, d, ff), 1, dtype, device),  # gate
        "w3": dense_init(generator, (E, d, ff), 1, dtype, device),  # up
        "w2": dense_init(generator, (E, ff, d), 1, dtype, device),  # down
    }


def capacity(cfg: ArchConfig, tokens: int) -> int:
    c = math.ceil(cfg.top_k * tokens * cfg.capacity_factor
                  / cfg.num_experts)
    return max(c, 4)


def moe_local(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ArchConfig, e_offset: int, n_local: int,
              cap: Optional[int] = None) -> torch.Tensor:
    """Partial MoE output from experts [e_offset, e_offset+n_local).

    x (T, d) tokens; expert weights already sliced to n_local. Partials
    over disjoint expert ranges add up to the whole."""
    T, d = x.shape
    k = cfg.top_k
    C = cap if cap is not None else capacity(cfg, T)
    act = cfg.activation()

    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)                    # (T, E)
    top_p, top_e = torch.topk(probs, k, dim=-1)              # (T, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    e_flat = top_e.reshape(-1)                               # (T*k,)
    p_flat = top_p.reshape(-1)
    t_flat = torch.arange(T, device=x.device).repeat_interleave(k)

    e_loc = e_flat - e_offset
    mine = (e_loc >= 0) & (e_loc < n_local)
    key = torch.where(mine, e_loc, n_local)                  # E_l = drop

    # position of each choice within its expert's queue (dispatch order):
    # the reference's exclusive cumsum of the one-hot over the choices,
    # taken with the choices on the inner dimension (a scan over the
    # outer one runs column by column on the card)
    onehot_t = (key[None, :] == torch.arange(
        n_local + 1, device=x.device)[:, None]).to(torch.int32)
    counts = torch.cumsum(onehot_t, dim=1, dtype=torch.int32)
    pos = torch.gather(counts, 0, key[None, :])[0] - 1       # exclusive
    keep = mine & (pos < C)

    # the (E_local, C, d) buffer; dropped choices all land in row E_l
    be = torch.where(keep, key, n_local)
    bp = torch.where(keep, pos, 0).long()
    buf = torch.zeros((n_local + 1, C, d), dtype=x.dtype,
                      device=x.device).index_put((be, bp), x[t_flat])
    buf = buf[:n_local]

    h = torch.bmm(buf, params["w1"].to(x.dtype))
    u = torch.bmm(buf, params["w3"].to(x.dtype))
    y_e = torch.bmm(act(h) * u, params["w2"].to(x.dtype))    # (E_l, C, d)

    # combine back to tokens: each token's k rows, in choice order
    y_tok = y_e[torch.where(keep, key, 0), bp]               # (T*k, d)
    w = (p_flat * keep).to(x.dtype)
    parts = (y_tok * w[:, None]).reshape(T, k, d)
    out = parts[:, 0]
    for j in range(1, k):
        out = out + parts[:, j]
    return out


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ArchConfig, mesh=None,
              cap: Optional[int] = None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d), every expert on this device."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel moe_apply over a mesh is not ported yet: "
            "ROADMAP Queue 1 item 4")
    B, S, d = x.shape
    out = moe_local(params, x.reshape(B * S, d), cfg, 0, cfg.num_experts,
                    cap=cap)
    return out.reshape(B, S, d)
