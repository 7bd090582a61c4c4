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
expert's weights, as the reference's do.

Expert parallelism over the ``model`` axis of a ``("data", "model")``
mesh (the reference's ``shard_map``): on the port's in-process mesh each
model rank's experts are views of the stacked weights and ``moe_apply``
adds the ranks' ``moe_local`` partials; ``moe_shard`` is one rank's body
over a ``torch.distributed`` group, the same partial and one
``all_reduce(SUM)``. With two ranks the sum has two terms and the two
forms agree bit for bit.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.distributed as dist

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


def _sum(parts):
    """The partials added in order, in their dtype."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


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
    return _sum([parts[:, j] for j in range(k)])


def _expert_views(params, r: int, n_local: int, ff=None):
    """Model rank r's expert weights: views of experts ``[r * n_local,
    (r + 1) * n_local)``, and with ``ff = (j, f)`` of the FF slice ``[j
    * f, (j + 1) * f)`` (``w1``/``w3`` columns, ``w2`` rows)."""
    e = slice(r * n_local, (r + 1) * n_local)
    c = slice(None) if ff is None else slice(ff[0] * ff[1],
                                             (ff[0] + 1) * ff[1])
    return {"router": params["router"], "w1": params["w1"][e, :, c],
            "w3": params["w3"][e, :, c], "w2": params["w2"][e, c, :]}


def moe_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ArchConfig, mesh=None, dp_spec=None,
              cap: Optional[int] = None) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d). Without a mesh, or with one ``model``
    shard, every expert runs on all tokens. With tp > 1 model shards,
    experts ``[r * E/tp, (r + 1) * E/tp)`` sit on model rank r and the
    partials of the ranks are added in rank order, in x's dtype:

    - expert-parallel (the default): the B*S tokens are cut into the
      mesh's dp data groups (``dp_spec`` names the data axes; all tokens
      are one group when dp does not divide B*S), and each group is
      routed alone -- its own capacity ``capacity(cfg, B*S/dp)`` and its
      own queue positions, as the reference's ``shard_map`` routes each
      device's tokens;
    - weight-stationary (``cfg.moe_resident_experts``): every rank sees
      all tokens, and the FF dimension is further cut over the dp data
      ranks (``w1``/``w3`` columns, ``w2`` rows); all tp x dp partials
      are added, model rank outermost.
    """
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    tp = 1 if mesh is None else mesh.shape.get("model", 1)
    if tp == 1:
        out = moe_local(params, x2, cfg, 0, cfg.num_experts, cap=cap)
        return out.reshape(B, S, d)
    if cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{tp} model shards")
    n_local = cfg.num_experts // tp
    if dp_spec is None:
        dp_spec = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dp = math.prod(mesh.shape[a] for a in (
        dp_spec if isinstance(dp_spec, tuple) else (dp_spec,)))
    if (B * S) % dp:                 # e.g. decode with one sequence
        dp = 1

    if cfg.moe_resident_experts:
        if cfg.moe_d_ff % dp:
            raise ValueError(f"an FF width of {cfg.moe_d_ff} does not split "
                             f"over {dp} data ranks")
        f = cfg.moe_d_ff // dp
        parts = [moe_local(_expert_views(params, r, n_local,
                                         None if dp == 1 else (j, f)),
                           x2, cfg, r * n_local, n_local, cap=cap)
                 for r in range(tp) for j in range(dp)]
        return _sum(parts).reshape(B, S, d)

    groups = x2.chunk(dp)
    out = torch.cat([_sum([moe_local(_expert_views(params, r, n_local), xg,
                                     cfg, r * n_local, n_local, cap=cap)
                           for r in range(tp)]) for xg in groups])
    return out.reshape(B, S, d)


def moe_shard(params_local: Dict[str, torch.Tensor], x_group: torch.Tensor,
              cfg: ArchConfig, *, rank: int, tp: int, group=None,
              cap: Optional[int] = None) -> torch.Tensor:
    """Model rank ``rank`` of ``tp`` in ``group`` (default the world), the
    expert-parallel body: ``params_local`` holds the whole router and
    this rank's experts ``[rank * E/tp, (rank + 1) * E/tp)``; x_group
    (T, d) is the data group's tokens -> (T, d), the MoE output over
    every expert, the same on every rank of the group."""
    if cfg.num_experts % tp:
        raise ValueError(f"{cfg.num_experts} experts do not split over "
                         f"{tp} model shards")
    if not 0 <= rank < tp or dist.get_world_size(group) != tp:
        raise ValueError(f"model rank {rank} of {tp} in a group of "
                         f"{dist.get_world_size(group)}")
    n_local = cfg.num_experts // tp
    out = moe_local(params_local, x_group, cfg, rank * n_local, n_local,
                    cap=cap)
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
