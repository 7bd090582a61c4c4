"""GraphSAGE + GCN in PyTorch over padded MFG blocks (paper §2.3 models).

The port of the JAX package's ``repro/models/gnn.py`` forward path. The
forward consumes the static-shape ``CollatedBatch`` layout: a padded
input-node feature matrix ``h`` of shape (m_max, d) whose *dst prefix*
property (dst nodes of every layer are a prefix of its src nodes, and
the final seeds are ``h[:batch_size]``) lets all layers update the same
buffer. JAX's ``vmap`` over request slots becomes an explicit leading
batch dimension: ``forward`` takes (m, d) or (R, m, d) features with
(E,) or (R, E) edge lists.

Parameters keep the JAX layout (``w_self``/``w_neigh``/``w`` as
(d_in, d_out), used as ``h @ w``), so ``params_from_numpy`` carries the
reference's initial parameters over unchanged.

Aggregation dispatches per ``GNNConfig.agg_backend``: ``"segment"`` is
the masked ``index_add_`` oracle over the padded edge lists;
``"kernel"`` runs the ``kernels/gather_agg`` kernel, which reads the
deterministic sampler's dst-major fan-out-regular layout (every dst owns
exactly ``fanout`` contiguous edges) -- ``cfg.fanouts`` must then carry
the per-layer fan-outs. ``index_add_`` on CUDA sums with atomics, in no
fixed order; the kernel backend is deterministic, its backward too
(``gather_agg_bwd``, a by-source sort and an ordered per-row sum).

Training: ``loss_fn`` (masked mean NLL and accuracy over the seed
prefix), ``make_train_step`` (a functional step: parameter tree in,
parameter tree out, gradients from ``torch.autograd.grad``, then the
optimizer's ``update``) and ``batch_to_device`` (a ``CollatedBatch``
and its feature rows onto a device), as the JAX package's
``loss_fn`` / ``make_train_step`` / ``batch_to_device``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.schedule import CollatedBatch
from repro_torch.kernels.gather_agg.ops import gather_agg
from repro_torch.train.optim import tree_leaves, tree_map

AGG_BACKENDS = ("segment", "kernel")


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    kind: str                 # "sage" | "gcn"
    in_dim: int
    hidden_dim: int
    num_classes: int
    num_layers: int
    dropout: float = 0.0      # inference runs deterministic
    #: per-layer sampler fan-outs (input->output); required by the
    #: kernel aggregation backend (dst-major regular layout contract)
    fanouts: Optional[Tuple[int, ...]] = None
    #: "segment" (index_add_ oracle) | "kernel" (gather_agg kernel)
    agg_backend: str = "segment"

    def __post_init__(self):
        if self.agg_backend not in AGG_BACKENDS:
            raise ValueError(f"unknown agg_backend {self.agg_backend!r}")
        if self.agg_backend == "kernel":
            if self.fanouts is None:
                raise ValueError(
                    "kernel aggregation needs cfg.fanouts (the dst-major "
                    "fan-out-regular layout contract)")
            if len(self.fanouts) < self.num_layers:
                raise ValueError(
                    f"cfg.fanouts has {len(self.fanouts)} entries for "
                    f"{self.num_layers} layers")


Params = Dict[str, List[Dict[str, torch.Tensor]]]


def init_params(cfg: GNNConfig, generator: torch.Generator,
                device: Optional[torch.device] = None) -> Params:
    """Uniform(-1/sqrt(d_in), 1/sqrt(d_in)) weights, zero biases, drawn
    on the CPU from ``generator`` (so a seed gives the same parameters
    on every device) and moved to ``device``."""
    dims = ([cfg.in_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
            + [cfg.num_classes])

    def uniform(d_in: int, d_out: int) -> torch.Tensor:
        scale = 1.0 / math.sqrt(d_in)
        u = torch.rand((d_in, d_out), generator=generator,
                       dtype=torch.float32)
        return ((2.0 * u - 1.0) * scale).to(device)

    layers = []
    for l in range(cfg.num_layers):
        d_in, d_out = dims[l], dims[l + 1]
        bias = torch.zeros((d_out,), dtype=torch.float32, device=device)
        if cfg.kind == "sage":
            layers.append({"w_self": uniform(d_in, d_out),
                           "w_neigh": uniform(d_in, d_out), "b": bias})
        elif cfg.kind == "gcn":
            layers.append({"w": uniform(d_in, d_out), "b": bias})
        else:
            raise ValueError(cfg.kind)
    return {"layers": layers}


def params_from_numpy(tree: Dict[str, Any],
                      device: Optional[torch.device] = None) -> Params:
    """The JAX ``init_params`` output, moved through ``np.asarray``, ->
    the port's parameters (same names, same (d_in, d_out) layout)."""
    return {"layers": [
        {k: torch.tensor(np.asarray(v, dtype=np.float32), device=device)
         for k, v in layer.items()}
        for layer in tree["layers"]]}


def params_to_numpy(params: Params) -> Dict[str, Any]:
    """Inverse of ``params_from_numpy``."""
    return {"layers": [{k: v.detach().cpu().numpy() for k, v in layer.items()}
                       for layer in params["layers"]]}


def params_to(params: Params, device: torch.device) -> Params:
    return {"layers": [{k: v.to(device) for k, v in layer.items()}
                       for layer in params["layers"]]}


def aggregate_mean(h: torch.Tensor, edge_src: torch.Tensor,
                   edge_dst: torch.Tensor, edge_mask: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """Masked mean of src features into dst slots (the paper's AGG), one
    slot: h (m, d), edges (E,) -> (num_segments, d). The oracle."""
    msg = h[edge_src.long()] * edge_mask[:, None].to(h.dtype)
    dst = edge_dst.long()
    summed = torch.zeros((num_segments, h.shape[1]), dtype=h.dtype,
                         device=h.device).index_add_(0, dst, msg)
    cnt = torch.zeros((num_segments,), dtype=h.dtype,
                      device=h.device).index_add_(0, dst,
                                                  edge_mask.to(h.dtype))
    return summed / cnt.clamp(min=1.0)[:, None]


def _aggregate(cfg: GNNConfig, layer: int, h: torch.Tensor,
               edge_src: torch.Tensor, edge_dst: torch.Tensor,
               edge_mask: torch.Tensor) -> torch.Tensor:
    """Backend switch for the AGG over R slots: h (R, m, d), edges
    (R, E) -> (R, m, d). The kernel runs once over all slots: slot r's
    rows sit at offset ``r*m`` of the flattened ``h``, so its edge
    sources shift by ``r*m``, and its ``nd`` output rows land back at
    slot r, zero-padded to ``m`` (padded dst rows are fully masked on
    both paths). Taken when the config opts in and the padded edge list
    honours the fan-out-regular contract (edge count divisible by the
    layer fan-out)."""
    R, m, d = h.shape
    fo = cfg.fanouts[layer] if cfg.fanouts else 0
    E = edge_src.shape[1]
    if cfg.agg_backend == "kernel" and fo > 0 and E % fo == 0:
        nd = E // fo
        shift = (torch.arange(R, dtype=torch.int32, device=h.device)
                 * m)[:, None]
        agg = gather_agg(h.reshape(R * m, d),
                         (edge_src + shift).reshape(-1),
                         edge_mask.reshape(-1).contiguous(), nd=R * nd,
                         fanout=fo).reshape(R, nd, d)
        if nd < m:
            agg = torch.cat([agg, agg.new_zeros((R, m - nd, d))], dim=1)
        return agg[:, :m]
    return torch.stack([aggregate_mean(h[r], edge_src[r], edge_dst[r],
                                       edge_mask[r], m) for r in range(R)])


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(R, m, k) @ (k, n) as R products of one shape, so a slot's rows
    come out the same whichever slot it occupies."""
    return torch.bmm(x, w.expand(x.shape[0], *w.shape))


def forward(cfg: GNNConfig, params: Params, features: torch.Tensor,
            edge_src: Sequence[torch.Tensor],
            edge_dst: Sequence[torch.Tensor],
            edge_mask: Sequence[torch.Tensor]) -> torch.Tensor:
    """-> logits for the whole padded node array; seeds are the prefix.
    ``features`` (m, d) with (E_l,) edges, or (R, m, d) with (R, E_l)
    edges for R independent slots."""
    single = features.dim() == 2
    if single:
        features = features[None]
        edge_src = [e[None] for e in edge_src]
        edge_dst = [e[None] for e in edge_dst]
        edge_mask = [e[None] for e in edge_mask]
    h = features
    for l, layer in enumerate(params["layers"]):
        agg = _aggregate(cfg, l, h, edge_src[l], edge_dst[l], edge_mask[l])
        if cfg.kind == "sage":
            h_new = (_matmul(h, layer["w_self"])
                     + _matmul(agg, layer["w_neigh"]) + layer["b"])
        else:  # gcn: mean over {self} U neighbors (renormalisation trick)
            h_new = _matmul(0.5 * (h + agg), layer["w"]) + layer["b"]
        if l < cfg.num_layers - 1:
            h_new = torch.relu(h_new)
        h = h_new
    return h[0] if single else h


def loss_fn(cfg: GNNConfig, params: Params, features: torch.Tensor,
            edge_src: Sequence[torch.Tensor],
            edge_dst: Sequence[torch.Tensor],
            edge_mask: Sequence[torch.Tensor], labels: torch.Tensor,
            seed_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (masked mean NLL, masked accuracy) over the seed prefix."""
    logits = forward(cfg, params, features, edge_src, edge_dst, edge_mask)
    B = labels.shape[0]
    lg = logits[:B]
    logp = torch.log_softmax(lg, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None].long())[:, 0]
    w = seed_mask.to(torch.float32)
    denom = torch.clamp(torch.sum(w), min=1.0)
    loss = torch.sum(nll * w) / denom
    acc = torch.sum((torch.argmax(lg, -1) == labels) * w) / denom
    return loss, acc


def loss_and_grads(cfg: GNNConfig, params: Params, batch: Dict[str, Any]
                   ) -> Tuple[torch.Tensor, torch.Tensor, Params]:
    """-> (loss, acc, gradient tree shaped like ``params``)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, acc = loss_fn(cfg, p, batch["features"], batch["edge_src"],
                        batch["edge_dst"], batch["edge_mask"],
                        batch["labels"], batch["seed_mask"])
    grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
    return loss.detach(), acc.detach(), tree_map(lambda _: next(grads), p)


def make_train_step(cfg: GNNConfig, optimizer):
    """-> (params, opt_state, batch_dict) -> (params, opt_state, aux)."""

    def step(params, opt_state, batch):
        loss, acc, grads = loss_and_grads(cfg, params, batch)
        params2, opt_state2 = optimizer.update(grads, opt_state, params)
        return params2, opt_state2, {"loss": loss, "acc": acc}

    return step


def batch_to_device(cb: CollatedBatch, features: np.ndarray,
                    device: torch.device) -> Dict[str, Any]:
    """The step's inputs on ``device``: features (m_max, d) float32,
    per-layer int32 edge lists and bool masks, int32 labels, bool seed
    mask (plain copies from pageable host memory, as the reference
    makes them)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {
        "features": t(features),
        "edge_src": [t(e) for e in cb.edge_src],
        "edge_dst": [t(e) for e in cb.edge_dst],
        "edge_mask": [t(e) for e in cb.edge_mask],
        "labels": t(cb.labels),
        "seed_mask": t(cb.seed_mask),
    }
