"""GraphSAGE training, worked out again in plain PyTorch: uniform
weights drawn from the seed on a CPU generator, the mean aggregation by
``index_add_`` over each block's unmasked edges, ``h_dst @ W_self +
mean @ W_neigh + b`` with ReLU between layers, the mean cross-entropy
over each batch's seeds, gradients averaged over the P workers (a
worker with no batch left in a step adds zero), and AdamW on the
shared parameters. float32 throughout; ``tf32=True`` is the control,
the same computation with TF32 matrix products.

Leaves are named ``layers.<l>.<w_self|w_neigh|b>``.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.sampler import RefBatch

Params = Dict[str, torch.Tensor]


def layer_dims(config: Dict) -> List[int]:
    """[in, hidden..., classes] of a configuration's GraphSAGE."""
    return ([config["feat_dim"]]
            + [config["hidden_dim"]] * (config["num_layers"] - 1)
            + [config["num_classes"]])


def init_params(dims: Sequence[int], seed: int) -> Params:
    """dims: [in, hidden..., classes]; draws in the order w_self, w_neigh
    of each layer from ``torch.Generator().manual_seed(seed)``."""
    gen = torch.Generator().manual_seed(seed)
    out: Params = {}
    for l in range(len(dims) - 1):
        d_in, d_out = dims[l], dims[l + 1]
        scale = 1.0 / math.sqrt(d_in)
        for k in ("w_self", "w_neigh"):
            u = torch.rand((d_in, d_out), generator=gen, dtype=torch.float32)
            out[f"layers.{l}.{k}"] = (2.0 * u - 1.0) * scale
        out[f"layers.{l}.b"] = torch.zeros((d_out,), dtype=torch.float32)
    return out


@contextmanager
def matmul_precision(tf32: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def batch_loss(p: Params, num_layers: int, X: torch.Tensor,
               labels: torch.Tensor, b: RefBatch,
               keep_rows: Optional[np.ndarray] = None,
               half_batch: bool = False) -> torch.Tensor:
    dev = X.device
    h = X[torch.from_numpy(b.input_nodes).to(dev)]
    if keep_rows is not None:       # a fault: rows never delivered
        h = h * torch.from_numpy(keep_rows).to(dev, torch.float32)[:, None]
    for l in range(num_layers):
        nd = b.num_dst[l]
        m = b.edge_mask[l]
        src = torch.from_numpy(b.edge_src[l][m].astype(np.int64)).to(dev)
        dst = torch.from_numpy(b.edge_dst[l][m].astype(np.int64)).to(dev)
        summed = torch.zeros((nd, h.shape[1]), dtype=h.dtype,
                             device=dev).index_add_(0, dst, h[src])
        cnt = torch.bincount(dst, minlength=nd).clamp(min=1).to(h.dtype)
        agg = summed / cnt[:, None]
        hn = (h[:nd] @ p[f"layers.{l}.w_self"]
              + agg @ p[f"layers.{l}.w_neigh"] + p[f"layers.{l}.b"])
        h = torch.relu(hn) if l < num_layers - 1 else hn
    y = labels[torch.from_numpy(b.seeds).to(dev)].long()
    n = y.shape[0] // 2 if half_batch else y.shape[0]
    return F.cross_entropy(h[:n], y[:n])


def train_steps(params: Params, num_layers: int, X: torch.Tensor,
                labels: torch.Tensor,
                epochs: Sequence[Sequence[Sequence[RefBatch]]],
                opt: Dict[str, float], *, tf32: bool = False,
                half_batch: bool = False,
                keep: Optional[Sequence[Sequence[Sequence[np.ndarray]]]]
                = None) -> Dict[str, object]:
    """Epochs of steps over ``epochs[k][w][i]`` (epoch k, worker w, step
    i), one AdamW state carried through them all: -> {"losses": every
    step's loss in order, "params": the last step's θ, "mu": the first
    moments after it, "grad0": the step-1 averaged gradient}.
    ``keep[k][w][i]`` (a fault) multiplies each input row of that batch
    by 0 or 1."""
    dev = X.device
    p = {k: v.to(dev).clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["lr"]
    wd = opt.get("weight_decay", 0.0)
    losses: List[float] = []
    grad0 = None
    t = 0
    with matmul_precision(tf32):
        for k_ep, batches in enumerate(epochs):
            P = len(batches)
            for i in range(max(len(b) for b in batches)):
                total = {k: torch.zeros_like(v) for k, v in p.items()}
                loss_sum = 0.0
                for w in range(P):
                    if i >= len(batches[w]):
                        continue    # a worker with no batch left adds 0
                    leaves = {k: v.detach().requires_grad_(True)
                              for k, v in p.items()}
                    loss = batch_loss(leaves, num_layers, X, labels,
                                      batches[w][i],
                                      keep_rows=None if keep is None
                                      else keep[k_ep][w][i],
                                      half_batch=half_batch)
                    names = list(leaves)
                    grads = torch.autograd.grad(loss,
                                                [leaves[k] for k in names])
                    for k, g in zip(names, grads):
                        total[k] += g
                    loss_sum += float(loss.detach())
                g_avg = {k: v / P for k, v in total.items()}
                if grad0 is None:
                    grad0 = {k: v.clone() for k, v in g_avg.items()}
                t += 1
                bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
                with torch.no_grad():
                    for k in p:
                        g = g_avg[k]
                        mu[k] = b1 * mu[k] + (1.0 - b1) * g
                        nu[k] = b2 * nu[k] + (1.0 - b2) * g * g
                        delta = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                                 + eps)
                        if wd:
                            delta = delta + wd * p[k]
                        p[k] = p[k] - lr * delta
                losses.append(loss_sum / P)
    return {"losses": losses, "params": p, "mu": mu, "grad0": grad0}
