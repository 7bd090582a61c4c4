"""Optimizers built from scratch: AdamW + SGD over parameter trees.

The port of the JAX package's ``repro/train/optim.py``, line for line in
torch (not ``torch.optim``), so a step of either package gives the same
parameters to float32 rounding. Moments are kept in fp32 regardless of
parameter dtype; weight decay is decoupled (AdamW);
``clip_by_global_norm`` is applied inside ``update`` when
``max_grad_norm`` is set, in float32 as the reference's promotion does
it. ``update`` is functional: it returns new parameter and state trees
and leaves its inputs as they were. ``AdamW.update(..., inplace=True)``
overwrites the parameters and moments leaf by leaf instead, with the
same arithmetic, so one copy of each is alive at a time.

A tree is nested dicts (walked in sorted key order, as JAX walks them),
lists, tuples and NamedTuples (an optimizer state) with tensors at the
leaves -- the GNN's
``{"layers": [{"w_self": ..., ...}, ...]}``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        mapped = (tree_map(fn, t, *(r[i] for r in rest))
                  for i, t in enumerate(tree))
        if hasattr(tree, "_fields"):                # a NamedTuple state
            return type(tree)(*mapped)
        return type(tree)(mapped)
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> List[Any]:
    """Leaves in ``tree_map`` order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: Optional[float] = None

    def init(self, params: PyTree) -> AdamWState:
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        step = torch.zeros((), dtype=torch.int32,
                           device=tree_leaves(params)[0].device)
        return AdamWState(step=step, mu=zeros,
                          nu=tree_map(torch.clone, zeros))

    @torch.no_grad()
    def update(self, grads: PyTree, state: AdamWState, params: PyTree,
               lr_scale: float = 1.0, inplace: bool = False):
        scale = None
        if self.max_grad_norm is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.max_grad_norm / (gnorm + 1e-9),
                                max=1.0)
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()
        lr = self.lr * lr_scale

        def leaf(p, m, v, g):
            g = g.float() if scale is None else g.float() * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            if self.weight_decay:
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = []
        for old in zip(*map(tree_leaves, (params, state.mu, state.nu,
                                           grads))):
            new = leaf(*old)
            if inplace:
                for o, n in zip(old, new):
                    o.copy_(n)
                new = old[:3]
            out.append(new)
        its = [iter(col) for col in zip(*out)]
        new_params, mu, nu = (tree_map(lambda _: next(it), tree)
                              for it, tree in zip(its, (params, state.mu,
                                                        state.nu)))
        return new_params, AdamWState(step=step, mu=mu, nu=nu)


class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: PyTree


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: float = 1e-2
    momentum: float = 0.9

    def init(self, params: PyTree) -> SGDState:
        return SGDState(
            step=torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device),
            momentum=tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params))

    @torch.no_grad()
    def update(self, grads: PyTree, state: SGDState, params: PyTree,
               lr_scale: float = 1.0):
        mom = tree_map(lambda m, g: self.momentum * m + g.float(),
                       state.momentum, grads)
        new_params = tree_map(
            lambda p, m: (p.float() - self.lr * lr_scale * m).to(p.dtype),
            params, mom)
        return new_params, SGDState(step=state.step + 1, momentum=mom)


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in leaves))


def cosine_schedule(base_lr_scale: float, warmup: int, total: int):
    def fn(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        return base_lr_scale * warm * 0.5 * (1 + torch.cos(math.pi * prog))
    return fn


def opt_state_from_numpy(state: Any,
                         device: Optional[torch.device] = None
                         ) -> AdamWState:
    """An ``AdamWState(step, mu, nu)`` of the JAX package, moved
    through ``np.asarray``, -> the port's, with the same tree layout, so
    both packages can start from the same moments."""
    def t(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        mu=tree_map(t, state.mu), nu=tree_map(t, state.nu))
