"""Placement specs for the production dry-runs: the port of
``repro/dist/shardings.py``.

A ``Spec`` is the counterpart of JAX's ``PartitionSpec``: a tuple with
one entry a dimension -- ``None`` (replicated), a mesh axis name, or a
tuple of names whose extents multiply -- normalised as ``PartitionSpec``
normalises (a one-name tuple is the name). The port has no SPMD
partitioner to hand them to; ``launch.specs`` attaches them to the
dry-run's shape-only inputs and ``launch.dryrun`` sizes each device's
shard from them (``shard_shape``). The rules are the reference's,
divisibility-guarded -- ``fit_spec`` drops any entry whose extent does
not divide its dimension, so one rule set covers all ten archs on both
the 16x16 and the 2x16x16 mesh:

  * params: column-parallel -- the widest trailing dim divisible by
    ``model`` (and at least twice its size) is sharded over it; the
    leading dim (R stacks, vocab rows) never is.
  * optimizer state: moments mirror the param specs; the step counter
    replicates.
  * batches: the leading batch dim over the data-parallel axes (pod,
    data); M-RoPE position streams (3, B, S) over dim 1.
  * decode state: the batch dim over (pod, data) -- dim 1 of the
    stacked scan caches (R, B, ...), dim 0 of the tail caches (B, ...).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Sequence, Tuple

import torch

from repro_torch.dist.mesh import dp_axes


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return e[0] if len(e) == 1 else e
    return e


class Spec(tuple):
    """One placement spec: ``Spec("data", None)`` shards dim 0 over
    ``data`` and replicates dim 1; ``Spec()`` replicates everything."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "Spec(" + ", ".join(map(repr, self)) + ")"


def map_specs(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves (tensors or ``Spec``s) of nested dicts,
    lists, tuples and NamedTuples, keeping the containers."""
    if isinstance(tree, (torch.Tensor, Spec)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_specs(fn, v) for v in tree]
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)
    return fn(tree)


def _structure(tree: Any) -> Any:
    """The container layout of ``tree`` with every leaf as ``None``."""
    return map_specs(lambda _: None, tree)


def _extent(mesh, entry) -> int:
    if entry is None:
        return 1
    axes = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(mesh.shape[a] for a in axes)


def fit_spec(mesh, spec: Sequence, shape: Sequence[int]) -> Spec:
    """Drop spec entries whose mesh extent does not divide the dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        size = _extent(mesh, entry)
        out.append(entry if (size > 1 and dim % size == 0) else None)
    return Spec(*out)


def shard_shape(mesh, spec: Sequence, shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """The shape of one device's shard of a ``shape`` leaf under
    ``spec`` (every sharded dim divided by its extent)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        size = _extent(mesh, entry)
        if dim % size:
            raise ValueError(f"dim {dim} does not split over {entry} "
                             f"({size})")
        out.append(dim // size)
    return tuple(out)


def shard_bytes(mesh, tree, specs) -> int:
    """Bytes of one device's shards of every tensor in ``tree`` under the
    matching ``Spec`` of ``specs`` (a tree of the same layout; dicts are
    matched by key)."""
    if isinstance(tree, torch.Tensor):
        shape = shard_shape(mesh, specs, tuple(tree.shape))
        return math.prod(shape) * tree.element_size()
    if isinstance(tree, dict):
        return sum(shard_bytes(mesh, v, specs[k]) for k, v in tree.items())
    return sum(shard_bytes(mesh, v, s) for v, s in zip(tree, specs,
                                                       strict=True))


def param_shardings(cfg, mesh, params):
    """Column-parallel default over ``model`` for every weight leaf."""
    tp = mesh.shape.get("model", 1)

    def leaf(x):
        spec = [None] * x.dim()
        if tp > 1:
            for i in range(x.dim() - 1, 0, -1):  # never the leading dim:
                if x.shape[i] % tp == 0 and x.shape[i] >= 2 * tp:
                    spec[i] = "model"            # (R-stacks / vocab rows)
                    break
        return Spec(*spec)

    return map_specs(leaf, params)


def opt_shardings(params_sh, opt_s):
    """Optimizer-state specs from the param specs: fields whose tree
    mirrors the params (AdamW mu/nu, SGD momentum) inherit the param
    specs; everything else (step counters) replicates."""
    p_struct = _structure(params_sh)
    fields = {}
    for f in opt_s._fields:
        sub = getattr(opt_s, f)
        fields[f] = (params_sh if _structure(sub) == p_struct
                     else map_specs(lambda _: Spec(), sub))
    return type(opt_s)(**fields)


def batch_shardings(cfg, mesh, batch: Dict[str, Any]) -> Dict[str, Spec]:
    """Input batches: batch dim over (pod, data), divisibility-guarded."""
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch.items():
        if k == "mrope_positions":               # (3, B, S)
            spec = (None, dp, None)
        else:                                    # (B, ...)
            spec = (dp,) + (None,) * (v.dim() - 1)
        out[k] = fit_spec(mesh, spec, v.shape)
    return out


def decode_state_shardings(cfg, mesh, state):
    """Decode caches: batch dim over (pod, data). ``scan`` leaves are
    stacked per pattern position (R, B, ...); tail leaves are unstacked
    (B, ...). Sequence-dim sharding over ``model`` happens inside
    ``serve.attention.sharded_decode_attention``, not here."""
    dp = dp_axes(mesh)

    def shard(x, batch_dim):
        spec = [None] * x.dim()
        if x.dim() > batch_dim:
            spec[batch_dim] = dp
        return fit_spec(mesh, spec, x.shape)

    return {
        "scan": map_specs(lambda x: shard(x, 1 if x.dim() > 1 else 0),
                          state["scan"]),
        "tail": map_specs(lambda x: shard(x, 0), state["tail"]),
    }


__all__ = ["Spec", "fit_spec", "shard_shape", "shard_bytes", "map_specs",
           "param_shardings", "opt_shardings", "batch_shardings",
           "decode_state_shardings"]
