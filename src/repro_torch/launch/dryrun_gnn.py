"""The paper's own workload at pod scale, as one rank sees it: the port of
``repro/launch/dryrun_gnn.py``, scoped to a fake-process-group trace of
rank 0.

The reference lowers and compiles the device-distributed RapidGNN epoch
(cache-first all-to-all feature pull + GraphSAGE train step, one-step
prefetch overlap) for P = 256 (single pod) or 512 (multi-pod) workers and
reads the per-device memory and the collectives of the partitioned
program. The port has no partitioner; it runs what one of those P
workers runs. A ``"fake"`` process group of P ranks stands in for the
other P - 1 (no communication happens), and rank 0 takes one step of the
pipelined epoch's per-rank body (``dist.gnn_step.make_rank_step``):
``pull_shard`` of the next step's plan, the fused ``assemble`` (local >
C_s > pulled), GraphSAGE loss and gradients (``gather_agg`` forward and
backward on the card), the gradient mean over the group by one
``all_reduce``, and AdamW. ``--baseline`` takes the on-demand body: no
cache, the pull on the step's own critical path.

Each collective is counted as it is dispatched (a ``TorchDispatchMode``
sees every ``c10d`` op), with the reference's accounting
(``repro/launch/dryrun.py`` ``collective_bytes``): the result's bytes,
all-reduce twice (a ring's reduce-scatter and all-gather). The fake
group answers an all-to-all with what this rank sent (the counter copies
it, whatever the installed fake group does), and leaves an all-reduce's
buffer as it was, so the run is deterministic and its values are this
rank's own.

Rank 0's inputs have the reference's paper-scale per-worker shapes (d
128, batch 1000, n_hot 32,768, k_max 4096, m_max 60,000, n_per 220,000,
8 steps, 172 classes) and are drawn from ``--seed`` through ``rng_from``
in a synthetic mix of local, cached and missed ids (``rank0_inputs``):
the step's time is that mix's, not a measured workload's.
The record holds the per-worker argument bytes (the epoch's inputs, as
the reference's ``argument_size_in_bytes``), the counted collectives,
the step's time and its kernel launches, for two timed runs after a
warm-up. It runs on the card by default, on the CPU with ``--device
cpu`` (``--workers`` small there: an all-to-all lane block is P x 4096
rows of 128 floats).

  PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn [--multi-pod]
  PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn --workers 256 512
  PYTHONPATH=src python -m repro_torch.launch.dryrun_gnn --device cpu \\
      --workers 16
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.device import resolve_device
from repro_torch.dist.gnn_step import make_rank_step
from repro_torch.dist.feature_a2a import pull_shard
from repro_torch.graph.sampler import rng_from
from repro_torch.models.gnn import GNNConfig, init_params
from repro_torch.train.optim import AdamW, tree_leaves

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
#: the c10d ops the rank body dispatches -> the reference's kind
_KINDS = {"allreduce_": "all-reduce", "alltoall_base_": "all-to-all"}


@dataclasses.dataclass(frozen=True)
class GNNDims:
    """Per-worker shapes. The defaults are the reference's paper scale
    (an OGBN-Papers100M-like partition); ``fanouts`` make both layers'
    padded edge lists fan-out regular (120,000 = 12,000 x 10 and 25,000
    = 1,000 x 25), so the ``gather_agg`` kernel aggregates them."""
    d: int = 128
    B: int = 1000
    n_hot: int = 32_768
    k_max: int = 4096
    m_max: int = 60_000
    n_per: int = 220_000
    S: int = 8
    classes: int = 172
    hidden: int = 256
    fanouts: Tuple[int, int] = (10, 25)

    @property
    def edge_max(self) -> Tuple[int, int]:
        return (self.m_max * 2, self.B * 25)


PAPER = GNNDims()

SYNTHETIC_NOTE = (
    "step_ms, the peak and the launches are of a synthetic query mix "
    "(rank0_inputs: 40 % local, 30 % cached, 25 % remote misses, 5 % "
    "padding; 90 % valid edges) with no measured source; the counted "
    "collectives and argument bytes do not depend on it")


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CollectiveCounter(TorchDispatchMode):
    """Counts every ``c10d`` collective dispatched inside it, calls and
    bytes by the reference's kind: an all-to-all's result bytes, an
    all-reduce's twice. An all-to-all's output gets the rank's own
    input (the fake group's answer). A collective it has no accounting
    for raises."""

    def __init__(self):
        super().__init__()
        self.bytes = {k: 0 for k in _COLLECTIVES}
        self.counts = {k: 0 for k in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.namespace == "c10d":
            op = func._schema.name.split("::", 1)[1]
            if op == "alltoall_base_":
                args[0].copy_(args[1])
                vol = _tensor_bytes(args[0])
            elif op == "allreduce_":
                vol = 2 * sum(_tensor_bytes(t) for t in args[0])
            else:
                raise NotImplementedError(f"no accounting for c10d {op}")
            self.bytes[_KINDS[op]] += vol
            self.counts[_KINDS[op]] += 1
        return out

    def record(self) -> Dict[str, Any]:
        out: Dict[str, Any] = dict(self.bytes)
        out["total"] = sum(self.bytes.values())
        out["counts"] = dict(self.counts)
        return out


def _lanes(miss_ids: np.ndarray, miss_pos: np.ndarray, P: int,
           dims: GNNDims):
    """Pack one step's misses into (P, k_max) lanes by owner."""
    owner = miss_ids // dims.n_per
    order = np.argsort(owner, kind="stable")
    owner, ids, pos = owner[order], miss_ids[order], miss_pos[order]
    first = np.searchsorted(owner, np.arange(P))
    lane = np.arange(owner.shape[0]) - first[owner]
    if lane.size and lane.max() >= dims.k_max:
        raise ValueError("more misses for one owner than k_max lanes")
    send_ids = np.zeros((P, dims.k_max), np.int32)
    send_pos = np.zeros((P, dims.k_max), np.int32)
    send_mask = np.zeros((P, dims.k_max), bool)
    send_ids[owner, lane] = ids
    send_pos[owner, lane] = pos
    send_mask[owner, lane] = True
    return send_ids, send_pos, send_mask


def rank0_inputs(P: int, dims: GNNDims, seed: int) -> Dict[str, Any]:
    """Rank 0's epoch inputs as numpy arrays, from ``rng_from(seed, P)``:
    its table shard, hot set C_s (remote rows at even slots), and S steps
    whose m_max query ids are 40 % local, 30 % cached and 25 % remote
    misses (odd slots, never cached) packed into owner lanes, 5 % padding
    (-1); edges fan-out regular, 90 % valid.

    The mix is synthetic: the reference's dry-run has shapes only, and
    nothing measured in the repo gives a worker's local / hit / miss
    shares at P = 256 and this scale. The counted collectives and the
    argument bytes do not depend on it (the lanes are whole (P, k_max)
    blocks); the step's time and the assembly's work do, so the
    record's ``step_ms`` is that of this mix (``SYNTHETIC_NOTE``)."""
    rng = rng_from(seed, P)
    n_per, m = dims.n_per, dims.m_max
    if P < 2 or n_per % 2 or dims.n_hot > (P - 1) * (n_per // 2):
        raise ValueError(f"{P} workers of {n_per} rows (even) cannot hold "
                         f"a remote hot set of {dims.n_hot}")
    table = rng.standard_normal((n_per, dims.d), dtype=np.float32)
    hot = np.unique(rng.integers(1 * n_per // 2, P * n_per // 2,
                                 size=2 * dims.n_hot))
    cache_ids = np.sort(rng.choice(hot, dims.n_hot, replace=False)) * 2
    cache_feats = rng.standard_normal((dims.n_hot, dims.d),
                                      dtype=np.float32)
    n_loc, n_hit, n_miss = int(0.4 * m), int(0.3 * m), int(0.25 * m)
    steps = []
    for _ in range(dims.S):
        q = np.full(m, -1, np.int64)
        q[:n_loc] = rng.integers(0, n_per, size=n_loc)
        q[n_loc:n_loc + n_hit] = rng.choice(cache_ids, n_hit)
        owner = rng.integers(1, P, size=n_miss)
        slot = 2 * rng.integers(0, n_per // 2, size=n_miss) + 1
        miss = owner * n_per + slot
        pos = np.arange(n_loc + n_hit, n_loc + n_hit + n_miss)
        q[pos] = miss
        send_ids, send_pos, send_mask = _lanes(miss, pos, P, dims)
        e_src, e_dst, e_mask = [], [], []
        rows_in = (m, dims.edge_max[0] // dims.fanouts[0])
        for layer, (E, fo) in enumerate(zip(dims.edge_max, dims.fanouts)):
            e_src.append(rng.integers(0, rows_in[layer], size=E,
                                      dtype=np.int32))
            e_dst.append((np.arange(E) // fo).astype(np.int32))
            e_mask.append(rng.random(E) < 0.9)
        steps.append({
            "input_nodes": q,
            "labels": rng.integers(0, dims.classes, size=dims.B,
                                   dtype=np.int32),
            "seed_mask": rng.random(dims.B) < 0.98,
            "edge_src": e_src, "edge_dst": e_dst, "edge_mask": e_mask,
            "send_ids": send_ids, "send_pos": send_pos,
            "send_mask": send_mask})
    return {"table": table, "offsets": np.zeros((1, 1), np.int32),
            "cache_ids": cache_ids.astype(np.int64),
            "cache_feats": cache_feats, "steps": steps}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return torch.from_numpy(np.ascontiguousarray(tree)).to(device)


def _launch_counters():
    from repro_torch.kernels.assemble import ops as asm
    from repro_torch.kernels.cache_lookup import ops as cl
    from repro_torch.kernels.gather_agg import ops as ga
    from repro_torch.kernels.seg_sort import ops as ss
    return [asm.LAUNCHES, ga.LAUNCHES, ga.BWD_LAUNCHES, ss.LAUNCHES,
            cl.LAUNCHES, cl.MERGE_LAUNCHES]


def run_rank0(P: int, dims: GNNDims = PAPER, *, baseline: bool = False,
              assemble_backend: str = "auto", device=None, seed: int = 0,
              runs: int = 2) -> Dict[str, Any]:
    """Rank 0 of a ``"fake"`` group of P ranks: one warm-up and ``runs``
    timed, counted runs of one step from the same inputs. Initialises
    the default process group and destroys it before returning."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    device = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    host = rank0_inputs(P, dims, seed)
    cfg = GNNConfig(kind="sage", in_dim=dims.d, hidden_dim=dims.hidden,
                    num_classes=dims.classes, num_layers=2,
                    fanouts=tuple(dims.fanouts), agg_backend="kernel")
    opt = AdamW(lr=3e-3)
    params = init_params(cfg, torch.Generator().manual_seed(seed), device)
    opt_state = opt.init(params)
    inputs = _to({k: host[k] for k in ("table", "offsets", "cache_ids",
                                       "cache_feats", "steps")}, device)
    arg_bytes = sum(_tensor_bytes(t) for t in
                    tree_leaves(params) + tree_leaves(opt_state)
                    + tree_leaves(inputs))
    shard = {"table": inputs["table"], "base": 0,
             "cache_ids": inputs["cache_ids"].to(torch.int32),
             "cache_feats": inputs["cache_feats"]}
    steps = inputs["steps"]
    lanes_of = steps[0] if baseline else steps[1]
    x = dict(steps[0], send_ids=lanes_of["send_ids"],
             send_pos=lanes_of["send_pos"], send_mask=lanes_of["send_mask"])
    counters = _launch_counters()
    cuda = device.type == "cuda"
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=P)
    try:
        step = make_rank_step(cfg, opt, dims.m_max,
                              assemble_backend=assemble_backend,
                              pipelined=not baseline)
        pulled = None
        if not baseline:            # the epoch's prologue: step 0's pull
            with CollectiveCounter():
                pulled = pull_shard(shard["table"], steps[0]["send_ids"],
                                    steps[0]["send_pos"],
                                    steps[0]["send_mask"], 0, dims.m_max)
        results = []
        for r in range(runs + 1):
            p, o = copy.deepcopy(params), copy.deepcopy(opt_state)
            for c in counters:
                c.reset()
            counter = CollectiveCounter()
            if cuda:
                torch.cuda.synchronize(device)
                torch.cuda.reset_peak_memory_stats(device)
                before = torch.cuda.memory_allocated(device)
            t0 = time.perf_counter()
            with counter:
                _, _, loss, acc, _ = step(p, o, shard, x, pulled)
            if cuda:
                torch.cuda.synchronize(device)
            ms = (time.perf_counter() - t0) * 1e3
            results.append({
                "step_ms": ms, "loss": float(loss), "acc": float(acc),
                "collectives": counter.record(),
                "launches": {c.name: c.value for c in counters},
                "peak_above_inputs_bytes": (
                    torch.cuda.max_memory_allocated(device) - before
                    if cuda else None)})
    finally:
        dist.destroy_process_group()
    timed = results[1:]
    same = all(t["collectives"] == timed[0]["collectives"]
               and t["launches"] == timed[0]["launches"] for t in timed)
    return {
        "workload": ("rapidgnn-sage-ondemand" if baseline
                     else "rapidgnn-sage"),
        "workers": P, "rank": 0,
        "mesh": f"{P} (data), a fake process group, rank 0",
        "device": str(device), "assemble_backend": assemble_backend,
        "memory": {"argument_size_bytes": arg_bytes,
                   "temp_size_bytes": None,
                   "peak_above_inputs_bytes":
                       timed[0]["peak_above_inputs_bytes"],
                   "note": ("argument bytes: rank 0's epoch inputs (params, "
                            "AdamW state, shard, C_s, S steps of batches "
                            "and lanes), exact; the peak above them is "
                            "measured on the card only")},
        "collectives": timed[0]["collectives"],
        "collectives_note": ("counted at dispatch over one step of rank "
                             "0's body; result bytes, all-reduce x2"),
        "per_worker": {"n_per": dims.n_per, "feat_dim": dims.d,
                       "n_hot": dims.n_hot, "k_max": dims.k_max,
                       "m_max": dims.m_max, "batch": dims.B,
                       "steps": dims.S, "fanouts": list(dims.fanouts)},
        "loss": timed[0]["loss"], "acc": timed[0]["acc"],
        "step_ms": [t["step_ms"] for t in timed],
        "synthetic_note": SYNTHETIC_NOTE,
        "launches": timed[0]["launches"],
        "rerun_equal": same,
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--workers", type=int, nargs="+", default=None,
                    help="fake group sizes, run in turn (default 256, 512 "
                         "multi-pod)")
    ap.add_argument("--baseline", action="store_true",
                    help="the on-demand (no cache, non-overlapped) body "
                         "instead of the pipelined one")
    ap.add_argument("--assemble-backend", default="auto",
                    choices=("auto", "fused", "ref", "staged"))
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for P in args.workers or [512 if args.multi_pod else 256]:
        t0 = time.perf_counter()
        rec = run_rank0(P, baseline=args.baseline,
                        assemble_backend=args.assemble_backend,
                        device=args.device, seed=args.seed)
        rec["wall_s"] = time.perf_counter() - t0
        if not np.isfinite(rec["loss"]):
            raise SystemExit(f"rank 0 of {P}: the loss is not finite: "
                             f"{rec['loss']}")
        if not rec["rerun_equal"]:
            raise SystemExit(f"rank 0 of {P}: a second run differs in "
                             f"counted collectives or launches")
        tag = f"rapidgnn_gnn__w{P}" + ("__ondemand" if args.baseline
                                       else "")
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        print(json.dumps(rec, indent=1))
        print(f"GNN rank-0 dry-run OK ({P} workers)")


if __name__ == "__main__":
    main()
