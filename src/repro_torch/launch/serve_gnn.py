"""GNN inference serving launcher of the port: the online tier end to end.

Builds a partitioned graph, starts the ``repro_torch.serve.gnn`` service
(dispatcher + cache warmer threads) on ``--device`` (default ``cuda``),
fires a Philox-keyed Poisson request stream at it, and prints the health
snapshot plus a latency summary. The model aggregates through the
``gather_agg`` kernel (``agg_backend="kernel"``).

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --dataset tiny \
      --requests 64 --rate 200 --fault-profile serve-pull-flaky
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.fault.inject import active_plan
from repro_torch.fault.plan import PROFILES, plan_from_profile
from repro_torch.graph import KHopSampler, load_dataset, partition_graph
from repro_torch.graph.sampler import rng_from
from repro_torch.device import resolve_device
from repro_torch.models import GNNConfig, init_params
from repro_torch.serve.gnn import GNNInferenceService, Overloaded


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tiny")
    ap.add_argument("--parts", type=int, default=4)
    ap.add_argument("--worker", type=int, default=0)
    ap.add_argument("--fanouts", type=int, nargs="+", default=[5, 5])
    ap.add_argument("--batch-size", type=int, default=8,
                    help="max seeds per request (static collation bound)")
    ap.add_argument("--max-batch-requests", type=int, default=4)
    ap.add_argument("--n-hot", type=int, default=256)
    ap.add_argument("--high-water", type=int, default=64)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--timeout-s", type=float, default=1.0,
                    help="per-request deadline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-profile", default=None,
                    choices=sorted(PROFILES),
                    help="run the stream under a named fault plan")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda | cpu)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    g = load_dataset(args.dataset, seed=args.seed)
    pg = partition_graph(g, args.parts, "greedy")
    sampler = KHopSampler(g, fanouts=args.fanouts,
                          batch_size=args.batch_size)
    cfg = GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=64,
                    num_classes=g.num_classes, num_layers=len(args.fanouts),
                    fanouts=tuple(args.fanouts), agg_backend="kernel")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device)
    svc = GNNInferenceService(
        pg, sampler, cfg, params, s0=args.seed, worker=args.worker,
        n_hot=args.n_hot, max_batch_requests=args.max_batch_requests,
        high_water=args.high_water,
        default_timeout_s=args.timeout_s, device=device).start()

    rng = rng_from(args.seed, 0x5345)       # "SE": the arrival stream
    gaps = rng.exponential(1.0 / args.rate, size=args.requests)
    sizes = rng.integers(1, args.batch_size + 1, size=args.requests)
    plan = (plan_from_profile(args.fault_profile, seed=args.seed)
            if args.fault_profile else None)

    pendings, shed = [], 0
    t0 = time.perf_counter()
    with active_plan(plan):
        for i in range(args.requests):
            time.sleep(float(gaps[i]))
            seeds = rng.integers(0, g.num_nodes, size=int(sizes[i]))
            try:
                pendings.append(svc.submit(seeds))
            except Overloaded:
                shed += 1
        lat, errors = [], 0
        for p in pendings:
            try:
                lat.append(p.result(timeout=10.0).latency_s)
            except Exception:
                errors += 1
    wall = time.perf_counter() - t0
    svc.close()

    health = svc.health()
    print(f"== serve_gnn {args.dataset} P={args.parts} "
          f"worker={args.worker} device={device} ==")
    print(f"{args.requests} requests in {wall:.2f}s "
          f"({len(lat)} served, {shed} shed, {errors} errors)")
    if lat:
        print(f"latency p50 {1e3 * float(np.percentile(lat, 50)):.2f} ms  "
              f"p99 {1e3 * float(np.percentile(lat, 99)):.2f} ms")
    print(json.dumps(health, indent=2, default=str))


if __name__ == "__main__":
    main()
