"""Training launcher of the port: the paper's RapidGNN pipeline on one
device.

``--workload gnn`` runs the full pipeline (schedule -> cache ->
prefetch -> train) or the DGL-style baseline on a synthetic benchmark
graph, with the paper's GraphSAGE (hidden 256, 2 layers, fan-outs
(25, 10)) aggregating through the ``gather_agg`` kernels, forward and
backward (``agg_backend="kernel"``). The schedule is compiled on the
device (``--schedule-backend device``, the ``seg_sort`` kernel) or by
the numpy compiler (``numpy``); both give the same schedule bit for
bit. ``--workload lm --arch <id>`` trains the reduced variant of a
ported architecture on synthetic token data (``synthetic_lm_batches``)
with AdamW, through ``lm_loss`` under autograd (the chunked attention,
each repeat rematerialised). ``--device`` defaults to ``cuda`` and
raises without a card.

  PYTHONPATH=src python -m repro_torch.launch.train --workload gnn \\
      --dataset reddit_sim --system rapidgnn --epochs 5
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --dataset tiny --epochs 2 --batch-size 64
  PYTHONPATH=src python -m repro_torch.launch.train --workload lm \\
      --arch smollm-360m --steps 50 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve_device

#: ``--schedule-backend`` -> ``build_schedule`` compiler
SCHEDULE_COMPILERS = {"numpy": "batched", "device": "device"}


def run_gnn(args) -> None:
    from repro_torch.core import (BaselineRunner, NetworkModel,
                                  RapidGNNRunner, ShardedFeatureStore,
                                  build_schedule)
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.models import (GNNConfig, batch_to_device, init_params,
                                    make_train_step)
    from repro_torch.train import AdamW, save_checkpoint

    device = resolve_device(args.device)
    fanouts = (25, 10)
    g = load_dataset(args.dataset)
    pg = partition_graph(g, args.workers, args.partition)
    sampler = KHopSampler(g, fanouts=list(fanouts),
                          batch_size=args.batch_size)
    t0 = time.perf_counter()
    ws = build_schedule(sampler, pg, worker=0, s0=args.seed,
                        num_epochs=args.epochs, n_hot=args.n_hot,
                        compiler=SCHEDULE_COMPILERS[args.schedule_backend],
                        device=device)
    schedule_s = time.perf_counter() - t0

    cfg = GNNConfig(kind=args.model, in_dim=g.feat_dim, hidden_dim=256,
                    num_classes=g.num_classes, num_layers=2,
                    fanouts=fanouts, agg_backend="kernel")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device)
    opt = AdamW(lr=3e-3)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)
    state = {"params": params, "opt": opt_state, "hist": []}

    def train_fn(feats, cb):
        batch = batch_to_device(cb, feats, device)
        state["params"], state["opt"], aux = step(state["params"],
                                                  state["opt"], batch)
        state["hist"].append((float(aux["loss"]), float(aux["acc"])))
        return state["hist"][-1][0]

    net = NetworkModel(enabled=args.network_model)
    store = ShardedFeatureStore(pg, worker=0, net=net)
    runner_cls = (RapidGNNRunner if args.system == "rapidgnn"
                  else BaselineRunner)
    kw = {"Q": args.Q} if args.system == "rapidgnn" else {}
    runner = runner_cls(ws, store, batch_size=args.batch_size,
                        train_fn=train_fn, **kw)
    t0 = time.perf_counter()
    metrics = runner.run()
    wall = time.perf_counter() - t0
    tot = metrics.totals()
    print(f"\n== {args.system} on {args.dataset} "
          f"({args.workers}w, batch {args.batch_size}, {device}) ==")
    print(f"schedule ({args.schedule_backend}) {schedule_s:.2f}s  "
          f"wall {wall:.1f}s  epochs {args.epochs}  "
          f"steps {len(state['hist'])}  "
          f"final loss {state['hist'][-1][0]:.3f}  "
          f"acc {state['hist'][-1][1]:.3f}")
    for k in ("rpc_count", "remote_bytes", "vector_pull_bytes",
              "hit_rate", "fetch_stall_s", "modeled_net_time_s"):
        print(f"  {k}: {tot[k]:.4g}")
    if args.ckpt:
        save_checkpoint(args.ckpt, state["params"],
                        step=len(state["hist"]))
        print("checkpoint saved to", args.ckpt)


def run_lm(args) -> None:
    from repro_torch.configs import get_reduced
    from repro_torch.data.pipeline import synthetic_lm_batches
    from repro_torch.models.transformer import init_params, make_train_step
    from repro_torch.train import AdamW, save_checkpoint

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device)
    opt = AdamW(lr=3e-4, weight_decay=0.01, max_grad_norm=1.0)
    opt_state = opt.init(params)
    step = make_train_step(cfg, opt)

    t0 = time.perf_counter()
    losses = []
    for i, batch in enumerate(synthetic_lm_batches(
            cfg, batch=args.batch_size, seq=args.seq, steps=args.steps,
            s0=args.seed)):
        batch = {k: v.to(device) for k, v in batch.items()}
        params, opt_state, aux = step(params, opt_state, batch)
        losses.append(float(aux["loss"]))
        if i % 10 == 0:
            print(f"step {i:4d}  loss {losses[-1]:.4f}")
    print(f"\n== lm {args.arch} (reduced) on {device} == {args.steps} "
          f"steps in {time.perf_counter() - t0:.1f}s; loss "
          f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce loss"
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print("checkpoint saved to", args.ckpt)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=["gnn", "lm"], default="gnn")
    # gnn
    ap.add_argument("--dataset", default="ogbn_products_sim")
    ap.add_argument("--system", choices=["rapidgnn", "baseline"],
                    default="rapidgnn")
    ap.add_argument("--model", choices=["sage", "gcn"], default="sage")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--partition", default="metis")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--n-hot", type=int, default=4096)
    ap.add_argument("--Q", type=int, default=4)
    ap.add_argument("--network-model", action="store_true",
                    help="charge modelled 10GbE time on critical-path fetches")
    ap.add_argument("--schedule-backend", choices=sorted(SCHEDULE_COMPILERS),
                    default="device",
                    help="where the schedule compiler sorts (the schedule "
                         "is the same either way)")
    # lm
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    # common
    ap.add_argument("--batch-size", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda | cpu)")
    args = ap.parse_args(argv)
    if args.workload == "gnn":
        run_gnn(args)
    else:
        if args.batch_size == 1000:
            args.batch_size = 8
        run_lm(args)


if __name__ == "__main__":
    main()
