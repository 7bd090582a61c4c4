"""One epoch of ``make_rank_step`` (the per-rank body of the pipelined
and on-demand GNN epochs) on CPU ranks over ``torch.distributed`` with
the gloo backend, for the port's tests:

    PYTHONPATH=src python tests/_torch_gnn_gloo.py IN.npz OUT_DIR

``IN.npz`` holds the P workers' ``table`` (P, n_per, d), ``offsets``
(P,), ``cache_ids`` (P, n_hot) and ``cache_feats`` (P, n_hot, d), the
model's ``in_dim``, ``hidden``, ``classes``, ``fanouts``, ``m_max``,
``lr`` and initial parameters ``param_{l}_{name}``, and two collated
epochs, ``rapid_*`` (with caches) and ``ondemand_*`` (cache-less), each
with ``input_nodes``, ``labels``, ``seed_mask`` (S, P, ...), per-layer
``edge_{src,dst,mask}_{l}`` and the lanes ``send_{ids,pos,mask}`` (S, P,
P, k). Rank w runs every step of both epochs on its own slices: the
pipelined one pulls step 0 first (the epoch's prologue) and each step
i's lanes are ``prefetch_stream``'s step i+1; the on-demand one pulls
each step's own. Rank ``rank`` writes ``OUT_DIR/rank{rank}.npz``
(``{kind}_losses``, ``{kind}_accs`` and the final ``{kind}_{l}_{name}``).
The ranks meet through a ``FileStore`` in ``OUT_DIR``, so no port is
opened.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

LANES = ("send_ids", "send_pos", "send_mask")


def _epoch(z, kind, w):
    """Worker w's slices of one collated epoch: (S, steps, lanes)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    S = z[f"{kind}_input_nodes"].shape[0]
    L = len([k for k in z if k.startswith(f"{kind}_edge_src_")])
    steps = [{"input_nodes": t(z[f"{kind}_input_nodes"][i, w]),
              "labels": t(z[f"{kind}_labels"][i, w]),
              "seed_mask": t(z[f"{kind}_seed_mask"][i, w]),
              **{f"edge_{e}": [t(z[f"{kind}_edge_{e}_{l}"][i, w])
                               for l in range(L)]
                 for e in ("src", "dst", "mask")}} for i in range(S)]
    send = {k: t(z[f"{kind}_{k}"]) for k in LANES}
    return S, steps, send


def rank_main(rank: int, world: int, inp: str, out_dir: str) -> None:
    from repro_torch.dist.feature_a2a import pull_shard
    from repro_torch.dist.gnn_step import make_rank_step, prefetch_stream
    from repro_torch.kernels.cache_lookup.ops import to_device_ids
    from repro_torch.models.gnn import (GNNConfig, params_from_numpy,
                                        params_to_numpy)
    from repro_torch.train import AdamW

    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        z = {k: v for k, v in np.load(inp).items()}
        w, m_max = rank, int(z["m_max"])
        cfg = GNNConfig(kind="sage", in_dim=int(z["in_dim"]),
                        hidden_dim=int(z["hidden"]),
                        num_classes=int(z["classes"]), num_layers=2,
                        fanouts=tuple(int(f) for f in z["fanouts"]),
                        agg_backend="kernel")
        opt = AdamW(lr=float(z["lr"]))
        n = len({k.split("_")[1] for k in z if k.startswith("param_")})
        init = {"layers": [{k: z[f"param_{l}_{k}"] for k in
                            ("w_self", "w_neigh", "b")} for l in range(n)]}
        shard = {"table": torch.from_numpy(np.ascontiguousarray(
                     z["table"][w])),
                 "base": int(z["offsets"].reshape(-1)[w]),
                 "cache_ids": to_device_ids(torch.from_numpy(
                     np.ascontiguousarray(z["cache_ids"][w]))),
                 "cache_feats": torch.from_numpy(np.ascontiguousarray(
                     z["cache_feats"][w]))}
        out = {}
        for kind, pipelined in (("rapid", True), ("ondemand", False)):
            S, steps, send = _epoch(z, kind, w)
            lanes = prefetch_stream(send) if pipelined else send
            step = make_rank_step(cfg, opt, m_max, pipelined=pipelined)
            params = params_from_numpy(init)
            opt_state = opt.init(params)
            pulled = (pull_shard(shard["table"], *(send[k][0, w]
                                                   for k in LANES),
                                 shard["base"], m_max)
                      if pipelined else None)
            losses, accs = [], []
            for i in range(S):
                x = dict(steps[i], **{k: lanes[k][i, w] for k in LANES})
                params, opt_state, loss, acc, pulled = step(
                    params, opt_state, shard, x, pulled)
                losses.append(loss)
                accs.append(acc)
            out[f"{kind}_losses"] = torch.stack(losses).numpy()
            out[f"{kind}_accs"] = torch.stack(accs).numpy()
            for l, layer in enumerate(params_to_numpy(params)["layers"]):
                for k, v in layer.items():
                    out[f"{kind}_{l}_{k}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    inp, out_dir = sys.argv[1], sys.argv[2]
    world = int(np.load(inp)["table"].shape[0])
    mp.start_processes(rank_main, args=(world, inp, out_dir), nprocs=world,
                       start_method="spawn")
