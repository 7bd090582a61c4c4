"""The process-group forms of the sequence-sharded decode attention and
the expert-parallel MoE (``sharded_decode_shard``, ``moe_shard``) on CPU
ranks over ``torch.distributed`` with the gloo backend, for the port's
tests:

    PYTHONPATH=src python tests/_torch_shard_gloo.py IN.npz OUT_DIR

``IN.npz`` holds ``world`` and ``tp`` (the world is dp = world / tp data
groups of tp model ranks: rank = g * tp + r), the decode inputs ``q``
(B,1,H,dh), ``k``/``v`` (B,S,kvH,dh), ``length`` (B,) and ``softcap``,
and the MoE inputs ``router``, ``w1``, ``w2``, ``w3`` (all experts),
``x`` (T, d) and the config's ``num_experts``, ``top_k``, ``d_model``,
``moe_d_ff``, ``capacity_factor``. Data group g takes rows ``[g * B/dp,
(g + 1) * B/dp)`` of the decode batch and ``[g * T/dp, (g + 1) *
T/dp)`` of the tokens; model rank r holds cache slots ``[r * S/tp, (r +
1) * S/tp)`` and experts ``[r * E/tp, (r + 1) * E/tp)``. The model
group is the world when dp = 1, else the rank's subgroup (every rank
creates every subgroup, in the same order). Rank ``rank`` writes
``OUT_DIR/rank{rank}.npz`` (``decode``, ``moe``). The ranks meet through
a ``FileStore`` in ``OUT_DIR``, so no port is opened.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank: int, world: int, inp: str, out_dir: str) -> None:
    from repro_torch.models.transformer.common import ArchConfig
    from repro_torch.models.transformer.moe import moe_shard
    from repro_torch.serve.attention import sharded_decode_shard

    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        z = {k: v for k, v in np.load(inp).items()}
        tp = int(z["tp"])
        dp, g, r = world // tp, rank // tp, rank % tp
        groups = [dist.new_group(list(range(h * tp, (h + 1) * tp)))
                  for h in range(dp)] if dp > 1 else [None]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a))
        B, S = z["k"].shape[:2]
        rows, s = slice(g * B // dp, (g + 1) * B // dp), S // tp
        cache = (slice(None), slice(r * s, (r + 1) * s))
        dec = sharded_decode_shard(
            t(z["q"][rows]), t(z["k"][rows][cache]), t(z["v"][rows][cache]),
            t(z["length"][rows]), rank=r, tp=tp, group=groups[g],
            attn_softcap=float(z["softcap"]))
        cfg = ArchConfig(name="moe", moe=True, dtype="float32",
                         num_experts=int(z["num_experts"]),
                         top_k=int(z["top_k"]), d_model=int(z["d_model"]),
                         moe_d_ff=int(z["moe_d_ff"]),
                         capacity_factor=float(z["capacity_factor"]))
        n = cfg.num_experts // tp
        mine = {"router": t(z["router"])}
        mine.update({w: t(z[w][r * n:(r + 1) * n]) for w in ("w1", "w2",
                                                          "w3")})
        T = z["x"].shape[0]
        moe = moe_shard(mine, t(z["x"][g * T // dp:(g + 1) * T // dp]), cfg,
                        rank=r, tp=tp, group=groups[g])
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 decode=dec.numpy(), moe=moe.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    inp, out_dir = sys.argv[1], sys.argv[2]
    world = int(np.load(inp)["world"])
    mp.start_processes(rank_main, args=(world, inp, out_dir), nprocs=world,
                       start_method="spawn")
