"""``pull_shard`` (and ``pull_shard_two_tier``) on CPU ranks over
``torch.distributed`` with the gloo backend, for the port's tests:

    PYTHONPATH=src python tests/_torch_dist_gloo.py IN.npz OUT_DIR

Each rank reads its shard and request lanes from ``IN.npz`` (keys
``table`` (P, n_per, d), ``offsets`` (P,), ``m_max``, and either the
flat ``send_ids``/``send_pos``/``send_mask`` (P, P, k) or, with
``devices_per_host`` D, the two-tier ``intra_*`` (P, D, k_i) and
``inter_*`` (P, P, k_x)), runs the exchange, and writes its buffer to
``OUT_DIR/rank{r}.npy``. The two-tier exchange runs over the rank's
host subgroup (ranks ``h*D .. h*D+D-1``) and the world. The ranks meet
through a ``FileStore`` in ``OUT_DIR``, so no port is opened.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIER_KEYS = tuple(f"{t}_{k}" for t in ("intra", "inter")
                  for k in ("ids", "pos", "mask"))


def rank_main(rank: int, world: int, inp: str, out_dir: str) -> None:
    from repro_torch.dist.feature_a2a import pull_shard, pull_shard_two_tier

    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        z = np.load(inp)
        base, m_max = int(z["offsets"][rank]), int(z["m_max"])
        table = torch.from_numpy(np.ascontiguousarray(z["table"][rank]))
        if "devices_per_host" in z:
            D = int(z["devices_per_host"])
            # every rank creates every host's group, in the same order
            groups = [dist.new_group(list(range(h * D, (h + 1) * D)))
                      for h in range(world // D)]
            send = {k: torch.from_numpy(np.ascontiguousarray(z[k][rank]))
                    for k in TIER_KEYS}
            got = pull_shard_two_tier(table, send, base, m_max,
                                      ici_group=groups[rank // D])
        else:
            t = {k: torch.from_numpy(np.ascontiguousarray(z[k][rank]))
                 for k in ("send_ids", "send_pos", "send_mask")}
            got = pull_shard(table, t["send_ids"], t["send_pos"],
                             t["send_mask"], base, m_max)
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), got.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    inp, out_dir = sys.argv[1], sys.argv[2]
    world = int(np.load(inp)["table"].shape[0])
    mp.start_processes(rank_main, args=(world, inp, out_dir), nprocs=world,
                       start_method="spawn")
