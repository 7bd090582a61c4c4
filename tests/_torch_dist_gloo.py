"""``pull_shard`` on 4 CPU ranks over ``torch.distributed`` with the
gloo backend, for ``tests/test_torch_dist.py``:

    PYTHONPATH=src python tests/_torch_dist_gloo.py IN.npz OUT_DIR

Each rank reads its shard and request lanes from ``IN.npz`` (keys
``table`` (P, n_per, d), ``send_ids``/``send_pos``/``send_mask`` (P, P,
k), ``offsets`` (P,), ``m_max``), runs the exchange, and writes its
buffer to ``OUT_DIR/rank{r}.npy``. The ranks meet through a
``FileStore`` in ``OUT_DIR``, so no port is opened.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank: int, world: int, inp: str, out_dir: str) -> None:
    from repro_torch.dist.feature_a2a import pull_shard

    store = dist.FileStore(os.path.join(out_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        z = np.load(inp)
        t = {k: torch.from_numpy(np.ascontiguousarray(z[k][rank]))
             for k in ("table", "send_ids", "send_pos", "send_mask")}
        got = pull_shard(t["table"], t["send_ids"], t["send_pos"],
                         t["send_mask"], int(z["offsets"][rank]),
                         int(z["m_max"]))
        np.save(os.path.join(out_dir, f"rank{rank}.npy"), got.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    inp, out_dir = sys.argv[1], sys.argv[2]
    world = int(np.load(inp)["table"].shape[0])
    mp.start_processes(rank_main, args=(world, inp, out_dir), nprocs=world,
                       start_method="spawn")
