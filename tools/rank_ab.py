#!/usr/bin/env python3
"""Time the hot-set rank (``search``) and the fused feature assembly of
two or more checkouts of the port in turns, on one card.

    python3 tools/rank_ab.py OLD/src NEW/src NEW/src OLD/src

Each argument is a ``src`` directory holding ``repro_torch``; each runs
in a process of its own (its kernels built from its own sources), in the
order given, over the same seeded inputs at the serving micro-batch's
shape: 73,216 query rows of d 602 (4 requests x m_max 18,304), n_hot
4,096 sorted ids, a shard of 15,000 rows. Rows are 10 % padding, 25 %
local, about 24 % cache hits, the rest pulled. Per run it prints one
JSON line: the ``search`` call and the ``assemble_features(backend="fused")`` call,
each timed one call a CUDA-graph replay and 20 calls to a graph (CUDA
events), the card operations a fused call runs, ``search`` again at the
embedding lookup's shape (``emb_``: 4,096 tokens, n_hot 32,768 of a
256,000-token vocabulary), and the card's name and power limit. Every
call is held against the run's plain versions.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

M, D, N_HOT, N_PER, BASE, N_IDS = 73216, 602, 4096, 15000, 30000, 60000
#: the embedding lookup's call: 16 x 256 tokens a worker, n_hot 32,768 of
#: gemma2-2b's 256,000-token vocabulary
EMB_M, EMB_N_HOT, EMB_VOCAB = 4096, 32768, 256000


def inputs(torch, device, m=M, n_hot=N_HOT, n_ids=N_IDS, d=D):
    gen = torch.Generator(device="cpu").manual_seed(20)
    remote = torch.cat([torch.arange(0, BASE),
                        torch.arange(BASE + N_PER, n_ids)])
    ids = remote[torch.randperm(remote.shape[0], generator=gen)[:n_hot]] \
        .sort().values.to(torch.int32)
    u = torch.rand(m, generator=gen)
    q = remote[torch.randint(0, remote.shape[0], (m,), generator=gen)]
    q = torch.where(u < 0.55, ids[torch.randint(0, n_hot, (m,),
                                                generator=gen)].long(), q)
    q = torch.where(u < 0.35, torch.randint(BASE, BASE + N_PER, (m,),
                                            generator=gen), q)
    q = torch.where(u < 0.10, torch.full_like(q, -1), q).to(torch.int32)
    t = [ids, torch.randn((n_hot, d), generator=gen),
         torch.randn((N_PER, d), generator=gen), q,
         torch.randn((m, d), generator=gen)]
    return [x.to(device) for x in t]


def child(src: str) -> dict:
    import torch
    sys.path.insert(0, ROOT)
    sys.path.insert(0, src)
    from chip_smoke import card_line, device_ms, device_ms_per_call, \
        device_ops
    from repro_torch.kernels.assemble.ops import assemble_features
    from repro_torch.kernels.assemble.ref import assemble_ref
    from repro_torch.kernels.cache_lookup.ops import search
    from repro_torch.kernels.cache_lookup.ref import search_ref

    if not torch.cuda.is_available():
        raise SystemExit("rank_ab: no CUDA device")
    dev = torch.device("cuda", 0)
    ids, feats, table, q, pulled = inputs(torch, dev)

    def rank():
        return search(ids, q)

    def fused():
        return assemble_features(table, BASE, ids, feats, q, pulled,
                                 backend="fused")
    for got, want in zip(rank(), search_ref(ids, q)):
        if not torch.equal(got, want):
            raise RuntimeError("search differs from search_ref")
    if not torch.equal(fused(), assemble_ref(table, BASE, ids, feats, q,
                                             pulled)):
        raise RuntimeError("fused assembly differs from assemble_ref")
    e_ids, _, _, e_q, _ = inputs(torch, dev, EMB_M, EMB_N_HOT, EMB_VOCAB, 1)

    def emb_rank():
        return search(e_ids, e_q)
    for got, want in zip(emb_rank(), search_ref(e_ids, e_q)):
        if not torch.equal(got, want):
            raise RuntimeError("search differs from search_ref at n_hot "
                               f"{EMB_N_HOT}")
    return {"src": src, "card": card_line(),
            "emb_search_ms": device_ms(torch, emb_rank),
            "emb_search_ms_in_a_graph": device_ms_per_call(torch, emb_rank),
            "search_ms": device_ms(torch, rank),
            "search_ms_in_a_graph": device_ms_per_call(torch, rank),
            "assemble_ms": device_ms(torch, fused),
            "assemble_ms_in_a_graph": device_ms_per_call(torch, fused),
            "assemble_card_ops": device_ops(torch, fused),
            "hit_rate": float(search_ref(ids, q)[1].float().mean())}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for src in argv:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--child", os.path.abspath(src)],
                              stdout=subprocess.PIPE, text=True)
        if proc.returncode:
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
