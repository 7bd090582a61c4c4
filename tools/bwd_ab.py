#!/usr/bin/env python3
"""Time the ``gather_agg`` backward of two or more checkouts of the port
in turns, on one card, at the training path's shapes.

    python3 tools/bwd_ab.py OLD/src NEW/src NEW/src OLD/src

Each argument is a ``src`` directory holding ``repro_torch``. Each runs
in a process of its own (its kernels built from its own sources), in the
order given, over the same inputs: the first training batch of
``chip_smoke.py``'s training phase (``reddit_sim``, 4 partitions, worker
0, batch 1000, fan-outs (25, 10), padded to the schedule's bounds; built
once with the numpy schedule compiler and shared by the runs), with g
drawn from a seed: layer 1 (g (1000, 256), the path) and layer 0 (g
(4777, 602)), both into m_max = 21,093 rows. Per run it prints one JSON
line: per layer the call's time one call a CUDA-graph replay (``ms``) and
a call in a graph of 10 (``ms_graph``), the card operations a call, each
card op's own time (``op_ms``, from ``torch.profiler`` over 20 calls),
``index_add_``'s time on the same messages (the yardstick), the byte
bound (g, the edge lists and dh, each once, at 3.35 TB/s), the order's
floor (the longest run's dependent adds at 4 cycles an add and the card's
maximum SM clock), whether the result is bit-equal to the plain version
on the CPU and to a second call (``same``); then whether every backward
case of the tests (``tests/_torch_cases.py``) is bit-equal to the CPU
plain version in at most 3 card ops; and the card's name and power limit.
Unpack the parent with ``git archive`` into a git-ignored directory such
as ``build/parent`` for OLD.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BATCH = os.path.join(ROOT, "build", "bwd_ab_batch.npz")


def build_batch() -> None:
    """The first training batch's padded edge lists, as the runner hands
    them to the train step in ``chip_smoke.py``'s phase 4."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from repro_torch.core import build_schedule
    from repro_torch.graph import load_dataset, partition_graph
    g = load_dataset(cs.DATASET, seed=0)
    pg = partition_graph(g, cs.PARTS, "greedy")
    exp, sampler, cfg = cs.train_world(g)
    ws = build_schedule(sampler, pg, compiler="batched", **cs.schedule_kw(exp))
    m_max, edge_max = ws.pad_bounds()
    flat = ws.epoch(0).flat
    out = {"m_max": m_max, "fanouts": np.asarray(cfg.fanouts),
           "dims": np.asarray([g.feat_dim, cfg.hidden_dim])}
    for l in range(2):
        a, b = flat.edge_starts[l][0], flat.edge_starts[l][1]
        src = np.zeros(edge_max[l], np.int32)
        msk = np.zeros(edge_max[l], bool)
        src[:b - a] = flat.edge_src[l][a:b]
        msk[:b - a] = flat.edge_mask[l][a:b]
        out[f"src{l}"], out[f"mask{l}"] = src, msk
    os.makedirs(os.path.dirname(BATCH), exist_ok=True)
    np.savez(BATCH, **out)


def child(src: str) -> dict:
    import torch
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, src)
    from chip_smoke import (ADD_CYCLES, MEM_BYTES_PER_S, card_line,
                            device_ms, device_ms_per_call, device_ops,
                            max_sm_mhz, op_times_ms)
    from repro_torch.kernels.gather_agg import ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_ref
    dev = torch.device("cuda", 0)
    z = np.load(BATCH)
    m, fanouts, dims = int(z["m_max"]), z["fanouts"], z["dims"]
    out = {"src": src, "card": card_line()}
    mhz = max_sm_mhz()
    for l in (1, 0):
        fo, d = int(fanouts[l]), int(dims[l])
        src_t = torch.from_numpy(z[f"src{l}"]).to(dev)
        msk_t = torch.from_numpy(z[f"mask{l}"]).to(dev)
        nd = src_t.shape[0] // fo
        g = torch.randn((nd, d), generator=torch.Generator().manual_seed(l)
                        ).to(dev)

        def fn():
            return ops.gather_agg_bwd(g, src_t, msk_t, m=m, nd=nd, fanout=fo)
        got, again = fn(), fn()
        cpu = gather_agg_bwd_ref(g.cpu(), src_t.cpu(), msk_t.cpu(), m, nd,
                                 fo)
        cnt = msk_t.reshape(nd, fo).sum(1).float().clamp(min=1.0)
        msg = (g / cnt[:, None])[:, None, :].expand(nd, fo, d) \
            .reshape(nd * fo, d) * msk_t[:, None].float()
        src_l = src_t.long()

        def library():
            return torch.zeros((m, d), device=dev).index_add_(0, src_l, msg)
        unmasked = int(msk_t.sum())
        longest = int(torch.bincount(src_t[msk_t]).max()) if unmasked else 0
        nbytes = nd * d * 4 + src_t.shape[0] * 5 + m * d * 4
        torch.cuda.synchronize()
        out[f"layer{l}"] = {
            "shape": f"g=({nd},{d}) m={m} fanout={fo} unmasked={unmasked}",
            "bit_equal_cpu": bool(torch.equal(got.cpu(), cpu)),
            "same": bool(torch.equal(got, again)),
            "ms": device_ms(torch, fn),
            "ms_graph": device_ms_per_call(torch, fn, calls=10),
            "card_ops": device_ops(torch, fn),
            "op_ms": op_times_ms(torch, fn),
            "index_add_ms": device_ms(torch, library),
            "bound_ms": 1e3 * nbytes / MEM_BYTES_PER_S,
            "longest_run": longest,
            "order_floor_ms": longest * ADD_CYCLES / (mhz * 1e3)}
        del got, again, msg
    from _torch_cases import BWD_CASES, BWD_FULL_CASES, bwd_case, to_t
    cases = {}
    for name in sorted({**BWD_CASES, **BWD_FULL_CASES}):
        gg, s, mk, mm, ndd, ff = bwd_case(name)
        want = gather_agg_bwd_ref(*to_t(gg, s, mk), mm, ndd, ff)
        tg, ts, tm = [t.to(dev) for t in to_t(gg, s, mk)]

        def case():
            return ops.gather_agg_bwd(tg, ts, tm, m=mm, nd=ndd, fanout=ff)
        a, b = case(), case()
        cases[name] = {"bit_equal_cpu": bool(torch.equal(a.cpu(), want)),
                       "same": bool(torch.equal(a, b)),
                       "card_ops": len(device_ops(torch, case))}
    out["cases"] = cases
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not os.path.exists(BATCH):
        build_batch()
    rc = 0
    for src in sys.argv[1:]:
        p = subprocess.run([sys.executable, __file__, "--child", src],
                           timeout=900)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
