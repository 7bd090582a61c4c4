#!/usr/bin/env python3
"""Time the training path's hand-written kernels -- the ``gather_agg``
backward and ``seg_sort`` -- of two or more checkouts of the port in
turns, on one card, at the training path's shapes.

    python3 tools/train_ab.py [--only gather_agg_bwd|seg_sort] \\
        OLD/src NEW/src NEW/src OLD/src

Each argument is a ``src`` directory holding ``repro_torch``; a variant
to compare is a tree of its own. Each runs in a process of its own (its kernels built from its own sources), in the
order given, over the same inputs, made once from ``chip_smoke.py``'s
training world (``reddit_sim``, 4 partitions, worker 0, batch 1000,
fan-outs (25, 10)) and shared by the runs:

- ``gather_agg_bwd``: the first training batch's padded edge lists
  (numpy schedule compiler), g drawn from a seed: layer 1 (g (1000,
  256), the path) and layer 0 (g (4777, 602)), both into m_max = 21,093
  rows. Per layer: the call's time one call a CUDA-graph replay (``ms``)
  and a call in a graph of 10 (``ms_graph``), the card ops a call, each
  op's own time (``op_ms``, ``torch.profiler`` over 20 calls),
  ``index_add_``'s time on the same messages, the byte bound (g, the edge
  lists and dh, each once, at 3.35 TB/s), the order's floor (the longest
  run's dependent adds at 4 cycles an add and the card's maximum SM
  clock), bit-equality with the CPU plain version and a second call
  (``same``); then every backward case of the tests
  (``tests/_torch_cases.py``), bit-equal to the CPU plain version, in
  its card ops.
- ``seg_sort``: the largest key stream the schedule compiler hands the
  kernel (layer 0 of an epoch: 2,097,152 composite keys of 20 bits,
  recorded from the device compiler run on the CPU). The same timings,
  each op's own time in launch order (the histogram, then each pass),
  ``torch.sort(stable=True)``'s time, the byte bound (each key read and
  written once) and the design's floor (the keys read by the histogram
  and by every pass, written by every pass: ``passes`` from the run's
  own ``seg_sort.passes``), bit-equality with ``seg_sort_ref`` and a
  second call; then sizes around the run's own tile and cluster
  boundaries (its ``TILE`` and ``CLUSTER``), with and
  without payload and with sentinels between keys, bit-equal to the
  plain version in at most 1 + passes card ops.

Per run one JSON line, with the card's name and power limit. Unpack the
parent with ``git archive`` into a git-ignored directory such as
``build/parent`` for OLD.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
INPUTS = os.path.join(ROOT, "build", "train_ab_inputs.npz")
KERNELS = ("gather_agg_bwd", "seg_sort")
#: (tiles, clusters, extra keys, num_bits, payload): n = tiles * TILE +
#: clusters * CLUSTER * TILE + extra, around tile and cluster boundaries,
#: num_bits across the pass counts, many tiles
SORT_SIZES = ((1, 0, -1, 20, True), (1, 0, 1, 31, False),
              (0, 1, -1, 20, True), (0, 1, 1, 21, False),
              (0, 2, -1, 22, True), (0, 2, 0, 20, False),
              (0, 2, 1, 20, True), (0, 0, 2 ** 20 + 3, 31, True))


def build_inputs() -> None:
    """The first training batch's padded edge lists, as the runner hands
    them to the train step in ``chip_smoke.py``'s phase 4, and the
    largest keys-only stream the schedule compiler sorts."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch

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
    _, _, seen = cs.build_device_schedule(torch, torch.device("cpu"), exp,
                                          sampler, pg)
    out["sort_keys"] = seen["keys"].numpy()
    out["sort_bits"] = seen["num_bits"]
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    np.savez(INPUTS, **out)


def bwd_rows(torch, dev, z, cs) -> dict:
    from repro_torch.kernels.gather_agg import ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_ref
    m, fanouts, dims = int(z["m_max"]), z["fanouts"], z["dims"]
    out = {}
    mhz = cs.max_sm_mhz()
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
            "ms": cs.device_ms(torch, fn),
            "ms_graph": cs.device_ms_per_call(torch, fn, calls=10),
            "card_ops": cs.device_ops(torch, fn),
            "op_ms": cs.op_times_ms(torch, fn),
            "index_add_ms": cs.device_ms(torch, library),
            "bound_ms": 1e3 * nbytes / cs.MEM_BYTES_PER_S,
            "longest_run": longest,
            "order_floor_ms": longest * cs.ADD_CYCLES / (mhz * 1e3)}
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
                       "card_ops": len(cs.device_ops(torch, case))}
    out["cases"] = cases
    return out


def sort_rows(torch, dev, z, cs) -> dict:
    from repro_torch.kernels.seg_sort import ops
    from repro_torch.kernels.seg_sort.ref import seg_sort_ref
    from repro_torch.kernels.seg_sort import seg_sort as ssm
    passes = ssm.passes
    keys = torch.from_numpy(z["sort_keys"]).to(dev)
    bits = int(z["sort_bits"])
    n, p = keys.shape[0], passes(bits)

    def fn():
        return ops.seg_sort(keys, num_bits=bits)
    got, again = fn()[0], fn()[0]
    want = seg_sort_ref(keys)[0]
    out = {"shape": f"n={n} num_bits={bits}", "passes": p,
           "bit_equal": bool(torch.equal(got, want)),
           "same": bool(torch.equal(got, again)),
           "ms": cs.device_ms(torch, fn),
           "ms_graph": cs.device_ms_per_call(torch, fn, calls=10),
           "card_ops": cs.device_ops(torch, fn),
           "op_ms": cs.op_times_ms(torch, fn),
           "sort_ms": cs.device_ms(torch, lambda: torch.sort(keys,
                                                             stable=True)),
           "bound_ms": 1e3 * n * 8 / cs.MEM_BYTES_PER_S,
           "design_floor_ms": 1e3 * n * 4 * (1 + 2 * p) / cs.MEM_BYTES_PER_S}
    cases = {}
    rng = np.random.default_rng(29)
    for tiles, clusters, extra, b, with_pay in SORT_SIZES:
        # a design without clusters counts a tile a cluster
        n = (tiles + clusters * getattr(ssm, "CLUSTER", 1)) * ssm.TILE + extra
        k = rng.integers(0, 1 << b, size=n).astype(np.int32)
        k[rng.random(n) < 0.2] = 2 ** 31 - 1
        tk = torch.from_numpy(k).to(dev)
        tp = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev) \
            if with_pay else None

        def case():
            return ops.seg_sort(tk, tp, num_bits=b)
        (sk, sp), (wk, wp) = case(), seg_sort_ref(tk, tp)
        cases[f"n={n} num_bits={b}{' payload' if with_pay else ''}"] = {
            "bit_equal": bool(torch.equal(sk, wk) and (
                sp is None or torch.equal(sp, wp))),
            "card_ops": len(cs.device_ops(torch, case)),
            "passes": passes(b)}
    out["cases"] = cases
    return out


def child(src: str, only: tuple) -> dict:
    import torch
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, src)
    import chip_smoke as cs
    dev = torch.device("cuda", 0)
    z = np.load(INPUTS)
    out = {"src": src, "card": cs.card_line()}
    if "seg_sort" in only:
        out["seg_sort"] = sort_rows(torch, dev, z, cs)
    if "gather_agg_bwd" in only:
        out["gather_agg_bwd"] = bwd_rows(torch, dev, z, cs)
    return out


def main() -> int:
    args = sys.argv[1:]
    only = KERNELS
    if args[:1] == ["--only"] and len(args) > 1:
        only, args = (args[1],), args[2:]
        if only[0] not in KERNELS:
            print(f"--only takes one of {KERNELS}", file=sys.stderr)
            return 2
    if args[:1] == ["--child"] and len(args) == 2:
        print(json.dumps(child(args[1], only)), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    if not os.path.exists(INPUTS):
        build_inputs()
    pick = ["--only", only[0]] if len(only) == 1 else []
    rc = 0
    for spec in args:
        p = subprocess.run([sys.executable, __file__, *pick, "--child",
                            spec], timeout=900)
        rc = rc or p.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
