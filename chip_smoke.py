#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises, so the exit code is non-zero):

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per kernel family, all started together).
2. Serve requests through ``GNNInferenceService`` on ``cuda`` at the
   paper's GraphSAGE width (``configs/rapidgnn_paper.py`` ``sage``):
   ``reddit_sim`` (d=602, 50 classes), 4 greedy partitions, worker 0,
   hidden 256, 2 layers, fan-outs (25, 10), n_hot 4096, 64 seeds per
   request, 4 requests per micro-batch, ``agg_backend="kernel"``.
   First uncached, then ``warm_now()``, then fresh. Every response must
   be bit-equal to ``oracle()``, and every kernel's launch count (set to
   0 just before serving, read just after) must have risen. Two
   responses are also held against the same service run on the CPU
   through the plain PyTorch versions (``rtol=1e-4, atol=1e-5``). Then
   one fresh micro-batch is stepped synchronously and split into host
   time and program time, and traced for the card's busy share.
3. Hold each kernel against its plain PyTorch version on the card, at
   the shapes the served micro-batch gives it and at awkward shapes
   (``search``/``assemble`` exact, ``gather_agg`` to
   ``rtol=1e-5, atol=1e-6``), and time kernel, plain version and, where
   one exists, the single PyTorch library call computing the same
   function (``torch.searchsorted`` for ``search``, ``F.embedding_bag``
   for ``gather_agg``; CUDA-graph replays timed with CUDA events).
4. Train: the paper's RapidGNN pipeline on one card at the same width
   (``sage("reddit_sim", 1000)``: batch 1000, hidden 256, fan-outs
   (25, 10), n_hot 4096, Q 4, AdamW lr 3e-3, parameters from a seed).
   The schedule for 2 epochs is compiled on the card (``seg_sort``) and
   must be bit-equal to the numpy compiler's; then ``RapidGNNRunner``
   trains 2 epochs x 10 steps through the ``gather_agg`` forward and
   backward kernels, with every launch count (set to 0 before the
   schedule build, read after the run) risen and ``gather_agg_bwd``
   launched once a step (layer 1 only). The first 3 losses must agree
   with the same steps on the CPU (plain versions) to ``rtol=1e-4,
   atol=1e-5`` and a second card run must give the same loss curve bit
   for bit. Prints build ms per epoch for each compiler, steps/s, the
   per-step prefetch stall and compute (H2D copy and step apart), the
   peak device memory and a traced split of the card's time by op.
5. Hold ``seg_sort`` (the compiler's largest stream, keys only, and the
   backward's by-source sort, with a payload; bit-equal) and
   ``gather_agg_bwd`` (layer 1's shapes, and layer 0's for reference;
   ``rtol=atol=1e-5``, and two runs bit-equal) against their plain
   versions on the card, with their times beside ``torch.sort`` and
   ``index_add_``.

Output: one ``kernel {...}`` line per kernel, the card's name and power
limit, one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the full record of a run is written (listed in .gitignore)
OUT_DIR = os.path.join(HERE, "artifacts")

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the non-tensor
#: fp32 / int32 operation rate
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

DATASET = "reddit_sim"
PARTS = 4
WORKER = 0
SEEDS_PER_REQUEST = 64
MAX_BATCH_REQUESTS = 4
UNCACHED_REQUESTS = 8
FRESH_REQUESTS = 24
CPU_CHECKS = 2
TRAIN_BATCH = 1000
TRAIN_EPOCHS = 2
TRAIN_LR = 3e-3
CPU_LOSS_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def device_ms(torch, fn, iters: int = 20) -> float:
    """Device time of one ``fn()`` call: ``fn`` is captured once in a
    CUDA graph and the graph replayed ``iters`` times between CUDA
    events, so host launch overhead is not counted."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return p.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: the served path
# ---------------------------------------------------------------------------

def build_world(torch, device):
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.graph import KHopSampler, load_dataset, partition_graph
    from repro_torch.models.gnn import GNNConfig, init_params

    exp = sage(DATASET, SEEDS_PER_REQUEST, workers=PARTS)
    t0 = time.perf_counter()
    g = load_dataset(exp.dataset, seed=0)
    pg = partition_graph(g, exp.num_workers, "greedy")
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    params = init_params(cfg, torch.Generator().manual_seed(exp.s0))
    log(f"world: {exp.dataset} nodes={g.num_nodes} edges={g.num_edges} "
        f"d={g.feat_dim} classes={g.num_classes} parts={exp.num_workers} "
        f"fanouts={exp.fanouts} hidden={exp.hidden_dim} "
        f"n_hot={exp.n_hot} built in {time.perf_counter() - t0:.2f} s")
    return exp, g, pg, sampler, cfg, params


def serve(torch, device, exp, g, pg, sampler, cfg, params, counters):
    import numpy as np
    from repro_torch.graph.sampler import rng_from
    from repro_torch.serve.gnn import (TIER_FRESH, TIER_UNCACHED,
                                       GNNInferenceService)

    svc = GNNInferenceService(
        pg, sampler, cfg, params, s0=exp.s0, worker=WORKER,
        n_hot=exp.n_hot, max_batch_requests=MAX_BATCH_REQUESTS,
        high_water=256, default_timeout_s=60.0, warm_interval_s=3600.0,
        device=device)
    log(f"service: m_max={svc.collator.m_max} "
        f"edge_max={svc.collator.edge_max} "
        f"rows/micro-batch={MAX_BATCH_REQUESTS * svc.collator.m_max}")
    rng = rng_from(exp.s0, 0x5345)
    streams = [rng.integers(0, g.num_nodes, size=SEEDS_PER_REQUEST)
               for _ in range(UNCACHED_REQUESTS + FRESH_REQUESTS)]
    responses, phases = [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    svc.start()
    try:
        for tier, lo, hi in ((TIER_UNCACHED, 0, UNCACHED_REQUESTS),
                             (TIER_FRESH, UNCACHED_REQUESTS, len(streams))):
            if tier == TIER_FRESH:
                if not svc.warmer.warm_now():
                    raise RuntimeError("warm cycle published nothing")
            t0 = time.perf_counter()
            pendings = [svc.submit(s) for s in streams[lo:hi]]
            got = [p.result(timeout=600.0) for p in pendings]
            wall = time.perf_counter() - t0
            lat = sorted(r.latency_s for r in got)
            bad = [r.rid for r in got if r.tier != tier]
            if bad:
                raise RuntimeError(f"requests {bad} not served {tier}")
            phases[tier] = {
                "requests": len(got), "wall_s": wall,
                "requests_per_s": len(got) / wall,
                "p50_ms": 1e3 * lat[len(lat) // 2],
                "p99_ms": 1e3 * lat[min(len(lat) - 1,
                                        int(0.99 * len(lat)))]}
            responses += got
        torch.cuda.synchronize()
        launches = {c.name: c.value for c in counters}
        peak = torch.cuda.max_memory_allocated()
    finally:
        svc.close()
    err = svc.pending_error()
    if err is not None:
        raise RuntimeError(f"dispatcher failed: {err!r}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} was not launched while "
                               f"serving")
    # correctness: finite logits of the expected shape, bit-equal to the
    # clean single-request oracle
    for r in responses:
        if r.logits.shape != (SEEDS_PER_REQUEST, g.num_classes) or \
                not np.isfinite(r.logits).all():
            raise RuntimeError(f"request {r.rid}: bad logits "
                               f"{r.logits.shape}")
        want = svc.oracle(streams[r.rid], r.rid)
        if not (want.tobytes() == r.logits.tobytes()):
            raise RuntimeError(f"request {r.rid} is not bit-equal to "
                               f"the oracle")
    health = svc.health()
    for k, n in (("served_uncached", UNCACHED_REQUESTS),
                 ("served_fresh", FRESH_REQUESTS), ("errors", 0)):
        if health[k] != n:
            raise RuntimeError(f"health {k}={health[k]}, expected {n}")
    log(f"served {len(responses)} requests, all bit-equal to the oracle; "
        f"launches while serving {json.dumps(launches)}")
    for tier, ph in phases.items():
        log(f"serve {tier}: {ph['requests']} requests in "
            f"{ph['wall_s']:.3f} s = {ph['requests_per_s']:.2f} req/s, "
            f"p50 {ph['p50_ms']:.2f} ms, p99 {ph['p99_ms']:.2f} ms")
    log(f"peak device memory while serving: {peak / 2**20:.1f} MiB")
    log(f"health: {json.dumps(health)}")
    return svc, streams, responses, launches, phases, peak


def check_against_cpu(exp, pg, sampler, cfg, params, streams, responses):
    """The same service on the CPU (plain PyTorch versions) for a few
    requests: the card's responses must agree to the reference's
    cross-program tolerance."""
    import numpy as np
    from repro_torch.serve.gnn import GNNInferenceService

    cpu = GNNInferenceService(
        pg, sampler, cfg, params, s0=exp.s0, worker=WORKER,
        n_hot=exp.n_hot, max_batch_requests=MAX_BATCH_REQUESTS,
        device="cpu")
    try:
        worst = 0.0
        for r in responses[:CPU_CHECKS]:
            want = cpu.oracle(streams[r.rid], r.rid)
            np.testing.assert_allclose(r.logits, want, rtol=1e-4, atol=1e-5)
            worst = max(worst, float(np.abs(r.logits - want).max()))
    finally:
        cpu.close()
    log(f"card vs CPU plain path: {CPU_CHECKS} responses within "
        f"rtol=1e-4 atol=1e-5 (max abs diff {worst:.3e})")


def breakdown(torch, device, exp, pg, sampler, cfg, params, streams):
    """Where the time of one full fresh micro-batch goes. A second
    service on the card is stepped synchronously (no dispatcher thread);
    its program (H2D copies, kernels, GEMMs, D2H copy) is timed on the
    host clock with the card synchronised, the rest of the step
    (collation, host assembly, residual pulls) is host time, and one more
    step is traced by ``torch.profiler`` for the card's busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.gnn import GNNInferenceService

    svc = GNNInferenceService(
        pg, sampler, cfg, params, s0=exp.s0, worker=WORKER,
        n_hot=exp.n_hot, max_batch_requests=MAX_BATCH_REQUESTS,
        default_timeout_s=60.0, device=device)
    program, program_s = svc.program, []

    def timed_program(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = program(*args)          # ends in a D2H copy: synchronised
        program_s.append(time.perf_counter() - t0)
        return out
    svc.program = timed_program
    batch = streams[:MAX_BATCH_REQUESTS]

    def step() -> float:
        for s in batch:
            svc.submit(s)
        t0 = time.perf_counter()
        if svc.step(timeout=1.0) != len(batch):
            raise RuntimeError("breakdown step served a partial batch")
        return time.perf_counter() - t0
    try:
        step()                        # uncached: gives the warmer traffic
        if not svc.warmer.warm_now():
            raise RuntimeError("warm cycle published nothing")
        step()
        program_s.clear()
        step_s = sorted(step() for _ in range(3))[1]
        prog_s = sorted(program_s)[1]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            traced_s = step()
    finally:
        svc.close()
    # the card's own events (kernels, copies, memsets); the CPU ops that
    # launched them carry the same time again, so they are left out
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    out = {"step_ms": 1e3 * step_s, "program_ms": 1e3 * prog_s,
           "host_ms": 1e3 * (step_s - prog_s),
           "traced_step_ms": 1e3 * traced_s, "card_busy_ms": busy_us / 1e3,
           "card_busy_share": busy_us / 1e6 / traced_s,
           "top_device_ms": {e.key: e.self_device_time_total / 1e3
                             for e in top}}
    log(f"fresh micro-batch ({MAX_BATCH_REQUESTS} requests): step "
        f"{out['step_ms']:.2f} ms = program {out['program_ms']:.2f} ms + "
        f"host {out['host_ms']:.2f} ms; traced step "
        f"{out['traced_step_ms']:.2f} ms, card busy "
        f"{out['card_busy_ms']:.3f} ms ({100 * out['card_busy_share']:.2f} %)")
    log(f"card time by op in the traced step (ms): "
        f"{json.dumps(out['top_device_ms'])}")
    return out


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, and its times
# ---------------------------------------------------------------------------

def served_inputs(torch, device, svc, streams, responses):
    """The device inputs of one served micro-batch (the first R fresh
    requests), rebuilt deterministically: collation is rid-keyed and
    the features read straight from the table, as ``oracle()`` does."""
    import numpy as np
    from repro_torch.serve.gnn.request import InferenceRequest

    fresh = [r for r in responses if r.tier == "fresh"][:MAX_BATCH_REQUESTS]
    reqs = [InferenceRequest(rid=r.rid, seeds=streams[r.rid],
                             deadline=float("inf"), submitted_at=0.0)
            for r in fresh]
    mb = svc.collator.collate_micro_batch(reqs)
    ids, mask = mb.input_nodes, mb.input_mask
    dev = svc.dv.g2d[np.where(mask, ids, 0)]
    query = np.where(mask, dev, -1).astype(np.int32).reshape(-1)
    pulled = np.zeros(mask.shape + (svc.store.d,), np.float32)
    pulled[mask] = svc.store.feat[ids[mask]]
    snap, _ = svc.warmer.snapshot()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"table": svc._table, "base": svc._base,
            "cache_ids": t(snap.dev_ids), "cache_feats": t(snap.dev_feats),
            "query": t(query), "pulled": t(pulled.reshape(-1, svc.store.d)),
            "edge_src": [t(e) for e in mb.edge_src],
            "edge_mask": [t(e) for e in mb.edge_mask],
            "params": svc.params, "fanouts": svc.cfg.fanouts,
            "R": MAX_BATCH_REQUESTS, "m": svc.collator.m_max}


def embedding_bag_mean(torch, h, src, msk, nd: int, fanout: int):
    """The one-call library yardstick of ``gather_agg``:
    ``F.embedding_bag`` in mean mode, one bag of ``fanout`` indices per
    dst row. A masked edge points at a row that no unmasked edge reads,
    named ``padding_idx``, so it neither adds nor counts. -> the call, or
    None when every row of ``h`` is read."""
    import torch.nn.functional as F
    read = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    read[src.long()[msk]] = True
    free = torch.nonzero(~read)
    if free.shape[0] == 0:
        return None
    pad = int(free[0, 0].item())
    idx = torch.where(msk, src.long(), pad).reshape(nd, fanout)
    return lambda: F.embedding_bag(idx, h, mode="mean", padding_idx=pad)


def _equal(torch, a, b) -> float:
    if not torch.equal(a, b):
        diff = (a.double() - b.double()).abs().max().item()
        raise RuntimeError(f"kernel differs from its plain version "
                           f"(max abs diff {diff})")
    return 0.0


def awkward_cases(torch, device):
    """(name, cache_ids, cache_feats, table, base, query, pulled) with
    shapes the tile-free kernels must still take: m = 1, an empty cache,
    d not a multiple of 4 or 128, all-hit, all-local, -1 and sentinel
    queries."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    sentinel = 2 ** 31 - 1
    out = []
    for name, m, n_hot, d, kind in (("m_one", 1, 8, 33, "mixed"),
                                    ("empty_cache", 257, 0, 602, "mixed"),
                                    ("d_130", 1000, 64, 130, "mixed"),
                                    ("all_hit", 300, 64, 602, "hit"),
                                    ("all_local", 300, 16, 5, "local"),
                                    ("padded", 513, 32, 7, "padded")):
        n_per, base, n_total = 200, 400, 2000
        table = torch.randn((n_per, d), generator=gen)
        remote = torch.cat([torch.arange(0, base),
                            torch.arange(base + n_per, n_total)])
        ids = remote[torch.randperm(remote.shape[0], generator=gen)[:n_hot]]
        ids = ids.sort().values.to(torch.int32)
        feats = torch.randn((n_hot, d), generator=gen)
        if kind == "hit":
            q = ids[torch.randint(0, n_hot, (m,), generator=gen)]
        elif kind == "local":
            q = torch.randint(base, base + n_per, (m,), generator=gen)
        else:
            q = torch.randint(0, n_total, (m,), generator=gen)
            if n_hot:
                q[::3] = ids[torch.randint(0, n_hot, (q[::3].shape[0],),
                                           generator=gen)]
            if kind == "padded":
                q[::4] = -1
                q[1::6] = sentinel
        q = q.to(torch.int32)
        pulled = torch.randn((m, d), generator=gen)
        out.append((name, *(x.to(device) for x in (ids, feats, table)),
                    base, q.to(device), pulled.to(device)))
    return out


def kernel_phase(torch, device, x, launches):
    from repro_torch.kernels.assemble import ops as assemble_ops
    from repro_torch.kernels.assemble.ref import assemble_ref, select_ref
    from repro_torch.kernels.cache_lookup import ops as search_ops
    from repro_torch.kernels.cache_lookup.ref import search_ref
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_ref

    R, m, d = x["R"], x["m"], x["pulled"].shape[1]
    M = R * m
    ids, q, pulled = x["cache_ids"], x["query"], x["pulled"]
    table, base, feats = x["table"], x["base"], x["cache_feats"]
    n_hot = ids.shape[0]
    results = []

    # -- search ------------------------------------------------------------
    pos, hit = search_ops.search(ids, q)
    err = _equal(torch, pos, search_ref(ids, q)[0])
    _equal(torch, hit, search_ref(ids, q)[1])
    nbytes = M * 4 + n_hot * 4 + M * 4 + M * 1
    ops = M * max(1, n_hot.bit_length())
    b, by = bound_ms(nbytes, ops)
    results.append({
        "name": "search", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_lookup/csrc/search.cu",
        "replaces": "src/repro/kernels/cache_lookup/cache_lookup.py:49",
        "launches": launches["search"], "max_abs_err": err,
        "ms": device_ms(torch, lambda: search_ops.search(ids, q)),
        "plain_ms": device_ms(torch, lambda: search_ref(ids, q)),
        "bound_ms": b, "bound_by": by,
        "library_ms": device_ms(torch, lambda: torch.searchsorted(
            ids, q, out_int32=True)),
        "shape": f"queries={M} n_hot={n_hot}",
        "hit_rate": float(hit.float().mean().item())})

    # -- assemble (the select pass over the search outputs) ----------------
    out = assemble_ops.select(table, base, feats, q, pos, hit, pulled)
    err = _equal(torch, out, select_ref(table, base, feats, q, pos, hit,
                                        pulled))
    _equal(torch, out, assemble_ref(table, base, ids, feats, q, pulled))
    nbytes = 2 * M * d * 4 + M * (4 + 4 + 1)
    b, by = bound_ms(nbytes, 0)
    results.append({
        "name": "assemble", "route": "cuda",
        "source": "src/repro_torch/kernels/assemble/csrc/assemble.cu",
        "replaces": "src/repro/kernels/assemble/assemble.py:56",
        "launches": launches["assemble"], "max_abs_err": err,
        "ms": device_ms(torch, lambda: assemble_ops.select(
            table, base, feats, q, pos, hit, pulled)),
        "plain_ms": device_ms(torch, lambda: select_ref(
            table, base, feats, q, pos, hit, pulled)),
        "bound_ms": b, "bound_by": by, "library_ms": None,
        "shape": f"rows={M} d={d} n_hot={n_hot} n_per={table.shape[0]}"})

    # -- gather_agg, layer 0 then layer 1 of the served forward ------------
    layers = []
    h = out
    for l, fo in enumerate(x["fanouts"]):
        es, em = x["edge_src"][l], x["edge_mask"][l]
        nd = es.shape[1] // fo
        shift = (torch.arange(R, dtype=torch.int32, device=device)
                 * m)[:, None]
        src = (es + shift).reshape(-1)
        msk = em.reshape(-1).contiguous()
        got = gather_ops.gather_agg(h, src, msk, nd=R * nd, fanout=fo)
        want = gather_agg_ref(h, src, msk, R * nd, fo)
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-6):
            raise RuntimeError(f"gather_agg layer {l} differs from its "
                               f"plain version")
        layer_err = (got - want).abs().max().item()
        used = src.long()[msk]
        nbytes = (torch.unique(used).shape[0] * h.shape[1] * 4
                  + R * nd * h.shape[1] * 4 + src.shape[0] * (4 + 1))
        ops = int(msk.sum().item()) * h.shape[1] + R * nd * h.shape[1]
        hh, ss, mm, n_ = h, src, msk, R * nd
        lib = embedding_bag_mean(torch, h, src, msk, R * nd, fo)
        if lib is not None and not torch.allclose(lib(), want, rtol=1e-5,
                                                  atol=1e-6):
            raise RuntimeError(f"embedding_bag yardstick of layer {l} "
                               f"computes another function")
        layers.append({
            "err": layer_err, "bound": bound_ms(nbytes, ops),
            "ms": device_ms(torch, lambda: gather_ops.gather_agg(
                hh, ss, mm, nd=n_, fanout=fo)),
            "plain_ms": device_ms(torch, lambda: gather_agg_ref(
                hh, ss, mm, n_, fo)),
            "library_ms": None if lib is None else device_ms(torch, lib),
            "shape": f"h=({h.shape[0]},{h.shape[1]}) nd={R * nd} "
                     f"fanout={fo} unmasked={int(msk.sum().item())}"})
        log(f"gather_agg layer {l}: {layers[-1]['shape']} "
            f"ms={layers[-1]['ms']:.4f} plain_ms="
            f"{layers[-1]['plain_ms']:.4f} library_ms="
            f"{layers[-1]['library_ms']} bound_ms="
            f"{layers[-1]['bound'][0]:.4f}")
        # next layer's input: this layer's SAGE update of the same rows
        p = x["params"]["layers"][l]
        agg = torch.cat([got.reshape(R, nd, -1),
                         got.new_zeros((R, m - nd, got.shape[1]))], dim=1)
        h3 = h.reshape(R, m, -1)
        h = torch.relu(h3 @ p["w_self"] + agg @ p["w_neigh"] + p["b"]) \
            .reshape(M, -1).contiguous()
    results.append({
        "name": "gather_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/gather_agg/csrc/gather_agg.cu",
        "replaces": "src/repro/kernels/gather_agg/gather_agg.py:30",
        "launches": launches["gather_agg"],
        "max_abs_err": max(L["err"] for L in layers),
        "ms": sum(L["ms"] for L in layers),
        "plain_ms": sum(L["plain_ms"] for L in layers),
        "bound_ms": sum(L["bound"][0] for L in layers),
        "bound_by": layers[0]["bound"][1],
        "library_ms": (None if any(L["library_ms"] is None for L in layers)
                       else sum(L["library_ms"] for L in layers)),
        "shape": " + ".join(L["shape"] for L in layers)})

    # -- awkward shapes ------------------------------------------------------
    for name, cids, cfeats, tab, b0, qq, pp in awkward_cases(torch, device):
        got = assemble_ops.assemble_features(tab, b0, cids, cfeats, qq, pp,
                                             backend="fused")
        _equal(torch, got, assemble_ref(tab, b0, cids, cfeats, qq, pp))
        if cids.shape[0]:
            p1, h1 = search_ops.search(cids, qq)
            p2, h2 = search_ref(cids, qq)
            _equal(torch, p1, p2)
            _equal(torch, h1, h2)
        nd_, fo_ = max(1, pp.shape[0] // 7), 7
        gsrc = (qq.abs() % pp.shape[0]).repeat(fo_)[:nd_ * fo_] \
            .contiguous()
        gmsk = (torch.arange(nd_ * fo_, device=device) % 3) != 0
        ga = gather_ops.gather_agg(pp, gsrc, gmsk, nd=nd_, fanout=fo_)
        _equal(torch, ga, gather_agg_ref(pp, gsrc, gmsk, nd_, fo_))
    log("awkward shapes: search, assemble and gather_agg equal to their "
        "plain versions")
    torch.cuda.synchronize()
    return results


# ---------------------------------------------------------------------------
# phase 4: the training path
# ---------------------------------------------------------------------------

def train_world(g):
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.graph import KHopSampler
    from repro_torch.models.gnn import GNNConfig

    exp = sage(DATASET, TRAIN_BATCH, workers=PARTS, epochs=TRAIN_EPOCHS)
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    return exp, sampler, cfg


def schedule_kw(exp):
    return dict(worker=WORKER, s0=exp.s0, num_epochs=exp.num_epochs,
                n_hot=exp.n_hot)


def build_device_schedule(torch, device, exp, sampler, pg):
    """The schedule compiled on the card, with the largest key stream
    the compiler handed ``seg_sort`` kept (a copy) for the kernel rows."""
    import repro_torch.graph.device_sampler as dsm
    from repro_torch.core import build_schedule

    real, seen = dsm.seg_sort, {"n": -1}

    def recording(keys, payload=None, **kw):
        if payload is None and keys.shape[0] > seen["n"]:
            seen.update(n=keys.shape[0], keys=keys.clone(),
                        num_bits=kw["num_bits"])
        return real(keys, payload, **kw)
    dsm.seg_sort = recording
    try:
        t0 = time.perf_counter()
        ws = build_schedule(sampler, pg, compiler="device", device=device,
                            **schedule_kw(exp))
        seconds = time.perf_counter() - t0
    finally:
        dsm.seg_sort = real
    return ws, seconds, seen


def check_schedules_equal(ref, dev, n_epochs: int) -> None:
    """Every FlatEpoch array (dtype too), the hot set, the remote ids and
    frequencies and the pad bounds: bit-equal, or raise."""
    import numpy as np

    def same(a, b, what):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError(f"device-compiled schedule differs from the "
                               f"numpy compiler's: {what}")
    for e in range(n_epochs):
        a, b = ref.epoch(e), dev.epoch(e)
        if a.m_max != b.m_max:
            raise RuntimeError(f"epoch {e}: m_max {a.m_max} != {b.m_max}")
        for f in ("seeds", "seed_starts", "input_nodes", "input_starts",
                  "num_dst"):
            same(getattr(a.flat, f), getattr(b.flat, f), f"epoch {e} {f}")
        for f in ("edge_src", "edge_dst", "edge_mask", "edge_starts"):
            for l, (x, y) in enumerate(zip(getattr(a.flat, f),
                                           getattr(b.flat, f))):
                same(x, y, f"epoch {e} {f}[{l}]")
        for f in ("cache_ids", "remote_ids", "remote_freq"):
            same(getattr(a, f), getattr(b, f), f"epoch {e} {f}")
    if ref.pad_bounds() != dev.pad_bounds():
        raise RuntimeError(f"pad bounds {ref.pad_bounds()} != "
                           f"{dev.pad_bounds()}")


def train_run(torch, device, exp, cfg, ws, pg, capture: int = 0):
    """``RapidGNNRunner`` over the schedule with the port's train step on
    ``device``, parameters from ``exp.s0``. -> per-step losses, the run's
    metrics and wall time, the first ``capture`` (features, batch)
    pairs the step was given, and per-step (H2D, step) host seconds."""
    from repro_torch.core import (NetworkModel, RapidGNNRunner,
                                  ShardedFeatureStore)
    from repro_torch.models.gnn import (batch_to_device, init_params,
                                        make_train_step)
    from repro_torch.train import AdamW

    params = init_params(cfg, torch.Generator().manual_seed(exp.s0), device)
    opt = AdamW(lr=TRAIN_LR)
    state = [params, opt.init(params)]
    step = make_train_step(cfg, opt)
    hist, captured, split = [], [], []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def train_fn(feats, cb):
        if len(captured) < capture:
            captured.append((feats.copy(), cb))
        t0 = time.perf_counter()
        batch = batch_to_device(cb, feats, device)
        sync()
        t1 = time.perf_counter()
        state[0], state[1], aux = step(state[0], state[1], batch)
        hist.append(float(aux["loss"]))       # waits for the step
        split.append((t1 - t0, time.perf_counter() - t1))
        return hist[-1]

    store = ShardedFeatureStore(pg, worker=WORKER,
                                net=NetworkModel(enabled=False))
    runner = RapidGNNRunner(ws, store, batch_size=exp.batch_size, Q=exp.Q,
                            train_fn=train_fn)
    t0 = time.perf_counter()
    metrics = runner.run()
    return hist, metrics, time.perf_counter() - t0, captured, split


def cpu_losses(torch, exp, cfg, captured):
    """The first steps again on the CPU (plain versions), from the same
    parameters and the same batches."""
    from repro_torch.models.gnn import (batch_to_device, init_params,
                                        make_train_step)
    from repro_torch.train import AdamW

    cpu = torch.device("cpu")
    params = init_params(cfg, torch.Generator().manual_seed(exp.s0), cpu)
    opt = AdamW(lr=TRAIN_LR)
    state, step, out = opt.init(params), make_train_step(cfg, opt), []
    for feats, cb in captured:
        params, state, aux = step(params, state,
                                  batch_to_device(cb, feats, cpu))
        out.append(float(aux["loss"]))
    return out


def trace_steps(torch, device, exp, cfg, captured):
    """Card time by op over the captured steps (H2D copy included),
    traced by ``torch.profiler``; parameters fresh from the seed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.gnn import (batch_to_device, init_params,
                                        make_train_step)
    from repro_torch.train import AdamW

    params = init_params(cfg, torch.Generator().manual_seed(exp.s0), device)
    opt = AdamW(lr=TRAIN_LR)
    state, step = opt.init(params), make_train_step(cfg, opt)
    feats, cb = captured[0]
    params, state, _ = step(params, state, batch_to_device(cb, feats, device))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for feats, cb in captured:
            params, state, aux = step(params, state,
                                      batch_to_device(cb, feats, device))
            float(aux["loss"])
        traced_s = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    n = len(captured)
    return {"steps": n, "traced_step_ms": 1e3 * traced_s / n,
            "card_busy_ms_per_step": busy_us / 1e3 / n,
            "card_busy_share": busy_us / 1e6 / traced_s,
            "top_device_ms_per_step": {
                e.key: e.self_device_time_total / 1e3 / n for e in top}}


def train_phase(torch, device, g, pg, counters):
    """Schedule on the card (bit-equal to the numpy compiler), then
    ``TRAIN_EPOCHS`` epochs of RapidGNN training through the kernels,
    held against the CPU and against a second run on the card."""
    import numpy as np
    from repro_torch.core import build_schedule

    exp, sampler, cfg = train_world(g)
    t0 = time.perf_counter()
    ref = build_schedule(sampler, pg, compiler="batched", **schedule_kw(exp))
    numpy_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    torch.cuda.reset_peak_memory_stats()
    ws, device_s, sort_input = build_device_schedule(torch, device, exp,
                                                     sampler, pg)
    hist, metrics, wall, captured, split = train_run(
        torch, device, exp, cfg, ws, pg, capture=CPU_LOSS_STEPS)
    torch.cuda.synchronize()
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()

    check_schedules_equal(ref, ws, exp.num_epochs)
    m_max, edge_max = ws.pad_bounds()
    log(f"train schedule: {exp.num_epochs} epochs x "
        f"{ws.epoch(0).num_batches} batches, m_max={m_max} "
        f"edge_max={edge_max}; device compiler bit-equal to numpy; build "
        f"ms per epoch: device {1e3 * device_s / exp.num_epochs:.1f}, "
        f"numpy {1e3 * numpy_s / exp.num_epochs:.1f}")
    steps = len(hist)
    want = sum(ws.epoch(e).num_batches for e in range(exp.num_epochs))
    if steps != want or not np.isfinite(hist).all():
        raise RuntimeError(f"{steps} steps of {want}, losses {hist}")
    if launches["seg_sort"] == 0 or launches["gather_agg"] == 0:
        raise RuntimeError(f"training did not launch every kernel of its "
                           f"path: {launches}")
    # one backward launch a step: layer 1 only, never layer 0, whose
    # input (the features) needs no gradient
    if launches["gather_agg_bwd"] != steps:
        raise RuntimeError(f"gather_agg_bwd launched "
                           f"{launches['gather_agg_bwd']} times in {steps} "
                           f"steps (once a step, at layer 1, expected)")
    cpu = cpu_losses(torch, exp, cfg, captured)
    np.testing.assert_allclose(hist[:CPU_LOSS_STEPS], cpu, rtol=1e-4,
                               atol=1e-5)
    again, _, wall2, _, _ = train_run(torch, device, exp, cfg, ws, pg)
    if again != hist:
        raise RuntimeError(f"a second run on the card gave another loss "
                           f"curve: {hist} vs {again}")
    tot = metrics.totals()
    h2d = sorted(a for a, _ in split)
    stp = sorted(b for _, b in split)
    out = {
        "schedule_ms_per_epoch": {"device": 1e3 * device_s / exp.num_epochs,
                                  "numpy": 1e3 * numpy_s / exp.num_epochs},
        "m_max": m_max, "edge_max": edge_max,
        "sort_stream": {"n": sort_input["n"],
                        "num_bits": sort_input["num_bits"]},
        "steps": steps, "losses": hist, "cpu_losses": cpu,
        "wall_s": wall, "wall_s_second_run": wall2,
        "steps_per_s": steps / wall,
        "prefetch_stall_ms_per_step": 1e3 * tot["fetch_stall_s"] / steps,
        "compute_ms_per_step": 1e3 * tot["compute_time_s"] / steps,
        "h2d_ms_median": 1e3 * h2d[len(h2d) // 2],
        "step_ms_median": 1e3 * stp[len(stp) // 2],
        "peak_bytes": peak, "launches": launches,
        "counters": {k: int(tot[k]) for k in (
            "rpc_count", "remote_bytes", "vector_pull_bytes", "cache_hits",
            "cache_misses", "prefetch_hits", "default_path")},
        "trace": trace_steps(torch, device, exp, cfg, captured)}
    log(f"train: {steps} steps in {wall:.3f} s = {out['steps_per_s']:.2f} "
        f"steps/s (second run {wall2:.3f} s); per step: prefetch stall "
        f"{out['prefetch_stall_ms_per_step']:.2f} ms + compute "
        f"{out['compute_ms_per_step']:.2f} ms (of which H2D copy "
        f"{out['h2d_ms_median']:.2f} ms, step {out['step_ms_median']:.2f} "
        f"ms, medians); peak device memory {peak / 2**20:.1f} MiB")
    log(f"train losses {['%.6f' % x for x in hist]}; first "
        f"{CPU_LOSS_STEPS} within rtol=1e-4 atol=1e-5 of the CPU "
        f"{['%.6f' % x for x in cpu]}; second card run bit-identical")
    log(f"train launches {json.dumps(launches)}; counters "
        f"{json.dumps(out['counters'])}")
    tr = out["trace"]
    log(f"traced steps: {tr['traced_step_ms']:.2f} ms a step, card busy "
        f"{tr['card_busy_ms_per_step']:.3f} ms "
        f"({100 * tr['card_busy_share']:.2f} %); card ms a step by op: "
        f"{json.dumps(tr['top_device_ms_per_step'])}")
    return out, sort_input, captured, m_max, cfg


def train_kernel_phase(torch, device, cfg, sort_input, captured, m_max,
                       launches):
    """``seg_sort`` and ``gather_agg_bwd`` against their plain versions
    on the card, at the training path's shapes, with their times."""
    import numpy as np
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_bwd_ref
    from repro_torch.kernels.seg_sort import ops as sort_ops
    from repro_torch.kernels.seg_sort.ref import seg_sort_ref

    sentinel = 2 ** 31 - 1
    _, cb = captured[0]
    fanouts = cfg.fanouts

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def sort_row(keys, payload, num_bits, what):
        got = sort_ops.seg_sort(keys, payload, num_bits=num_bits)
        want = seg_sort_ref(keys, payload)
        _equal(torch, got[0], want[0])
        if payload is not None:
            _equal(torch, got[1], want[1])
        n = keys.shape[0]
        passes = -(-min(num_bits + 1, 32) // 8)
        per_key = 8 if payload is None else 16     # read + write once
        r = {"what": what, "n": n, "num_bits": num_bits,
             "bound": bound_ms(n * per_key, n * passes),
             "ms": device_ms(torch, lambda: sort_ops.seg_sort(
                 keys, payload, num_bits=num_bits)),
             "plain_ms": device_ms(torch, lambda: seg_sort_ref(
                 keys, payload)),
             "library_ms": device_ms(torch, lambda: torch.sort(
                 keys, stable=True))}
        log(f"seg_sort {what}: n={n} num_bits={num_bits} "
            f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f}")
        return r

    # the compiler's largest stream (layer 0 of an epoch), keys only,
    # and the backward's by-source sort of layer 1, with a payload
    src1, msk1 = t(cb.edge_src[1]), t(cb.edge_mask[1])
    bwd_keys = torch.where(msk1, src1, torch.full_like(src1, sentinel))
    bwd_ids = torch.arange(bwd_keys.shape[0], dtype=torch.int32,
                           device=device)
    sorts = [sort_row(sort_input["keys"], None, sort_input["num_bits"],
                      "layer-0 stream"),
             sort_row(bwd_keys, bwd_ids, max((m_max - 1).bit_length(), 1),
                      "backward by-source")]

    def bwd_row(layer, d, what, tol):
        """``tol`` (rtol = atol) bounds the kernel's distance from the
        plain version on the card, whose ``index_add_`` sums with atomics
        in no fixed order, and from the plain version on the CPU, which
        sums each row in edge order as the kernel does."""
        fo = fanouts[layer]
        src, msk = t(cb.edge_src[layer]), t(cb.edge_mask[layer])
        nd = src.shape[0] // fo
        gen = torch.Generator(device="cpu").manual_seed(layer)
        g = torch.randn((nd, d), generator=gen).to(device)
        got = gather_ops.gather_agg_bwd(g, src, msk, m=m_max, nd=nd,
                                        fanout=fo)
        again = gather_ops.gather_agg_bwd(g, src, msk, m=m_max, nd=nd,
                                          fanout=fo)
        want = gather_agg_bwd_ref(g, src, msk, m_max, nd, fo)
        cpu = gather_agg_bwd_ref(g.cpu(), src.cpu(), msk.cpu(), m_max, nd,
                                 fo)
        if not (torch.allclose(got, want, rtol=tol, atol=tol)
                and torch.allclose(got.cpu(), cpu, rtol=tol, atol=tol)):
            raise RuntimeError(f"gather_agg_bwd {what} differs from its "
                               f"plain version")
        if not torch.equal(got, again):
            raise RuntimeError(f"gather_agg_bwd {what}: two runs differ")
        cnt = msk.reshape(nd, fo).sum(1).float().clamp(min=1.0)
        msg = (g / cnt[:, None])[:, None, :].expand(nd, fo, d) \
            .reshape(nd * fo, d) * msk[:, None].float()
        src_l = src.long()

        def library():
            return torch.zeros((m_max, d), device=device).index_add_(
                0, src_l, msg)
        if not torch.allclose(library().cpu(), cpu, rtol=tol, atol=tol):
            raise RuntimeError("index_add_ yardstick computes another "
                               "function")
        unmasked = int(msk.sum().item())
        nbytes = nd * d * 4 + src.shape[0] * 5 + m_max * d * 4
        r = {"what": what, "err": (got - want).abs().max().item(),
             "bound": bound_ms(nbytes, 2 * unmasked * d),
             "ms": device_ms(torch, lambda: gather_ops.gather_agg_bwd(
                 g, src, msk, m=m_max, nd=nd, fanout=fo)),
             "plain_ms": device_ms(torch, lambda: gather_agg_bwd_ref(
                 g, src, msk, m_max, nd, fo)),
             "library_ms": device_ms(torch, library),
             "cpu_err": (got.cpu() - cpu).abs().max().item(),
             "shape": f"g=({nd},{d}) m={m_max} fanout={fo} "
                      f"unmasked={unmasked}"}
        log(f"gather_agg_bwd {what}: {r['shape']} ms={r['ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"bound_ms={r['bound'][0]:.4f} max_abs_err={r['err']:.3e} "
            f"(CPU plain version: {r['cpu_err']:.3e})")
        return r
    bwd1 = bwd_row(1, cfg.hidden_dim, "layer 1 (the path)", 1e-5)
    # layer 0's hub rows sum thousands of terms: the card's atomic order
    # moves the plain version by more than 1e-5 there
    bwd0 = bwd_row(0, cfg.in_dim, "layer 0 (for reference, not launched "
                                  "in training)", 1e-4)

    # awkward shapes
    gen = torch.Generator(device="cpu").manual_seed(9)
    for n, bits, payload in ((1, 3, True), (4095, 20, True),
                             (4097, 31, False), (700, 1, True)):
        keys = torch.randint(0, 1 << bits, (n,), generator=gen,
                             dtype=torch.int32)
        keys[::5] = sentinel
        pay = torch.randperm(n, generator=gen).to(torch.int32) \
            if payload else None
        keys = keys.to(device)
        pay = None if pay is None else pay.to(device)
        got = sort_ops.seg_sort(keys, pay, num_bits=bits)
        want = seg_sort_ref(keys, pay)
        _equal(torch, got[0], want[0])
        if pay is not None:
            _equal(torch, got[1], want[1])
    same = torch.full((3000,), 5, dtype=torch.int32, device=device)
    order = torch.arange(3000, dtype=torch.int32, device=device)
    _equal(torch, sort_ops.seg_sort(same, order, num_bits=4)[1], order)
    hub_src = torch.full((400,), 7, dtype=torch.int32, device=device)
    hub_msk = torch.ones(400, dtype=torch.bool, device=device)
    hub_msk[:10] = False
    hub_g = torch.randn((40, 33), generator=gen).to(device)
    got = gather_ops.gather_agg_bwd(hub_g, hub_src, hub_msk, m=9, nd=40,
                                    fanout=10)
    if not torch.allclose(got.cpu(), gather_agg_bwd_ref(
            hub_g.cpu(), hub_src.cpu(), hub_msk.cpu(), 9, 40, 10),
            rtol=1e-5, atol=1e-5):
        raise RuntimeError("gather_agg_bwd hub row differs")
    log("awkward shapes: seg_sort (n=1, 4095, 4097, all keys equal, "
        "num_bits 1/3/20/31, sentinels between keys) and gather_agg_bwd "
        "(one hub row, a zero-count dst row) equal to their plain versions")
    torch.cuda.synchronize()

    rows = [{
        "name": "seg_sort", "route": "cuda",
        "source": "src/repro_torch/kernels/seg_sort/csrc/radix_sort.cu",
        "replaces": "src/repro/kernels/seg_sort/seg_sort.py:46",
        "launches": launches["seg_sort"], "max_abs_err": 0.0,
        "ms": sum(r["ms"] for r in sorts),
        "plain_ms": sum(r["plain_ms"] for r in sorts),
        "bound_ms": sum(r["bound"][0] for r in sorts),
        "bound_by": sorts[0]["bound"][1],
        "library_ms": sum(r["library_ms"] for r in sorts),
        "shape": " + ".join(f"{r['what']} n={r['n']} num_bits="
                            f"{r['num_bits']}" for r in sorts),
        "parts": sorts}, {
        "name": "gather_agg_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/gather_agg/csrc/"
                  "gather_agg_bwd.cu",
        "replaces": "src/repro/kernels/gather_agg/ops.py:39",
        "launches": launches["gather_agg_bwd"], "max_abs_err": bwd1["err"],
        "ms": bwd1["ms"], "plain_ms": bwd1["plain_ms"],
        "bound_ms": bwd1["bound"][0], "bound_by": bwd1["bound"][1],
        "library_ms": bwd1["library_ms"], "shape": bwd1["shape"],
        "layer0_reference": bwd0}]
    for r in rows[0]["parts"] + [rows[1]["layer0_reference"]]:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found beside this "
              f"script", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import _build
    from repro_torch.kernels.assemble import ops as assemble_ops
    from repro_torch.kernels.cache_lookup import ops as search_ops
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.seg_sort import ops as sort_ops

    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(_build.FAMILIES)) as pool:
        list(pool.map(_build.library, _build.FAMILIES))
    log(f"build: {len(_build.FAMILIES)} kernel families in "
        f"{time.perf_counter() - t0:.2f} s ({_build.BUILD_DIR})")
    for fam in _build.FAMILIES:
        text = _build.library_path(fam).with_suffix(".log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {fam}: {line.strip()}")

    counters = [search_ops.LAUNCHES, assemble_ops.LAUNCHES,
                gather_ops.LAUNCHES]
    exp, g, pg, sampler, cfg, params = build_world(torch, device)
    svc, streams, responses, launches, phases, peak = serve(
        torch, device, exp, g, pg, sampler, cfg, params, counters)
    check_against_cpu(exp, pg, sampler, cfg, params, streams, responses)
    split = breakdown(torch, device, exp, pg, sampler, cfg, params, streams)

    x = served_inputs(torch, device, svc, streams, responses)
    kernels = kernel_phase(torch, device, x, launches)

    train_counters = counters + [gather_ops.BWD_LAUNCHES, sort_ops.LAUNCHES]
    train, sort_input, captured, m_max, train_cfg = train_phase(
        torch, device, g, pg, train_counters)
    kernels += train_kernel_phase(torch, device, train_cfg, sort_input,
                                  captured, m_max, train["launches"])
    for k in kernels:
        log("kernel " + json.dumps(
            {"kernel": k["name"], "ms": k["ms"], "plain_ms": k["plain_ms"],
             "library_ms": k["library_ms"], "launches": k["launches"],
             "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
             "max_abs_err": k["max_abs_err"], "shape": k["shape"]}))

    card = card_line()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "serve": phases,
                   "breakdown": split, "peak_bytes": peak,
                   "launches": launches, "train": train}, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
