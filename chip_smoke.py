#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure raises, so the exit code is non-zero):

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per kernel family, all started together; six families
   hold the ports of the seven TPU kernels).
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
   (all bit-exact; ``gather_agg`` also against a second run, one card
   operation a call, at d 1 / 3 / 130 / 256 / 602, each vector width and
   fan-outs up to 50), and time kernel, plain version and, where one
   exists, the single PyTorch library call computing the same function
   (``torch.searchsorted`` for ``search``, ``F.embedding_bag`` for
   ``gather_agg``; CUDA-graph replays timed with CUDA events, one call a
   replay and, for these short calls, 20 calls to a graph).
4. Train: the paper's RapidGNN pipeline on one card at the same width
   (``sage("reddit_sim", 1000)``: batch 1000, hidden 256, fan-outs
   (25, 10), n_hot 4096, Q 4, AdamW lr 3e-3, parameters from a seed).
   The schedule for 2 epochs is compiled on the card (``seg_sort``) and
   must be bit-equal to the numpy compiler's; then ``RapidGNNRunner``
   trains 2 epochs x 10 steps through the ``gather_agg`` forward and
   backward kernels, with every launch count (set to 0 before the
   schedule build, read after the run) risen, ``gather_agg_bwd``
   launched once a step (layer 1 only) and ``seg_sort`` only by the
   schedule compiler (the backward orders its edges in its own kernel).
   The first 3 losses must agree
   with the same steps on the CPU (plain versions) to ``rtol=1e-4,
   atol=1e-5`` and a second card run must give the same loss curve bit
   for bit. Prints build ms per epoch for each compiler, steps/s, the
   per-step prefetch stall and compute (H2D copy and step apart), the
   peak device memory and a traced split of the card's time by op.
5. Hold the ``gather_agg`` forward at training's two layer shapes (from
   the captured batch: bit-equal, one card operation a call, timed as in
   phase 3), ``seg_sort`` (the compiler's largest stream, keys only;
   bit-equal, at most 1 + passes card operations a call, beside its
   read-once bound and its own floor) and ``gather_agg_bwd`` (layer 1's
   shapes, and layer 0's for
   reference; bit-equal to the CPU plain version, which adds in edge
   order, and to a second run, and within ``rtol=atol=1e-5`` of the card
   plain version, whose ``index_add_`` adds in atomic order; at most 3
   card operations a call at layer 1, counted by ``torch.profiler``)
   against their plain versions on the card, with their times beside
   ``torch.sort`` and ``index_add_``.

6. Decode serving: gemma2-2b (``configs/gemma2_2b.py``) at its full width
   and depth in bfloat16, weights from a seeded ``torch.Generator`` on
   the card. (a) Prefill: ``forward`` at B=1, S=8192 (the repo's
   ``prefill_32k`` with S cut to 8192, still past the 4096 window), one
   ``flash_attention`` launch per layer (26), with its time, peak device
   memory and traced split of the card's time. (b) Decode: the
   ``serve_decode`` launcher's greedy loop at B=8, prompt 16, gen 32, one
   ``flash_decode`` launch per layer a step (26 x 47), with ms/step and
   tokens/s, and a second run bit-identical. (c) In float32 at full width
   over S=64: each decode step's logits against ``forward``'s, within
   ``atol=1e-3``. (d) Each new kernel against its plain version on the
   card: ``flash_attention`` on a local and a global layer's own q/k/v at
   the prefill shape (bfloat16, the tensor-core kernel, within one
   bfloat16 step, ``rtol=2^-7``; the same q/k/v in float32, the CUDA-core
   kernel, within ``rtol=1e-4, atol=1e-5``, and timed beside it, with
   SDPA in float32 and the bound at the float32 CUDA-core rate), and
   ``flash_decode`` over a long cache (B=16, S=32768, ``length``/``start``
   masks, softcap 50) and the decode loop's own caches (float32
   partials, ``rtol=1e-4, atol=1e-5``; one card operation a call), with
   their times beside SDPA (``enable_gqa``, the same mask, no softcap)
   and their byte bounds. A call of a few microseconds is also timed 20
   to a CUDA graph, beside a trivial kernel's time both ways: one call a
   replay is paced by the host's graph launches.
7. The device-distributed epoch: all 4 workers of ``reddit_sim`` in one
   process on the card (``make_mesh((4,), ("data",))``) at the paper's
   GraphSAGE width (``sage("reddit_sim", 1000)``, one epoch, AdamW lr
   3e-3). (a) ``make_pipelined_epoch`` with the fused and with the
   staged assembly and ``make_ondemand_epoch`` over empty caches, each
   twice in turns: every loss curve bit-equal to the first (the second
   fused run's weights too), the first 3 losses within ``rtol=1e-4,
   atol=1e-5`` of the same steps on the CPU. (b) Step 0, worker by
   worker: ``pull_features``' buffers equal the numpy rows at
   ``send_pos``, the staged, fused and host-gathered features are
   bit-equal, and the pull lanes equal ``host_miss_matrix``. (c) Launch
   counts (set to 0 before each run): ``merge_gather`` only in the
   staged runs, ``assemble`` only in the others. (d) ms/step of each run,
   the exchange's own ms a step (CUDA events), miss lanes of rapid and
   on-demand and their ratio, the wire bytes, peak memory and a traced
   split of the card's time. (e) The hot-token embedding lookup at
   gemma2-2b's widths (vocab 256,000, d 2,304, a 2.36 GB float32 table,
   8 workers x 16 x 256 tokens, n_hot 32,768): ``device_embedding_lookup``
   equal to ``table[tokens]`` bit for bit, with ``HotEmbeddingSim``'s
   traffic reduction. (f) ``merge_gather`` against its plain version at
   the staged epoch's and the embedding's shapes and awkward ones (d 1 /
   3 / 602 / 2304, m 0, an empty cache, all and no hits, bfloat16 and
   mixed dtypes, -1 and sentinel queries through ``cache_lookup``), all
   bit-exact, timed with CUDA-graph replays.

8. The multi-epoch runner: ``DeviceRapidGNNRunner`` over 3 epochs of
   the same 4 workers and width (``sage("reddit_sim", 1000)``, n_hot
   4096), staging epoch e+1 on a background thread while epoch e trains
   and swapping C_sec in at the boundary. (a) ``fused``, numpy
   schedules, flat, twice: ``trace_count`` 1, host parity on every
   epoch, the two curves and final weights bit-identical, the first 3
   losses within ``rtol=1e-4, atol=1e-5`` of the same steps on the CPU.
   (b) Lazy schedules compiled on the card (``compiler="device"``), so
   the staging thread launches ``seg_sort``: the curve bit-equal to
   (a), ``seg_sort`` launched. (c) ``DeviceBaselineRunner``: lanes never
   fewer than (a)'s, the curve bit-equal. (d) (a) on topology ``2x2``:
   the curve bit-equal, the tier lanes adding up to (a)'s and the tier
   wire rows to the run's own. (e) (a) checkpointed after epoch 1 into a
   run state, resumed by a fresh runner over [1, 3): the stitched curve
   and final weights bit-equal. (f) (a) under the ``cache-loss`` fault
   profile: epoch 1 degraded (``cache_lost``), the curve bit-equal,
   ``trace_count`` at most 2. Launch counts are set to 0 before each
   run and read after it. Prints per run and epoch the training ms a
   step, wall, ``stage_s``, ``exposed_stage_s``, the boundary copy,
   miss lanes and wire rows (and their tier split), each run's launches
   and peak memory.
9. The paper-metrics campaign (``repro_torch.eval``) and the chaos
   sweep (``repro_torch.fault.chaos``) on the card. (a) The paper's
   GraphSAGE at full width as a campaign built here from the port's
   ``grid``: host-sim and device cells of ``rapidgnn`` and ``dgl-metis``
   (``reddit_sim``, batch 1000, 4 greedy workers, n_hot 4096, 3 epochs,
   hidden 256, fan-outs (25, 10)), and the device pair again on ``2x2``:
   6 cells, run one at a time with the launch counts set to 0 before
   each. Gates: ``validate_report`` finds nothing, every differential
   check passes with every layer present (host vs device miss parity
   and bytes, rapid vs baseline, flat vs ``2x2``, ``one_compilation``
   with ``trace_count`` 1), each cell launched its kernels (device
   cells ``search``, ``assemble``, ``gather_agg`` and its backward; host
   cells the last two), and the device rapid cell's curve is phase 8's
   (a) bit for bit, its first 3 losses within ``rtol=1e-4, atol=1e-5`` of
   phase 8's CPU steps. (b) The same grid with every schedule compiled
   on the card (``seg_sort`` in every cell, lazily in the device
   runners' stage thread): every count and curve bit-equal to (a); both
   runs' times printed side by side. (c) The fault campaign
   (``fault_grid``, the tiny graph): every check passes, the report
   validates, at least one degraded cell. (d) ``run_chaos(seed=0,
   fast=True)`` on the card: ``ok``, the serve sweep's ``trace_count``
   1, each train plan's fires and outcome equal to the same sweep on the
   CPU. Prints per cell the step time, warm wall, fetch counters, wire
   rows and their tiers, hit rate, trace count, staging, launches and
   peak memory; per pair the throughput speedup, the fetch and byte
   reductions and the modelled energy ratios; the check counts, the
   fault rows, the chaos table and each sub-phase's wall. The reports
   go to ``artifacts/BENCH_torch_paper.json``,
   ``BENCH_torch_paper_device.json``, ``BENCH_torch_fault.json`` and
   ``chaos_torch.json``.

Output: one ``kernel {...}`` line per kernel, the card's name and power
limit, one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the full record of a run is written (listed in .gitignore)
OUT_DIR = os.path.join(HERE, "artifacts")

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the non-tensor
#: fp32 / int32 operation rate and the dense bf16 tensor-core rate
MEM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

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
LM_ARCH = "gemma2-2b"
LM_FULL = True              # full width and depth (get_arch)
LM_SEED = 0
PREFILL_S = 8192
DECODE_B, DECODE_PROMPT, DECODE_GEN = 8, 16, 32
CHECK_B, CHECK_S, CHECK_ATOL = 2, 64, 1e-3
LONG_B, LONG_S = 16, 32768
DIST_EPOCHS = 1
EMB_WORKERS, EMB_BATCH, EMB_SEQ = 8, 16, 256
EMB_N_HOT, EMB_STEPS, EMB_S0 = 32768, 100, 7


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


def device_ms_per_call(torch, fn, calls: int = 20, iters: int = 10) -> float:
    """Device time of one ``fn()`` call among ``calls`` captured back to
    back in one CUDA graph: a graph of one short call is replayed no
    faster than the host can launch graphs, which ``launch_floor_ms``
    shows, so a call of a few microseconds is timed this way too."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
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
    return start.elapsed_time(end) / iters / calls


def launch_floor_ms(torch, device) -> dict:
    """``device_ms`` and ``device_ms_per_call`` of one tiny elementwise
    kernel: the first is the host's rate of graph replays, the second the
    card's cost of one more kernel in a graph."""
    x = torch.zeros(16, device=device)
    return {"one_call_a_replay_ms": device_ms(torch, lambda: x.add_(1)),
            "in_a_graph_ms": device_ms_per_call(torch, lambda: x.add_(1))}


#: CUgraphNodeType values the card runs (cuda.h)
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


def device_ops(torch, fn) -> list:
    """The card operations (kernels, copies, memsets) one ``fn()`` call
    runs: one call captured in a CUDA graph, its nodes counted with
    libcuda's ``cuGraphGetNodes``. A profiler trace loses events of short
    kernels late in a long run; a graph holds exactly what was launched."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value in _NODE_TYPES:
            kinds.append(_NODE_TYPES[kind.value])
    del graph
    return kinds


def bound_ms(nbytes: float, ops: float, ops_per_s: float = OPS_PER_S):
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / ops_per_s
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


def gather_agg_row(torch, h, src, msk, nd: int, fo: int, what: str):
    """The ``gather_agg`` forward at one shape: bit-equal to its plain
    version on the card (both sum each row's unmasked rows in edge order
    from +0 and divide by IEEE division) and to a second run, one card
    operation a call, timed one call a replay and 20 calls to a graph,
    beside the plain version, ``F.embedding_bag`` and the byte bound (the
    distinct source rows the unmasked edges read, the output, the edge
    lists). -> {"out": the result, "row": the measurements}."""
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_ref

    def call():
        return gather_ops.gather_agg(h, src, msk, nd=nd, fanout=fo)
    got = call()
    _equal(torch, got, gather_agg_ref(h, src, msk, nd, fo))
    _equal(torch, call(), got)
    ops = device_ops(torch, call)
    if len(ops) != 1:
        raise RuntimeError(f"gather_agg {what}: {len(ops)} card operations "
                           f"a call ({ops}), one kernel expected")
    d = h.shape[1]
    unmasked = int(msk.sum().item())
    nbytes = (torch.unique(src.long()[msk]).shape[0] * d * 4 + nd * d * 4
              + src.shape[0] * (4 + 1))
    lib = embedding_bag_mean(torch, h, src, msk, nd, fo)
    if lib is not None and not torch.allclose(lib(), got, rtol=1e-5,
                                              atol=1e-6):
        raise RuntimeError(f"embedding_bag yardstick of {what} computes "
                           f"another function")
    r = {"what": what, "err": 0.0,
         "bound": bound_ms(nbytes, unmasked * d + nd * d),
         "ms": device_ms(torch, call),
         "ms_in_a_graph": device_ms_per_call(torch, call),
         "plain_ms": device_ms(torch, lambda: gather_agg_ref(
             h, src, msk, nd, fo)),
         "library_ms": None if lib is None else device_ms(torch, lib),
         "library_ms_in_a_graph": (None if lib is None
                                   else device_ms_per_call(torch, lib)),
         "device_ops": len(ops),
         "shape": f"h=({h.shape[0]},{d}) nd={nd} fanout={fo} "
                  f"unmasked={unmasked}"}
    lib_s = "none" if lib is None else (
        f"{r['library_ms']:.4f} ({r['library_ms_in_a_graph']:.4f} in a "
        f"graph; F.embedding_bag)")
    log(f"gather_agg {what}: {r['shape']} ms={r['ms']:.4f} "
        f"({r['ms_in_a_graph']:.4f} a call in a graph of 20) plain_ms="
        f"{r['plain_ms']:.4f} library_ms={lib_s} bound_ms="
        f"{r['bound'][0]:.4f} ({nbytes / 1e6:.1f} MB); 1 card op a call; "
        f"bit-equal to the plain version and to a second run")
    return {"out": got, "row": r}


def gather_awkward(torch, device):
    """The ``gather_agg`` forward at the edges of its plan, bit-equal to
    its plain version: d 1 / 3 / 130 / 256 / 602, rows starting 16-, 8- and
    4-byte aligned (each vector width), fan-outs 1 / 10 / 25 / 33 / 50 (a
    fan-out above 32 is loaded in rounds of 32), nd 1, few rows (columns
    split over warps) and many, fully masked rows."""
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.gather_agg.ref import gather_agg_ref

    gen = torch.Generator(device="cpu").manual_seed(17)
    for nd, fo, m, d, off in ((1, 1, 5, 1, 0), (7, 50, 40, 3, 0),
                              (2, 33, 10, 130, 0), (300, 25, 500, 602, 0),
                              (300, 25, 500, 602, 1), (1000, 10, 3000, 256, 0),
                              (1000, 10, 3000, 256, 2),
                              (1000, 10, 3000, 256, 1),
                              (6000, 10, 3000, 256, 0), (1, 25, 30, 602, 0)):
        # h starts `off` floats into its storage: 16-, 8- or 4-byte aligned
        flat = torch.empty(m * d + off, device=device)
        flat[off:] = torch.randn(m * d, generator=gen).to(device)
        h = flat[off:].view(m, d)
        src = torch.randint(0, m, (nd * fo,), generator=gen,
                            dtype=torch.int32).to(device)
        msk = (torch.rand(nd * fo, generator=gen) < 0.7).to(device)
        msk[:fo] = False                      # a fully masked row
        _equal(torch, gather_ops.gather_agg(h, src, msk, nd=nd, fanout=fo),
               gather_agg_ref(h, src, msk, nd, fo))
    log("awkward shapes: gather_agg (d 1/3/130/256/602, rows 16-, 8- and "
        "4-byte aligned, fan-out 1/10/25/33/50, nd 1 to 6000, fully masked "
        "rows) bit-equal to its plain version")


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

    def lib_search():
        return torch.searchsorted(ids, q, out_int32=True)
    results.append({
        "name": "search", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_lookup/csrc/search.cu",
        "replaces": "src/repro/kernels/cache_lookup/cache_lookup.py:49",
        "launches": launches["search"], "max_abs_err": err,
        "ms": device_ms(torch, lambda: search_ops.search(ids, q)),
        "plain_ms": device_ms(torch, lambda: search_ref(ids, q)),
        "bound_ms": b, "bound_by": by,
        "library_ms": device_ms(torch, lib_search),
        # one call a replay is paced by the host's graph launches: the
        # same calls 20 to a graph give the card's own time a call
        "ms_in_a_graph": device_ms_per_call(
            torch, lambda: search_ops.search(ids, q)),
        "library_ms_in_a_graph": device_ms_per_call(torch, lib_search),
        "shape": f"queries={M} n_hot={n_hot}",
        "hit_rate": float(hit.float().mean().item())})
    r = results[-1]
    log(f"search: {r['shape']} ms={r['ms']:.4f} "
        f"({r['ms_in_a_graph']:.4f} a call in a graph of 20) library_ms="
        f"{r['library_ms']:.4f} ({r['library_ms_in_a_graph']:.4f} in a "
        f"graph; torch.searchsorted) bound_ms={r['bound_ms']:.6f}")

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
        res = gather_agg_row(torch, h, src, msk, R * nd, fo,
                             f"serving layer {l}")
        layers.append(res["row"])
        got = res["out"]
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
        "ms_in_a_graph": sum(L["ms_in_a_graph"] for L in layers),
        "shape": " + ".join(L["shape"] for L in layers),
        "layers": layers})

    # -- awkward shapes ------------------------------------------------------
    gather_awkward(torch, device)
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
    schedule_sorts = next(c.value for c in counters if c.name == "seg_sort")
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
    # the schedule compiler sorts; the backward orders its edges inside
    # its own kernel and launches no seg_sort
    if launches["seg_sort"] != schedule_sorts:
        raise RuntimeError(f"seg_sort launched {launches['seg_sort']} times, "
                           f"{schedule_sorts} of them for the schedule: the "
                           f"backward sorted")
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
        passes = -(-min(num_bits + 1, 32) // 8)    # 8-bit digits
        width = 4 if payload is None else 8        # bytes a key carries

        def call():
            return sort_ops.seg_sort(keys, payload, num_bits=num_bits)
        _equal(torch, call()[0], got[0])
        ops = device_ops(torch, call)
        r = {"what": what, "n": n, "num_bits": num_bits,
             # each key read once and written once (the row's bound) ...
             "bound": bound_ms(n * 2 * width, n * passes),
             # ... and this design's own floor: read by the histogram and
             # by every pass, written by every pass
             "design_floor_ms": bound_ms(n * width * (1 + 2 * passes),
                                         0)[0],
             "ms": device_ms(torch, call),
             "ms_in_a_graph": device_ms_per_call(torch, call, calls=10),
             "plain_ms": device_ms(torch, lambda: seg_sort_ref(
                 keys, payload)),
             "library_ms": device_ms(torch, lambda: torch.sort(
                 keys, stable=True)),
             "passes": passes, "device_ops": len(ops), "ops": ops}
        log(f"seg_sort {what}: n={n} num_bits={num_bits} "
            f"ms={r['ms']:.4f} ({r['ms_in_a_graph']:.4f} a call in a graph "
            f"of 10) plain_ms={r['plain_ms']:.4f} library_ms="
            f"{r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} (read and "
            f"write once; the design's floor {r['design_floor_ms']:.4f}); "
            f"{len(ops)} card ops a call ({', '.join(ops)}) for {passes} "
            f"passes; bit-equal to its plain version")
        if len(ops) > 1 + passes:
            raise RuntimeError(f"seg_sort {what}: {len(ops)} card operations "
                               f"a call, at most 1 + {passes} expected")
        return r

    # the forward at training's two layer shapes, from the captured batch:
    # layer 0 over the step's input features, layer 1 over hidden rows
    feats = t(captured[0][0])
    gen = torch.Generator(device="cpu").manual_seed(11)
    hidden = torch.randn((feats.shape[0], cfg.hidden_dim),
                         generator=gen).to(device)
    forward = [gather_agg_row(
        torch, h, t(cb.edge_src[l]), t(cb.edge_mask[l]),
        cb.edge_src[l].shape[0] // fanouts[l], fanouts[l],
        f"training layer {l}")["row"]
        for l, h in enumerate((feats, hidden))]
    del feats, hidden

    # the compiler's largest stream (layer 0 of an epoch), keys only; the
    # backward no longer sorts (its order is built inside its own kernel,
    # timed in its row)
    sorts = [sort_row(sort_input["keys"], None, sort_input["num_bits"],
                      "layer-0 stream")]

    def bwd_row(layer, d, what, tol):
        """The kernel must equal the plain version on the CPU bit for bit
        (both add each row's quotients in edge order from +0) and give
        the same bits twice; ``tol`` (rtol = atol) bounds its distance
        from the plain version on the card, whose ``index_add_`` sums
        with atomics in no fixed order."""
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
        if not torch.equal(got.cpu(), cpu):
            raise RuntimeError(
                f"gather_agg_bwd {what} is not the CPU plain version bit for "
                f"bit: max abs diff {(got.cpu() - cpu).abs().max().item()}")
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise RuntimeError(f"gather_agg_bwd {what} differs from its "
                               f"plain version on the card")
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

        def call():
            return gather_ops.gather_agg_bwd(g, src, msk, m=m_max, nd=nd,
                                             fanout=fo)
        ops = device_ops(torch, call)
        r = {"what": what, "err": (got - want).abs().max().item(),
             "bound": bound_ms(nbytes, 2 * unmasked * d),
             "ms": device_ms(torch, call),
             "ms_in_a_graph": device_ms_per_call(torch, call, calls=10),
             "plain_ms": device_ms(torch, lambda: gather_agg_bwd_ref(
                 g, src, msk, m_max, nd, fo)),
             "library_ms": device_ms(torch, library),
             "cpu_err": 0.0, "device_ops": len(ops), "ops": ops,
             "shape": f"g=({nd},{d}) m={m_max} fanout={fo} "
                      f"unmasked={unmasked}"}
        log(f"gather_agg_bwd {what}: {r['shape']} ms={r['ms']:.4f} "
            f"({r['ms_in_a_graph']:.4f} a call in a graph of 10) plain_ms="
            f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
            f"(index_add_) bound_ms={r['bound'][0]:.4f}; {len(ops)} card "
            f"ops a call ({', '.join(ops)}); "
            f"max_abs_err={r['err']:.3e} against the card plain version, "
            f"bit-equal to the CPU plain version and to a second run")
        return r
    bwd1 = bwd_row(1, cfg.hidden_dim, "layer 1 (the path)", 1e-5)
    if bwd1["device_ops"] > 3:
        raise RuntimeError(f"gather_agg_bwd ran {bwd1['device_ops']} card "
                           f"operations a call at layer 1: {bwd1['ops']}")
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
    if not torch.equal(got.cpu(), gather_agg_bwd_ref(
            hub_g.cpu(), hub_src.cpu(), hub_msk.cpu(), 9, 40, 10)):
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
    for r in rows[0]["parts"] + [rows[1]["layer0_reference"]] + forward:
        r["bound_ms"], r["bound_by"] = r.pop("bound")
    return rows, forward


# ---------------------------------------------------------------------------
# phase 6: transformer decode serving (gemma2-2b)
# ---------------------------------------------------------------------------

def lm_config(dtype: str = "bfloat16"):
    import dataclasses
    from repro_torch.configs import get_arch, get_reduced
    cfg = get_arch(LM_ARCH) if LM_FULL else get_reduced(LM_ARCH)
    return dataclasses.replace(cfg, dtype=dtype)


def lm_tokens(cfg, shape, field: int):
    from repro_torch.data.pipeline import zipf_tokens
    from repro_torch.graph.sampler import rng_from
    return zipf_tokens(rng_from(LM_SEED, field), cfg.vocab_size, shape)


def card_time_by_op(torch, fn, top: int = 8):
    """Run ``fn`` once under ``torch.profiler``: (wall s, card busy ms,
    the ``top`` card ops by self time in ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    ops = {e.key: e.self_device_time_total / 1e3 for e in sorted(
        events, key=lambda e: -e.self_device_time_total)[:top]}
    return wall, busy_us / 1e3, ops


def prefill_phase(torch, device, cfg, params, counters):
    """(a) ``forward`` at B=1, S=PREFILL_S: launches (counts set to 0
    just before, read just after), time, peak memory, card time by op."""
    from repro_torch.models.transformer import forward

    toks = torch.from_numpy(lm_tokens(cfg, (1, PREFILL_S), 0x5046)).to(
        device)

    def run():
        with torch.inference_mode():
            return forward(cfg, params, toks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t0 = time.perf_counter()
    logits = run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()
    if tuple(logits.shape) != (1, PREFILL_S, cfg.vocab_size) or \
            logits.dtype != torch.float32 or \
            not bool(torch.isfinite(logits).all()):
        raise RuntimeError(f"prefill logits {tuple(logits.shape)} "
                           f"{logits.dtype} not finite of the right shape")
    if cfg.final_softcap and float(logits.abs().max()) > cfg.final_softcap:
        raise RuntimeError("prefill logits exceed the final softcap")
    last = logits[0, -1].clone()
    del logits
    if launches["flash_attention"] != cfg.num_layers or \
            launches["flash_decode"] != 0:
        raise RuntimeError(f"prefill launched {launches}, expected "
                           f"{cfg.num_layers} flash_attention")
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        again = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        same = torch.equal(again[0, -1], last)
        del again
        if not same:
            raise RuntimeError("a second prefill gave other logits")
    traced_s, busy_ms, ops = card_time_by_op(torch, run)
    out = {"tokens": PREFILL_S, "first_ms": 1e3 * first_s,
           "ms": 1e3 * min(times), "tokens_per_s": PREFILL_S / min(times),
           "peak_bytes": peak, "launches": launches,
           "traced_ms": 1e3 * traced_s, "card_busy_ms": busy_ms,
           "card_ms_by_op": ops}
    log(f"prefill {cfg.name}: B=1 S={PREFILL_S} in {out['ms']:.2f} ms "
        f"({out['tokens_per_s']:.0f} tok/s; first call {out['first_ms']:.2f}"
        f" ms), peak device memory {peak / 2**30:.2f} GiB, launches "
        f"{json.dumps(launches)}; logits finite, second run bit-identical")
    log(f"prefill traced: {out['traced_ms']:.2f} ms, card busy "
        f"{busy_ms:.2f} ms; card ms by op {json.dumps(ops)}")
    return out


def decode_phase(torch, device, cfg, params, counters):
    """(b) the ``serve_decode`` launcher's greedy loop: launches (counts
    set to 0 just before, read just after), ms/step, tokens/s, a second
    run bit-identical, card time by op."""
    import numpy as np
    from repro_torch.launch.serve_decode import greedy_decode

    prompts = lm_tokens(cfg, (DECODE_B, DECODE_PROMPT), 0x4443)
    steps = DECODE_PROMPT + DECODE_GEN - 1
    torch.cuda.synchronize()
    for c in counters:
        c.reset()
    toks, first_s, logits = greedy_decode(cfg, params, prompts, DECODE_GEN,
                                          device)
    launches = {c.name: c.value for c in counters}
    if launches["flash_decode"] != steps * cfg.num_layers or \
            launches["flash_attention"] != 0:
        raise RuntimeError(f"decode launched {launches}, expected "
                           f"{cfg.num_layers} flash_decode a step")
    if toks.shape != (DECODE_B, DECODE_PROMPT + DECODE_GEN) or \
            not np.array_equal(toks[:, :DECODE_PROMPT], prompts) or \
            toks.min() < 0 or toks.max() >= cfg.vocab_size or \
            not all(bool(torch.isfinite(x).all()) for x in logits):
        raise RuntimeError("decode gave bad tokens or logits")
    again, second_s, _ = greedy_decode(cfg, params, prompts, DECODE_GEN,
                                       device)
    if not np.array_equal(again, toks):
        raise RuntimeError("a second decode run gave other tokens")
    traced_s, busy_ms, ops = card_time_by_op(
        torch, lambda: greedy_decode(cfg, params, prompts, DECODE_GEN,
                                     device))
    out = {"batch": DECODE_B, "prompt": DECODE_PROMPT, "gen": DECODE_GEN,
           "steps": steps, "first_ms_per_step": 1e3 * first_s / steps,
           "ms_per_step": 1e3 * second_s / steps,
           "tokens_per_s": DECODE_B * steps / second_s,
           "launches": launches, "traced_ms_per_step": 1e3 * traced_s / steps,
           "card_busy_ms_per_step": busy_ms / steps,
           "card_busy_share": busy_ms / 1e3 / traced_s,
           "card_ms_by_op_per_step": {k: v / steps for k, v in ops.items()},
           "sample": toks[0, DECODE_PROMPT:DECODE_PROMPT + 10].tolist()}
    log(f"decode {cfg.name}: B={DECODE_B} prompt {DECODE_PROMPT} gen "
        f"{DECODE_GEN}: {steps} steps, {out['ms_per_step']:.2f} ms/step, "
        f"{out['tokens_per_s']:.1f} tok/s (first run "
        f"{out['first_ms_per_step']:.2f} ms/step); launches "
        f"{json.dumps(launches)}; second run bit-identical; sample "
        f"{out['sample']}")
    log(f"decode traced: {out['traced_ms_per_step']:.2f} ms/step, card busy "
        f"{out['card_busy_ms_per_step']:.3f} ms/step "
        f"({100 * out['card_busy_share']:.2f} %); card ms a step by op "
        f"{json.dumps(out['card_ms_by_op_per_step'])}")
    return out


def decode_vs_prefill(torch, device):
    """(c) float32 at full width, S=CHECK_S: each decode step's logits
    against ``forward``'s at the same position."""
    from repro_torch.models.transformer import (forward, init_decode_state,
                                                init_params, serve_step)
    cfg = lm_config("float32")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED + 1), device)
    toks = torch.from_numpy(lm_tokens(cfg, (CHECK_B, CHECK_S), 0x4356)).to(
        device)
    worst = 0.0
    with torch.inference_mode():
        full = forward(cfg, params, toks)
        states = init_decode_state(cfg, CHECK_B, max_len=CHECK_S,
                                   device=device)
        for t in range(CHECK_S):
            lg, states = serve_step(
                cfg, params, states, toks[:, t:t + 1],
                torch.full((CHECK_B,), t, dtype=torch.int32, device=device))
            worst = max(worst, float((lg[:, 0] - full[:, t]).abs().max()))
    scale = float(full.abs().max())
    del params, states, full
    if not worst <= CHECK_ATOL:
        raise RuntimeError(f"decode logits differ from the prefill's by "
                           f"{worst} > {CHECK_ATOL}")
    log(f"decode vs prefill, float32, {cfg.name} "
        f"{'full width and depth' if LM_FULL else 'reduced'}, "
        f"B={CHECK_B} S={CHECK_S}: max abs diff {worst:.3e} (tolerance "
        f"atol={CHECK_ATOL}; logits up to {scale:.2f})")
    return {"max_abs_diff": worst, "atol": CHECK_ATOL, "max_logit": scale}


def layer_qkv(torch, cfg, params, toks):
    """q/k/v of layer 0 (local) and layer 1 (global) of the prefill, each
    from its own input: the embeddings, then layer 0's output."""
    from repro_torch.models.transformer.blocks import (_project_qkv,
                                                       block_apply)
    from repro_torch.models.transformer.common import rms_norm
    from repro_torch.models.transformer.model import _embed, block_params

    pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
    out = []
    with torch.inference_mode():
        x = _embed(cfg, params, toks)
        for i, kind in enumerate(cfg.pattern[:2]):
            p = block_params(params, i, 0)
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = _project_qkv(cfg, p["attn"], h, pos)
            out.append((kind, cfg.window if kind == "local" else 0,
                        q.contiguous(), k.contiguous(), v.contiguous()))
            x = block_apply(cfg, kind, p, x, positions=pos)
    return out


def causal_pairs(S: int, window: int) -> int:
    """Valid (query, key) pairs of one head: the triangle, or the band."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def attn_kernel_rows(torch, device, cfg, params, launches):
    """(d) ``flash_attention`` on the layers' own q/k/v at the prefill
    shape, in bfloat16 and in float32, against its plain version, with
    its time beside the plain version's and SDPA's (no softcap)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    toks = torch.from_numpy(lm_tokens(cfg, (1, PREFILL_S), 0x5046)).to(
        device)
    cap = cfg.attn_softcap
    rows = []
    for kind, window, q, k, v in layer_qkv(torch, cfg, params, toks):
        B, S, H, dh = q.shape
        kw = dict(causal=True, window=window, softcap=cap)
        got = fa_ops.flash_attention(q, k, v, **kw)
        want = flash_attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), rtol=2 ** -7,
                              atol=1e-5):
            raise RuntimeError(f"flash_attention {kind} (bf16) differs from "
                               f"its plain version: {err}")
        q32, k32, v32 = q.float(), k.float(), v.float()
        got32 = fa_ops.flash_attention(q32, k32, v32, **kw)
        want32 = flash_attention_ref(q32, k32, v32, **kw)
        err32 = float((got32 - want32).abs().max())
        if not torch.allclose(got32, want32, rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"flash_attention {kind} (fp32) differs from "
                               f"its plain version: {err32}")
        del got32, want32
        if window:
            ip = torch.arange(S, device=device)
            band = (ip[None, :] <= ip[:, None]) & \
                (ip[None, :] > ip[:, None] - window)

        def sdpa_of(q_, k_, v_):
            qt, kt, vt = (t.transpose(1, 2) for t in (q_, k_, v_))
            if window:
                return lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, enable_gqa=True)
            return lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        # the float32 kernel (CUDA cores) on the same q/k/v, beside SDPA in
        # float32 and the bound at the float32 CUDA-core rate
        fp32_ms = device_ms(torch, lambda: fa_ops.flash_attention(
            q32, k32, v32, **kw), iters=3)
        sdpa_fp32_ms = device_ms(torch, sdpa_of(q32, k32, v32), iters=3)
        del q32, k32, v32
        sdpa = sdpa_of(q, k, v)
        lib_err = float((sdpa().transpose(1, 2).float() - flash_attention_ref(
            q, k, v, causal=True, window=window).float()).abs().max())
        if lib_err > 0.05:
            raise RuntimeError(f"SDPA yardstick ({kind}) computes another "
                               f"function: {lib_err}")
        pairs = causal_pairs(S, window)
        nbytes = B * S * (2 * H + 2 * k.shape[2]) * dh * q.element_size()
        r = {"kind": kind, "window": window, "err": err, "err_fp32": err32,
             "bound": bound_ms(nbytes, 4 * dh * H * B * pairs,
                               BF16_FLOPS_PER_S),
             "flop": 4 * dh * H * B * pairs,
             "ms": device_ms(torch, lambda: fa_ops.flash_attention(
                 q, k, v, **kw), iters=5),
             "plain_ms": device_ms(torch, lambda: flash_attention_ref(
                 q, k, v, **kw), iters=3),
             "library_ms": device_ms(torch, sdpa, iters=5),
             "library_err_no_softcap": lib_err, "fp32_ms": fp32_ms,
             "fp32_bound": bound_ms(2 * nbytes, 4 * dh * H * B * pairs),
             "sdpa_fp32_ms": sdpa_fp32_ms,
             "shape": f"{kind} q=({B},{S},{H},{dh}) kvH={k.shape[2]} "
                      f"window={window} softcap={cap} bf16"}
        # FLOP of the bound (4 dh a valid pair) over the kernel's time
        r["tflops"] = r["flop"] / r["ms"] / 1e9
        log(f"flash_attention {r['shape']}: ms={r['ms']:.3f} (bf16, tensor "
            f"cores) fp32_ms={fp32_ms:.3f} (float32 q/k/v, CUDA cores) "
            f"plain_ms={r['plain_ms']:.3f} library_ms={r['library_ms']:.3f} "
            f"(SDPA, no softcap) bound_ms={r['bound'][0]:.4f} "
            f"({r['tflops']:.1f} TFLOP/s, "
            f"{100 * r['tflops'] * 1e12 / BF16_FLOPS_PER_S:.1f} % of the "
            f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s bound); max_abs_err "
            f"{err:.3e} (bf16, rtol=2^-7 atol=1e-5), {err32:.3e} (fp32, "
            f"rtol=1e-4 atol=1e-5)")
        log(f"flash_attention {kind} float32: fp32_ms={fp32_ms:.3f} "
            f"SDPA float32 {sdpa_fp32_ms:.3f} ms; bound at the float32 "
            f"CUDA-core rate {r['fp32_bound'][0]:.4f} ms "
            f"({r['fp32_bound'][1]}, {OPS_PER_S / 1e12:.0f} TFLOP/s)")
        rows.append(r)
        del got, want
    # awkward shapes: odd S, G = 1-8, dh = 48-256, fp32, non-causal window
    gen = torch.Generator(device="cpu").manual_seed(13)
    for B, S, H, kvH, dh, causal, window, softcap, dt in (
            (2, 77, 6, 2, 64, True, 0, 0.0, torch.float32),
            (1, 301, 3, 1, 128, True, 50, 30.0, torch.bfloat16),
            (1, 129, 8, 8, 256, False, 20, 50.0, torch.float32),
            (3, 5, 4, 2, 64, True, 3, 0.0, torch.bfloat16),
            (1, 1000, 8, 4, 256, True, 300, 50.0, torch.bfloat16),
            (2, 63, 16, 2, 48, False, 0, 0.0, torch.bfloat16)):
        qq = torch.randn((B, S, H, dh), generator=gen).to(device, dt)
        kk = torch.randn((B, S, kvH, dh), generator=gen).to(device, dt)
        vv = torch.randn((B, S, kvH, dh), generator=gen).to(device, dt)
        kw = dict(causal=causal, window=window, softcap=softcap)
        got = fa_ops.flash_attention(qq, kk, vv, **kw).float()
        want = flash_attention_ref(qq, kk, vv, **kw).float()
        tol = dict(rtol=1e-4, atol=1e-5) if dt == torch.float32 else \
            dict(rtol=2 ** -7, atol=1e-5)
        if not torch.allclose(got, want, **tol):
            raise RuntimeError(f"flash_attention differs at S={S} G="
                               f"{H // kvH} dh={dh}")
    log("awkward shapes: flash_attention (S 5/63/77/129/301/1000, G 1-8, "
        "dh 48-256, non-causal window) equal to its plain version")
    torch.cuda.synchronize()
    return {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_mma.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:30",
        "launches": launches["flash_attention"],
        "max_abs_err": max(r["err"] for r in rows),
        "ms": sum(r["ms"] for r in rows),
        "plain_ms": sum(r["plain_ms"] for r in rows),
        "bound_ms": sum(r["bound"][0] for r in rows),
        "bound_by": rows[0]["bound"][1],
        "library_ms": sum(r["library_ms"] for r in rows),
        "fp32_ms": sum(r["fp32_ms"] for r in rows),
        "fp32_bound_ms": sum(r["fp32_bound"][0] for r in rows),
        "sdpa_fp32_ms": sum(r["sdpa_fp32_ms"] for r in rows),
        "shape": " + ".join(r["shape"] for r in rows), "layers": rows}


def long_cache(torch, device, cfg):
    """B=LONG_B, S=LONG_S bfloat16 K/V with the model's heads, lengths and
    starts covering 0, 1, S, a window start, start == length."""
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 2)
    B, S, H, kvH, dh = LONG_B, LONG_S, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    q = torch.randn((B, H, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, kvH, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    v = torch.randn((B, S, kvH, dh), generator=gen, device=device,
                    dtype=torch.bfloat16)
    lens = [S, S, 1, 0, S // 2, S - 1, 4097, 3, S, 1000, S, 2, 20000, S,
            12345, S][:B]
    starts = [0, S - 4096, 0, 0, S // 2 - 4096, 1, 1, 3, S // 3, 999, 0, 0,
              0, S - 1, 0, 5][:B]
    length = torch.tensor(lens, dtype=torch.int32, device=device)
    start = torch.tensor(starts, dtype=torch.int32, device=device)
    return q, k, v, length, start


def decode_kernel_row(torch, device, cfg, params, launches):
    """(d) ``flash_decode`` against its plain version over the long cache
    and the decode loop's own cache shape, with its time beside the plain
    version's and SDPA's (no softcap)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.flash_decode.ref import (flash_decode_batched_ref,
                                                      finalize)

    cap = cfg.attn_softcap
    q, k, v, length, start = long_cache(torch, device, cfg)
    B, S, kvH, dh = k.shape
    H = q.shape[1]
    got = fd_ops.flash_decode_batched(q, k, v, length, start, softcap=cap)
    acc, m, l = flash_decode_batched_ref(q, k, v, length, start,
                                         softcap=cap)
    want = finalize(acc, l)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise RuntimeError(f"flash_decode (long cache) differs from its plain "
                           f"version: {err}")
    parts = fd_ops.flash_decode(q[2], k[2], v[2], length[2], start[2],
                                softcap=cap)
    for g_, w_ in zip(parts, (acc[2], m[2], l[2])):
        if not torch.allclose(g_, w_, rtol=1e-4, atol=1e-5):
            raise RuntimeError("flash_decode partials differ")
    empty = got[(length <= start)]
    if empty.numel() and not bool((empty == 0).all()):
        raise RuntimeError("flash_decode: an empty range did not give 0")
    # the decode loop's shape: the caches the serving loop fills
    from repro_torch.models.transformer import init_decode_state
    small = init_decode_state(cfg, DECODE_B, DECODE_PROMPT + DECODE_GEN,
                              device=device)
    gen = torch.Generator(device=device).manual_seed(LM_SEED + 3)
    for st in small["scan"]:
        kc = torch.randn(st["k"][0].shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
        vc = torch.randn(st["v"][0].shape, generator=gen, device=device,
                         dtype=torch.bfloat16)
        qc = torch.randn((DECODE_B, H, dh), generator=gen, device=device,
                         dtype=torch.bfloat16)
        ln = torch.arange(DECODE_B, dtype=torch.int32, device=device) * 7 % \
            (kc.shape[1] + 1)
        st0 = torch.zeros_like(ln)
        g2 = fd_ops.flash_decode_batched(qc, kc, vc, ln, st0, softcap=cap)
        a2, _, l2 = flash_decode_batched_ref(qc, kc, vc, ln, st0,
                                             softcap=cap)
        if not torch.allclose(g2, finalize(a2, l2), rtol=1e-4, atol=1e-5):
            raise RuntimeError(f"flash_decode differs at the decode shape "
                               f"S={kc.shape[1]}")
        small_shape = tuple(kc.shape)

    valid = (length.clamp(max=S) - start.clamp(min=0)).clamp(min=0)
    n_valid = int(valid.sum())
    nbytes = n_valid * kvH * dh * 2 * k.element_size() + \
        q.numel() * q.element_size() + B * H * dh * 4
    pos = torch.arange(S, device=device)
    mask = ((pos[None, :] < length[:, None]) &
            (pos[None, :] >= start[:, None]))[:, None, None, :]
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=True)
    full_rows = valid > 0
    lib = sdpa()[:, :, 0].float()
    lib_want = finalize(*flash_decode_batched_ref(q, k, v, length, start)[::2])
    lib_err = float((lib - lib_want)[full_rows].abs().max())
    if lib_err > 0.05:
        raise RuntimeError(f"SDPA yardstick (decode) computes another "
                           f"function: {lib_err}")
    r = {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
         "replaces": "src/repro/kernels/flash_decode/flash_decode.py:29",
         "launches": launches["flash_decode"], "max_abs_err": err,
         "ms": device_ms(torch, lambda: fd_ops.flash_decode_batched(
             q, k, v, length, start, softcap=cap)),
         "plain_ms": device_ms(torch, lambda: flash_decode_batched_ref(
             q, k, v, length, start, softcap=cap), iters=5),
         "library_ms": device_ms(torch, sdpa, iters=5),
         "library_err_no_softcap": lib_err,
         "shape": f"q=({B},{H},{dh}) cache=({B},{S},{kvH},{dh}) bf16, "
                  f"{n_valid} valid positions, softcap {cap}"}
    r["bound_ms"], r["bound_by"] = bound_ms(nbytes, 4 * dh * H * n_valid,
                                            BF16_FLOPS_PER_S)
    r["gb_per_s"] = nbytes / r["ms"] / 1e6
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    r["device_ops"] = len(device_ops(torch, lambda: fd_ops.flash_decode_batched(
        q, k, v, length, start, softcap=cap)))
    # the decode loop's shape: its caches filled (the time of the loop's
    # last steps), the same mask yardstick for SDPA
    qs = torch.randn((DECODE_B, H, dh), generator=gen, device=device,
                     dtype=torch.bfloat16)
    ln = torch.full((DECODE_B,), small_shape[1], dtype=torch.int32,
                    device=device)
    kc = torch.randn(small_shape, generator=gen, device=device,
                     dtype=torch.bfloat16)
    vc = torch.randn(small_shape, generator=gen, device=device,
                     dtype=torch.bfloat16)

    def small():
        return fd_ops.flash_decode_batched(qs, kc, vc, ln, softcap=cap)
    ops = device_ops(torch, small)
    if len(ops) != 1:
        raise RuntimeError(f"flash_decode ran {len(ops)} card operations a "
                           f"call at the decode loop's shape: {ops}")
    ppos = torch.arange(small_shape[1], device=device)
    smask = (ppos[None, :] < ln[:, None])[:, None, None, :]
    sq, sk, sv = qs[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)

    def small_sdpa():
        return F.scaled_dot_product_attention(sq, sk, sv, attn_mask=smask,
                                              enable_gqa=True)
    s_bytes = (kc.numel() + vc.numel()) * kc.element_size() + \
        qs.numel() * qs.element_size() + DECODE_B * H * dh * 4
    s_bound = bound_ms(s_bytes, 4 * dh * H * DECODE_B * small_shape[1],
                       BF16_FLOPS_PER_S)
    r["decode_shape"] = {
        "cache": list(small_shape), "device_ops": len(ops),
        "ms": device_ms(torch, small),
        "ms_in_a_graph": device_ms_per_call(torch, small),
        "bound_ms": s_bound[0], "bound_by": s_bound[1],
        "library_ms": device_ms(torch, small_sdpa),
        "library_ms_in_a_graph": device_ms_per_call(torch, small_sdpa),
        "launch_floor": launch_floor_ms(torch, device)}
    ds = r["decode_shape"]
    log(f"flash_decode {r['shape']}: ms={r['ms']:.4f} plain_ms="
        f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} (SDPA, no "
        f"softcap) bound_ms={r['bound_ms']:.4f} ({r['gb_per_s']:.0f} GB/s, "
        f"{100 * r['share_of_bound']:.1f} % of the bound); "
        f"{r['device_ops']} card op a call; max_abs_err {err:.3e} "
        f"(rtol=1e-4 atol=1e-5)")
    log(f"flash_decode at the decode loop's cache {tuple(small_shape)} "
        f"bf16: {ds['ms_in_a_graph']:.4f} ms a call in a graph of 20 "
        f"({ds['ms']:.4f} one call a replay; launch floor "
        f"{ds['launch_floor']['one_call_a_replay_ms']:.4f} / "
        f"{ds['launch_floor']['in_a_graph_ms']:.4f}), {len(ops)} card op a "
        f"call, bound_ms={ds['bound_ms']:.5f} ({ds['bound_by']}); SDPA "
        f"(same mask, no softcap) {ds['library_ms_in_a_graph']:.4f} ms in a "
        f"graph ({ds['library_ms']:.4f} one call a replay)")
    torch.cuda.synchronize()
    return r


def lm_phase(torch, device, counters):
    from repro_torch.models.transformer import init_params

    cfg = lm_config()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        LM_SEED), device)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"lm: {cfg.name} {'full' if LM_FULL else 'reduced'} "
        f"{cfg.num_layers} layers d={cfg.d_model} H={cfg.num_heads} "
        f"kvH={cfg.num_kv_heads} dh={cfg.head_dim} window={cfg.window} "
        f"softcap {cfg.attn_softcap}/{cfg.final_softcap} {cfg.dtype}: "
        f"{n / 1e9:.3f} B parameters from seed {LM_SEED} in "
        f"{time.perf_counter() - t0:.2f} s")
    prefill = prefill_phase(torch, device, cfg, params, counters)
    decode = decode_phase(torch, device, cfg, params, counters)
    launches = {"flash_attention": prefill["launches"]["flash_attention"],
                "flash_decode": decode["launches"]["flash_decode"]}
    check = decode_vs_prefill(torch, device)
    rows = [attn_kernel_rows(torch, device, cfg, params, launches),
            decode_kernel_row(torch, device, cfg, params, launches)]
    del params
    return {"prefill": prefill, "decode": decode, "decode_vs_prefill": check,
            "parameters": n}, rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 7: the device-distributed epoch (P workers on one card)
# ---------------------------------------------------------------------------

def first_steps(tree, n: int):
    """The first ``n`` steps of a collated (S, P, ...) epoch dict."""
    if isinstance(tree, dict):
        return {k: first_steps(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [first_steps(v, n) for v in tree]
    return tree[:n]


def dist_world(g, pg):
    """The paper's GraphSAGE on all PARTS workers of ``pg`` for one epoch:
    schedules, device view, both collations (hot caches and empty ones)
    and the stacked caches."""
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.core import build_schedule
    from repro_torch.core.schedule import epoch_edge_maxima
    from repro_torch.dist import (DeviceView, collate_device_epoch,
                                  empty_caches, epoch_k_max, stack_caches)
    from repro_torch.graph import KHopSampler
    from repro_torch.models.gnn import GNNConfig

    exp = sage(DATASET, TRAIN_BATCH, workers=PARTS, epochs=DIST_EPOCHS)
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    t0 = time.perf_counter()
    schedules = [build_schedule(sampler, pg, worker=w, s0=exp.s0,
                                num_epochs=DIST_EPOCHS, n_hot=exp.n_hot)
                 for w in range(PARTS)]
    dv = DeviceView.build(pg)
    es = [ws.epoch(0) for ws in schedules]
    m_max = max(e.m_max for e in es)
    edge_max = [max(x) for x in zip(*(epoch_edge_maxima(e) for e in es))]
    S = max(e.num_batches for e in es)
    caches = [dv.remap_cache(e.cache_ids) for e in es]
    empty = empty_caches(PARTS, g.feat_dim)
    k_max = epoch_k_max(es, caches, dv)
    k_base = epoch_k_max(es, empty, dv)
    rapid = collate_device_epoch(es, caches, dv, g.labels, exp.batch_size,
                                 m_max, edge_max, k_max, S)
    base = collate_device_epoch(es, empty, dv, g.labels, exp.batch_size,
                                m_max, edge_max, k_base, S)
    cids, cfeats = stack_caches(caches, dv, exp.n_hot)
    log(f"dist world: {PARTS} workers x {S} steps, batch {exp.batch_size}, "
        f"m_max={m_max} edge_max={edge_max} k_max rapid {k_max} on-demand "
        f"{k_base}, n_per={dv.n_per}; schedules and collation in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"exp": exp, "cfg": cfg, "schedules": schedules, "dv": dv,
            "m_max": m_max, "S": S, "rapid": rapid, "base": base,
            "cids": cids, "cfeats": cfeats, "k_max": k_max,
            "k_base": k_base}


def dist_run(torch, device, w, x, kind, backend):
    """One epoch of all workers on ``device``: -> (params, losses, accs,
    wall s)."""
    from repro_torch.dist import (make_mesh, make_ondemand_epoch,
                                  make_pipelined_epoch)
    from repro_torch.models.gnn import init_params
    from repro_torch.train import AdamW

    mesh = make_mesh((PARTS,), ("data",), device=device)
    params = init_params(w["cfg"], torch.Generator().manual_seed(
        w["exp"].s0), device)
    opt = AdamW(lr=TRAIN_LR)
    if kind == "rapid":
        fn = make_pipelined_epoch(w["cfg"], opt, mesh, w["m_max"],
                                  assemble_backend=backend)
        args = (x["table"], x["offsets"], x["cids"], x["cfeats"], x["rapid"])
    else:
        fn = make_ondemand_epoch(w["cfg"], opt, mesh, w["m_max"],
                                 assemble_backend=backend)
        args = (x["table"], x["offsets"], x["base"])
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, _, losses, accs = fn(params, opt.init(params), *args)
    losses, accs = losses.cpu(), accs.cpu()        # waits for the epoch
    return params, losses, accs, time.perf_counter() - t0


def exchange_ms(torch, mesh, x, key, m_max, S):
    """The exchange alone: each step's ``pull_features`` between CUDA
    events, averaged over the steps."""
    from repro_torch.dist import pull_features
    bt = x[key]
    times = []
    for i in range(S):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        pull_features(mesh, x["table"], bt["send_ids"][i], bt["send_pos"][i],
                      bt["send_mask"][i], x["offsets"], m_max)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sum(times) / len(times)


def first_step_checks(torch, device, w, x):
    """(b) worker by worker on step 0: the pulled buffers are the numpy
    rows at ``send_pos``; staged, fused and a host gather of the features
    agree bit for bit. -> the step-0 inputs of worker 0 for the kernel
    row."""
    import numpy as np
    from repro_torch.dist import make_mesh, pull_features
    from repro_torch.kernels.assemble.ops import assemble_features
    from repro_torch.kernels.cache_lookup.ops import to_device_ids

    dv, rapid, m_max = w["dv"], w["rapid"], w["m_max"]
    mesh = make_mesh((PARTS,), ("data",), device=device)
    bt = x["rapid"]
    pulled = pull_features(mesh, x["table"], bt["send_ids"][0],
                           bt["send_pos"][0], bt["send_mask"][0],
                           x["offsets"], m_max)
    flat = dv.table.reshape(-1, dv.table.shape[-1])
    cids32 = to_device_ids(x["cids"])
    query = to_device_ids(bt["input_nodes"][0])
    for p in range(PARTS):
        msk = rapid["send_mask"][0, p]
        want = np.zeros((m_max, flat.shape[1]), np.float32)
        want[rapid["send_pos"][0, p][msk]] = \
            flat[rapid["send_ids"][0, p][msk]] + 0.0
        if want.tobytes() != pulled[p].cpu().numpy().tobytes():
            raise RuntimeError(f"worker {p}: pulled buffer differs from the "
                               f"numpy rows at send_pos")
        base = int(dv.offsets[p, 0])
        feats = {be: assemble_features(
            x["table"][p], base, cids32[p], x["cfeats"][p], query[p],
            pulled[p], backend=be).cpu().numpy() for be in ("fused",
                                                            "staged")}
        ids = rapid["input_nodes"][0, p]
        host = np.where((ids >= 0)[:, None], flat[np.maximum(ids, 0)], 0.0) \
            .astype(np.float32)
        if not (feats["fused"].tobytes() == feats["staged"].tobytes()
                == host.tobytes()):
            raise RuntimeError(f"worker {p}: staged, fused and host-gathered "
                               f"features differ on step 0")
    return {"cache_feats": x["cfeats"][0], "base": pulled[0],
            "cache_ids": cids32[0], "query": query[0]}


def dist_phase(torch, device, g, pg, counters):
    """(a)-(d): the pipelined epoch with the fused and the staged
    assembly and the on-demand epoch, all P workers on the card."""
    import numpy as np
    from repro_torch.dist import host_miss_matrix, make_mesh
    from repro_torch.dist.gnn_step import tree_to_device

    w = dist_world(g, pg)
    x = tree_to_device({"table": w["dv"].table,
                        "offsets": w["dv"].offsets.reshape(-1),
                        "cids": w["cids"], "cfeats": w["cfeats"],
                        "rapid": w["rapid"], "base": w["base"]}, device)
    S, m_max = w["S"], w["m_max"]
    # two rounds of the three runs, in turns: every curve must be the
    # first one bit for bit, and the spread of ms/step shows
    runs, launches, peaks = {}, {}, {}
    want_on = {"rapid fused": ("search", "assemble", "gather_agg",
                               "gather_agg_bwd"),
               "rapid staged": ("search", "merge_gather", "gather_agg",
                                "gather_agg_bwd"),
               "on-demand": ("search", "assemble", "gather_agg",
                             "gather_agg_bwd")}
    for _ in range(2):
        for name, kind, backend in (("rapid fused", "rapid", "fused"),
                                    ("rapid staged", "rapid", "staged"),
                                    ("on-demand", "ondemand", "fused")):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.reset()
            runs.setdefault(name, []).append(
                dist_run(torch, device, w, x, kind, backend))
            torch.cuda.synchronize()
            launches[name] = {c.name: c.value for c in counters}
            peaks[name] = torch.cuda.max_memory_allocated()
            idle = [k for k in want_on[name] if launches[name][k] == 0]
            if idle:
                raise RuntimeError(f"{name} epoch did not launch {idle}: "
                                   f"{launches[name]}")
    if launches["rapid fused"]["merge_gather"] or \
            launches["rapid staged"]["assemble"]:
        raise RuntimeError(f"a backend ran another's kernel: {launches}")
    # the backward orders its edges in its own kernel: no seg_sort
    if any(v["seg_sort"] for v in launches.values()):
        raise RuntimeError(f"a distributed epoch launched seg_sort: "
                           f"{launches}")
    fused = runs["rapid fused"][0][1]
    if not bool(torch.isfinite(fused).all()) or fused.shape != (S,):
        raise RuntimeError(f"bad loss curve {fused.tolist()}")
    for name, rs in runs.items():
        for r in rs:
            if not torch.equal(r[1], fused):
                raise RuntimeError(f"{name} loss curve {r[1].tolist()} is "
                                   f"not the fused one {fused.tolist()}")
    first, again = runs["rapid fused"]
    for a, b in zip(again[0]["layers"], first[0]["layers"]):
        for k in a:
            if not torch.equal(a[k], b[k]):
                raise RuntimeError("a second fused run gave other weights")
    cpu_x = tree_to_device({"table": w["dv"].table,
                            "offsets": w["dv"].offsets.reshape(-1),
                            "cids": w["cids"], "cfeats": w["cfeats"],
                            "rapid": first_steps(w["rapid"], CPU_LOSS_STEPS)},
                           torch.device("cpu"))
    cpu = dist_run(torch, torch.device("cpu"), w, cpu_x, "rapid", "fused")
    np.testing.assert_allclose(fused[:CPU_LOSS_STEPS].numpy(), cpu[1].numpy(),
                               rtol=1e-4, atol=1e-5)

    # (b) step 0 worker by worker; lanes against the host-sim runner
    kernel_in = first_step_checks(torch, device, w, x)
    lanes = w["rapid"]["send_mask"].sum(axis=(0, 2, 3))
    lanes_base = w["base"]["send_mask"].sum(axis=(0, 2, 3))
    host = host_miss_matrix(w["schedules"], pg, w["exp"].batch_size)[0]
    if not np.array_equal(lanes, host):
        raise RuntimeError(f"pull lanes {lanes.tolist()} != host-sim "
                           f"cache_misses {host.tolist()}")

    # (d) the exchange alone, bytes, and a traced fused epoch
    mesh = make_mesh((PARTS,), ("data",), device=device)
    row = g.feat_dim * 4
    traffic = {}
    for key in ("rapid", "base"):
        n_lanes = int(w[key]["send_mask"].sum())
        slots = int(w[key]["send_ids"].size)
        traffic[key] = {"payload_bytes": n_lanes * row,
                        "wire_bytes": slots * row,
                        "request_bytes": slots * 4,
                        "exchange_ms_per_step": exchange_ms(
                            torch, mesh, x, key, m_max, S)}
    traced_s, busy_ms, ops = card_time_by_op(
        torch, lambda: dist_run(torch, device, w, x, "rapid", "fused"), 10)
    out = {"workers": PARTS, "steps": S, "m_max": m_max,
           "k_max": w["k_max"], "k_max_on_demand": w["k_base"],
           "losses": fused.tolist(), "cpu_losses": cpu[1].tolist(),
           "accs": first[2].tolist(),
           "ms_per_step": {k: [1e3 * r[3] / S for r in rs]
                           for k, rs in runs.items()},
           "launches": launches, "peak_bytes": peaks, "dead_pull": "skipped",
           "miss_lanes": {"rapid": lanes.tolist(),
                          "on_demand": lanes_base.tolist(),
                          "host_sim": host.tolist(),
                          "cut": float(lanes_base.sum() / max(lanes.sum(), 1))},
           "traffic": traffic,
           "traced_ms_per_step": 1e3 * traced_s / S,
           "card_busy_ms_per_step": busy_ms / S,
           "card_busy_share": busy_ms / 1e3 / traced_s,
           "card_ms_by_op_per_step": {k: v / S for k, v in ops.items()}}
    log(f"dist epoch: {PARTS} workers x {S} steps on one card; loss curves "
        f"of rapid fused, rapid staged and on-demand bit-equal, each run "
        f"twice (the second fused run's weights bit-identical too), the "
        f"first {CPU_LOSS_STEPS} within "
        f"rtol=1e-4 atol=1e-5 of the CPU; losses "
        f"{['%.6f' % v for v in out['losses']]}")
    log("dist ms/step (first, second run): " + ", ".join(
        f"{k} {v[0]:.2f} {v[1]:.2f}" for k, v in out["ms_per_step"].items())
        + f"; exchange "
        f"alone {traffic['rapid']['exchange_ms_per_step']:.3f} ms/step "
        f"(rapid), {traffic['base']['exchange_ms_per_step']:.3f} "
        f"(on-demand); peak device memory "
        f"{peaks['rapid fused'] / 2**20:.1f} MiB (fused), "
        f"{peaks['rapid staged'] / 2**20:.1f} (staged), "
        f"{peaks['on-demand'] / 2**20:.1f} (on-demand)")
    log(f"dist launches {json.dumps(launches)}; dead pull (the last step's "
        f"masked prefetch): skipped")
    log(f"dist miss lanes per worker: rapid {lanes.tolist()} (== host-sim "
        f"cache_misses), on-demand {lanes_base.tolist()}: remote fetches "
        f"cut {out['miss_lanes']['cut']:.3f}x")
    for key, t in traffic.items():
        log(f"dist bytes an epoch ({'rapid' if key == 'rapid' else 'on-demand'}"
            f"): payload_bytes {t['payload_bytes']} wire_bytes "
            f"{t['wire_bytes']} request_bytes {t['request_bytes']}")
    log(f"dist traced fused epoch: {out['traced_ms_per_step']:.2f} ms/step, "
        f"card busy {out['card_busy_ms_per_step']:.3f} ms/step "
        f"({100 * out['card_busy_share']:.2f} %); card ms a step by op "
        f"{json.dumps(out['card_ms_by_op_per_step'])}")
    return out, kernel_in


def embedding_phase(torch, device, counters):
    """(e) the hot-token embedding path at gemma2-2b's widths: every
    worker's batch through ``device_embedding_lookup`` over a residual-
    miss plan, equal to ``table[tokens]`` bit for bit."""
    import numpy as np
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.data.pipeline import (enumerate_token_accesses,
                                           zipf_tokens)
    from repro_torch.dist import build_pull_plan, make_mesh
    from repro_torch.graph.sampler import rng_from
    from repro_torch.models.transformer.embedding import (
        HotEmbeddingSim, device_embedding_lookup)

    cfg = get_arch(LM_ARCH) if LM_FULL else get_reduced(LM_ARCH)
    V, d, W = cfg.vocab_size, cfg.d_model, EMB_WORKERS
    m = EMB_BATCH * EMB_SEQ
    t0 = time.perf_counter()
    counts = enumerate_token_accesses(cfg, EMB_BATCH, EMB_SEQ, EMB_STEPS,
                                      s0=EMB_S0)
    sim = HotEmbeddingSim(vocab=V, d=d, num_workers=W, n_hot=EMB_N_HOT,
                          counts=counts)
    vper = -(-V // W)
    # worker w serves step w of the enumerated run
    tokens = np.stack([zipf_tokens(rng_from(EMB_S0, 0, w), V,
                                   (EMB_BATCH, EMB_SEQ)).reshape(-1)
                       for w in range(W)])
    cache_ids = np.full((W, EMB_N_HOT), 2 ** 31 - 1, np.int32)
    miss = []
    for p in range(W):
        c = sim.cache[p]
        cache_ids[p, :c.size] = c
        miss.append(~np.isin(tokens[p], c))
    k_max = max(int(np.bincount(sim.owner[tokens[p][miss[p]]],
                                minlength=W).max()) for p in range(W))
    plans = [build_pull_plan(tokens[p][miss[p]],
                             np.flatnonzero(miss[p]).astype(np.int32),
                             sim.owner, W, k_max) for p in range(W)]
    base_b = cach_b = hits = 0
    for p in range(W):
        b_, c_, h_ = sim.batch_traffic(tokens[p], worker=p)
        base_b, cach_b, hits = base_b + b_, cach_b + c_, hits + h_
    run_base = run_cach = 0
    for i in range(EMB_STEPS):
        b_, c_, _ = sim.batch_traffic(
            zipf_tokens(rng_from(EMB_S0, 0, i), V, (EMB_BATCH, EMB_SEQ)),
            worker=0)
        run_base, run_cach = run_base + b_, run_cach + c_
    run_cach += sim.cache_build_bytes()
    host_s = time.perf_counter() - t0

    gen = torch.Generator(device=device).manual_seed(EMB_S0)
    table = torch.randn((W * vper, d), generator=gen, device=device)
    cids = torch.from_numpy(cache_ids).to(device)
    cfeats = table[cids.clamp(max=W * vper - 1).long()]
    tok = torch.from_numpy(tokens).to(device)
    plan = {k: torch.from_numpy(np.stack([getattr(p, k) for p in plans]))
            .to(device) for k in ("send_ids", "send_pos", "send_mask")}
    plan["offsets"] = (torch.arange(W, dtype=torch.int32, device=device)
                       * vper)
    mesh = make_mesh((W,), ("data",), device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t1 = time.perf_counter()
    got = device_embedding_lookup(mesh, table.view(W, vper, d), cids,
                                  cfeats, tok, plan, m)
    torch.cuda.synchronize()
    lookup_s = time.perf_counter() - t1
    launches = {c.name: c.value for c in counters}
    peak = torch.cuda.max_memory_allocated()
    want = table[tok.long()]
    if got.shape != want.shape or not torch.equal(
            got.view(torch.int32), want.view(torch.int32)):
        raise RuntimeError("device_embedding_lookup differs from "
                           "table[tokens]")
    if launches["search"] != W or launches["merge_gather"] != W:
        raise RuntimeError(f"embedding lookup launched {launches}, expected "
                           f"{W} search and {W} merge_gather")
    out = {"arch": cfg.name, "vocab": V, "d": d, "workers": W,
           "tokens_per_worker": m, "n_hot": EMB_N_HOT, "k_max": k_max,
           "table_bytes": table.numel() * 4, "lookup_ms": 1e3 * lookup_s,
           "host_prep_s": host_s, "peak_bytes": peak, "launches": launches,
           "hits": hits, "batch_baseline_bytes": base_b,
           "batch_cached_bytes": cach_b,
           "run_worker0_baseline_bytes": run_base,
           "run_worker0_cached_bytes": run_cach}
    log(f"embedding {cfg.name}: vocab {V} d {d} float32 table "
        f"{out['table_bytes'] / 1e9:.2f} GB, {W} workers x {m} tokens, n_hot "
        f"{EMB_N_HOT}, k_max {k_max}: device_embedding_lookup == "
        f"table[tokens] bit for bit; lookup {out['lookup_ms']:.2f} ms, peak "
        f"device memory {peak / 2**30:.2f} GiB, launches {json.dumps(launches)}")
    log(f"embedding traffic (HotEmbeddingSim.batch_traffic): these {W} "
        f"batches {base_b / 1e6:.1f} MB -> {cach_b / 1e6:.1f} MB "
        f"({base_b / max(cach_b, 1):.2f}x less, {hits} hits); worker 0 over "
        f"{EMB_STEPS} steps with the cache build {run_base / 1e6:.1f} MB -> "
        f"{run_cach / 1e6:.1f} MB ({run_base / max(run_cach, 1):.2f}x less)")
    from repro_torch.kernels.cache_lookup.ops import search
    pos, hit = search(cids[0], tok[0])
    return out, {"cache_feats": cfeats[0], "base": got[0].clone(),
                 "pos": pos, "hit": hit}


def merge_awkward(torch, device):
    """(name, cache_ids, cache_feats, query, base): d 1 / 602 / 2304,
    m 0, an empty cache, all hits, no hits, bfloat16 (both sides and
    mixed), -1 and sentinel queries."""
    gen = torch.Generator(device="cpu").manual_seed(17)
    sentinel = 2 ** 31 - 1
    out = []
    for name, m, n_hot, d, cdt, bdt, kind in (
            ("d_1", 1001, 37, 1, torch.float32, torch.float32, "mixed"),
            ("d_602", 777, 64, 602, torch.float32, torch.float32, "mixed"),
            ("d_2304", 300, 50, 2304, torch.float32, torch.float32, "mixed"),
            ("m_0", 0, 8, 602, torch.float32, torch.float32, "mixed"),
            ("empty_cache", 99, 0, 602, torch.float32, torch.float32,
             "mixed"),
            ("all_hit", 500, 64, 130, torch.float32, torch.float32, "hit"),
            ("no_hit", 500, 64, 130, torch.float32, torch.float32, "miss"),
            ("bf16", 400, 40, 2304, torch.bfloat16, torch.bfloat16,
             "mixed"),
            ("bf16_odd_d", 400, 40, 3, torch.bfloat16, torch.bfloat16,
             "mixed"),
            ("f32_cache_bf16_base", 300, 40, 602, torch.float32,
             torch.bfloat16, "mixed"),
            ("bf16_cache_f32_base", 300, 40, 602, torch.bfloat16,
             torch.float32, "mixed"),
            ("padded_queries", 513, 32, 7, torch.float32, torch.float32,
             "padded")):
        ids = torch.randperm(5000, generator=gen)[:n_hot].sort().values \
            .to(torch.int32)
        feats = torch.randn((n_hot, d), generator=gen).to(cdt)
        if kind == "hit":
            q = ids[torch.randint(0, n_hot, (m,), generator=gen)]
        elif kind == "miss":
            q = torch.randint(5000, 9000, (m,), generator=gen)
        else:
            q = torch.randint(0, 5200, (m,), generator=gen)
            if n_hot and m:
                q[::3] = ids[torch.randint(0, n_hot, (q[::3].shape[0],),
                                           generator=gen)]
            if kind == "padded":
                q[::4] = -1
                q[1::6] = sentinel
        base = torch.randn((m, d), generator=gen).to(bdt)
        out.append((name, ids.to(device), feats.to(device),
                    q.to(torch.int32).to(device), base.to(device)))
    return out


def merge_kernel_row(torch, device, dist_in, emb_in, launches):
    """(f) ``merge_gather`` against its plain version at the staged
    epoch's shape (worker 0, step 0) and the embedding shape (worker 0),
    and over the awkward cases, every case bit-exact; times from CUDA
    graph replays."""
    from repro_torch.kernels.cache_lookup import ops as lk
    from repro_torch.kernels.cache_lookup.ref import (cache_lookup_ref,
                                                      merge_gather_ref)

    pos, hit = lk.search(dist_in["cache_ids"], dist_in["query"])
    shapes = []
    for what, f, b, p, h in (
            ("staged epoch", dist_in["cache_feats"], dist_in["base"], pos,
             hit),
            ("embedding", emb_in["cache_feats"], emb_in["base"],
             emb_in["pos"], emb_in["hit"])):
        got = lk.merge_gather(f, b, p, h)
        _equal(torch, got, merge_gather_ref(f, b, p, h))
        m, d = b.shape
        r = {"what": what, "bound": bound_ms(2 * m * d * b.element_size()
                                             + m * 5, 0),
             "ms": device_ms(torch, lambda: lk.merge_gather(f, b, p, h)),
             "plain_ms": device_ms(torch, lambda: merge_gather_ref(
                 f, b, p, h)),
             "hit_rate": float(h.float().mean().item()),
             "shape": f"base=({m},{d}) cache=({f.shape[0]},{d}) "
                      f"{str(b.dtype).split('.')[-1]}"}
        log(f"merge_gather {what}: {r['shape']} hit rate "
            f"{r['hit_rate']:.3f} ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound'][0]:.4f}; bit-equal to "
            f"its plain version")
        shapes.append(r)
    for name, ids, feats, q, base in merge_awkward(torch, device):
        p, h = lk.search(ids, q)
        _equal(torch, lk.merge_gather(feats, base, p, h),
               merge_gather_ref(feats, base, p, h))
        merged, mhit = lk.cache_lookup(ids, feats, q, base)
        want, whit = cache_lookup_ref(ids, feats, q, base)
        _equal(torch, merged, want)
        _equal(torch, mhit, whit)
    log("awkward shapes: merge_gather and cache_lookup (d 1/3/7/130/602/"
        "2304, m 0, empty cache, all hits, no hits, bf16 and mixed dtypes, "
        "-1 and sentinel queries) bit-equal to their plain versions")
    torch.cuda.synchronize()
    main = shapes[0]
    return {
        "name": "merge_gather", "route": "cuda",
        "source": "src/repro_torch/kernels/cache_lookup/csrc/merge_gather.cu",
        "replaces": "src/repro/kernels/cache_lookup/cache_lookup.py:103",
        "launches": launches, "max_abs_err": 0.0,
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound"][0], "bound_by": main["bound"][1],
        "library_ms": None, "shape": main["shape"],
        "embedding_shape": {"shape": shapes[1]["shape"],
                            "ms": shapes[1]["ms"],
                            "plain_ms": shapes[1]["plain_ms"],
                            "bound_ms": shapes[1]["bound"][0]}}


# ---------------------------------------------------------------------------
# phase 8: the multi-epoch runner (C_s/C_sec swap, staging thread, run states)
# ---------------------------------------------------------------------------

RUNNER_EPOCHS = 3


def runner_world(torch, device, g, pg):
    """The paper's GraphSAGE on all PARTS workers for RUNNER_EPOCHS
    epochs: schedules from the numpy compiler, and lazy ones compiled on
    the card (rebuilt by the runner's staging thread)."""
    from repro_torch.configs.rapidgnn_paper import sage
    from repro_torch.core import build_schedule
    from repro_torch.dist import DeviceView
    from repro_torch.graph import KHopSampler
    from repro_torch.models.gnn import GNNConfig

    exp = sage(DATASET, TRAIN_BATCH, workers=PARTS, epochs=RUNNER_EPOCHS)
    sampler = KHopSampler(g, fanouts=list(exp.fanouts),
                          batch_size=exp.batch_size)
    cfg = GNNConfig(kind=exp.model, in_dim=g.feat_dim,
                    hidden_dim=exp.hidden_dim, num_classes=g.num_classes,
                    num_layers=exp.num_layers, fanouts=tuple(exp.fanouts),
                    agg_backend="kernel")
    t0 = time.perf_counter()
    eager = [build_schedule(sampler, pg, worker=w, s0=exp.s0,
                            num_epochs=RUNNER_EPOCHS, n_hot=exp.n_hot)
             for w in range(PARTS)]
    t1 = time.perf_counter()
    lazy = [build_schedule(sampler, pg, worker=w, s0=exp.s0,
                           num_epochs=RUNNER_EPOCHS, n_hot=exp.n_hot,
                           compiler="device", lazy=True, device=device)
            for w in range(PARTS)]
    if device.type == "cuda":
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"runner world: {PARTS} workers x {RUNNER_EPOCHS} epochs, batch "
        f"{exp.batch_size}, n_hot {exp.n_hot}; schedules numpy "
        f"{t1 - t0:.2f} s, lazy on the card (metadata prepass) "
        f"{t2 - t1:.2f} s")
    return {"exp": exp, "cfg": cfg, "g": g, "pg": pg, "eager": eager,
            "lazy": lazy, "dv": DeviceView.build(pg)}


def runner_make(w, device, kind="rapid", layout="flat", lazy=False, **kw):
    from repro_torch.dist import (DeviceBaselineRunner, DeviceRapidGNNRunner,
                                  Topology, make_mesh)
    from repro_torch.train import AdamW

    topo = Topology.parse(layout, PARTS)
    mesh = (topo.make_mesh(device) if topo.is_hierarchical
            else make_mesh((PARTS,), ("data",), device=device))
    cls = DeviceRapidGNNRunner if kind == "rapid" else DeviceBaselineRunner
    return cls(w["lazy" if lazy else "eager"], w["dv"], w["cfg"],
               AdamW(lr=TRAIN_LR), mesh, w["exp"].batch_size, w["g"].labels,
               seed=w["exp"].s0, assemble_backend="fused", topology=topo,
               **kw)


def runner_drive(torch, runner, counters, **run_kw):
    """One run with every launch count set to 0 just before it and read
    just after -> (reports, launches, peak device bytes the run added to
    what was allocated when it started)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    for c in counters:
        c.reset()
    reports = runner.run(**run_kw)
    torch.cuda.synchronize()
    return (reports, {c.name: c.value for c in counters},
            torch.cuda.max_memory_allocated() - held)


def runner_epochs(reports):
    """Per epoch: train ms a step (the epoch's wall less the boundary
    copy and the exposed staging), wall, staging, copy, lanes, wires."""
    return [{"epoch": r.epoch,
             "train_ms_per_step": 1e3 * (r.wall_time_s - r.copy_s
                                         - r.exposed_stage_s) / r.steps,
             "wall_time_s": r.wall_time_s, "stage_s": r.stage_s,
             "exposed_stage_s": r.exposed_stage_s,
             "copy_ms": 1e3 * r.copy_s,
             "miss_lanes": r.miss_lanes.tolist(),
             "wire_rows": int(r.wire_rows),
             "intra_wire_rows": int(r.intra_wire_rows),
             "inter_wire_rows": int(r.inter_wire_rows),
             "degraded": r.degrade_reason or None} for r in reports]


def runner_cpu_losses(torch, w, runner):
    """The first CPU_LOSS_STEPS steps of epoch 0, collated to the
    runner's bounds, through the port's pipelined epoch on the CPU."""
    from repro_torch.dist import (collate_device_epoch, make_mesh,
                                  make_pipelined_epoch, stack_caches)
    from repro_torch.models.gnn import init_params
    from repro_torch.train import AdamW

    cpu = torch.device("cpu")
    dv, exp = w["dv"], w["exp"]
    es = [ws.epoch(0) for ws in w["eager"]]
    caches = [dv.remap_cache(e.cache_ids) for e in es]
    batches = collate_device_epoch(es, caches, dv, w["g"].labels,
                                   exp.batch_size, runner.m_max,
                                   runner.edge_max, runner.k_max,
                                   runner.num_steps)
    cids, cfeats = stack_caches(caches, dv, runner.n_hot)
    params = init_params(w["cfg"], torch.Generator().manual_seed(exp.s0),
                         cpu)
    opt = AdamW(lr=TRAIN_LR)
    fn = make_pipelined_epoch(w["cfg"], opt,
                              make_mesh((PARTS,), ("data",), device=cpu),
                              runner.m_max, assemble_backend="fused")
    return fn(params, opt.init(params), dv.table, dv.offsets, cids, cfeats,
              first_steps(batches, CPU_LOSS_STEPS))[2].numpy()


def _curve(reports):
    import numpy as np
    return np.concatenate([r.losses for r in reports])


def runner_phase(torch, device, g, pg, counters):
    """(a)-(f): the multi-epoch runners on the card, each run's curve
    held against (a)'s bit for bit."""
    import tempfile

    import numpy as np
    from repro_torch.dist import assert_host_parity
    from repro_torch.fault import active_plan, plan_from_profile
    from repro_torch.models.gnn import init_params
    from repro_torch.train import latest_step, load_run_state

    w = runner_world(torch, device, g, pg)
    B = w["exp"].batch_size
    runs, launches, peaks, counts = {}, {}, {}, {}

    def drive(name, runner, **run_kw):
        reports, launches[name], peaks[name] = runner_drive(
            torch, runner, counters, **run_kw)
        runs[name] = reports
        counts[name] = {"trace_count": runner.trace_count,
                        "stage_time_s": runner.stage_time_s,
                        "exposed_stage_s": runner.exposed_stage_s,
                        "recovery_wall_s": runner.recovery_wall_s,
                        "stage_retries": runner.stage_retries,
                        "deadline_overruns": runner.deadline_overruns,
                        "degraded_epochs": runner.degraded_epochs}
        idle = [k for k in ("search", "assemble", "gather_agg",
                            "gather_agg_bwd") if launches[name][k] == 0]
        if idle or launches[name]["merge_gather"]:
            raise RuntimeError(f"runner {name}: launches {launches[name]}")
        return runner, reports

    # (a) rapid, numpy schedules, flat; run twice
    first, rep_a = drive("a rapid flat", runner_make(w, device))
    again, rep_a2 = drive("a rapid flat, again", runner_make(w, device))
    curve = _curve(rep_a)
    if first.trace_count != 1 or again.trace_count != 1:
        raise RuntimeError(f"trace_count {first.trace_count}, "
                           f"{again.trace_count}: expected 1")
    if not np.isfinite(curve).all() or curve.shape != (
            RUNNER_EPOCHS * first.num_steps,):
        raise RuntimeError(f"bad runner curve {curve.tolist()}")
    if curve.tobytes() != _curve(rep_a2).tobytes():
        raise RuntimeError("a second runner run gave another curve")
    for x, y in zip(first.params["layers"], again.params["layers"]):
        for k in x:
            if not torch.equal(x[k], y[k]):
                raise RuntimeError("a second runner run gave other weights")
    assert_host_parity(w["eager"], pg, B, rep_a)
    cpu = runner_cpu_losses(torch, w, first)
    np.testing.assert_allclose(curve[:CPU_LOSS_STEPS], cpu, rtol=1e-4,
                               atol=1e-5)

    # (b) lazy schedules compiled on the card by the staging thread
    lazy, rep_b = drive("b rapid flat, lazy on the card",
                        runner_make(w, device, lazy=True))
    if _curve(rep_b).tobytes() != curve.tobytes():
        raise RuntimeError("the lazy card schedule changed the curve")
    if launches["b rapid flat, lazy on the card"]["seg_sort"] == 0:
        raise RuntimeError("the staging thread launched no seg_sort")
    if any(launches[k]["seg_sort"] for k in launches if not
           k.startswith("b ")):
        raise RuntimeError(f"seg_sort outside the lazy run: {launches}")

    # (c) the on-demand baseline
    _, rep_c = drive("c baseline flat", runner_make(w, device, "baseline"))
    if _curve(rep_c).tobytes() != curve.tobytes():
        raise RuntimeError("the baseline runner's curve is not (a)'s")
    for r, b in zip(rep_a, rep_c):
        if (b.miss_lanes < r.miss_lanes).any():
            raise RuntimeError(f"epoch {r.epoch}: baseline lanes "
                               f"{b.miss_lanes} < rapid {r.miss_lanes}")

    # (d) two hosts of two
    hier, rep_d = drive("d rapid 2x2", runner_make(w, device,
                                                   layout="2x2"))
    if _curve(rep_d).tobytes() != curve.tobytes() or hier.trace_count != 1:
        raise RuntimeError("the 2x2 runner's curve is not (a)'s")
    for r, h in zip(rep_a, rep_d):
        if not np.array_equal(h.intra_lanes + h.inter_lanes, r.miss_lanes) \
                or h.intra_wire_rows + h.inter_wire_rows != h.wire_rows:
            raise RuntimeError(f"epoch {r.epoch}: tiers do not add up")

    # (e) checkpoint after epoch 1, resume [1, 3) in a fresh runner
    os.makedirs(OUT_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as td:
        _, head = drive("e head [0, 1)",
                        runner_make(w, device, checkpoint_dir=td),
                        stop_epoch=1)
        tail_runner = runner_make(w, device)
        like = init_params(w["cfg"], torch.Generator().manual_seed(1),
                           device)
        t0 = time.perf_counter()
        state, step = load_run_state(td, {"params": like,
                                          "opt": tail_runner.opt.init(like)})
        load_s = time.perf_counter() - t0
        if step != 1 or latest_step(td) != 1:
            raise RuntimeError(f"run state at step {step}, expected 1")
        _, tail = drive("e tail [1, 3)", tail_runner,
                        params=state["params"], opt_state=state["opt"],
                        start_epoch=step)
    if _curve(head + tail).tobytes() != curve.tobytes():
        raise RuntimeError("the resumed curve is not (a)'s")
    for x, y in zip(tail_runner.params["layers"], first.params["layers"]):
        for k in x:
            if not torch.equal(x[k], y[k]):
                raise RuntimeError("the resumed run gave other weights")

    # (f) the cache-loss fault profile
    plan = plan_from_profile("cache-loss", seed=3)
    with active_plan(plan):
        lost, rep_f = drive("f rapid flat, cache-loss",
                            runner_make(w, device))
    if (rep_f[1].degraded, rep_f[1].degrade_reason) != (1, "cache_lost") \
            or sum(r.degraded for r in rep_f) != 1:
        raise RuntimeError(f"cache-loss: epochs degraded "
                           f"{[r.degrade_reason for r in rep_f]}")
    if _curve(rep_f).tobytes() != curve.tobytes() or lost.trace_count > 2:
        raise RuntimeError(f"cache-loss changed the curve (trace_count "
                           f"{lost.trace_count})")

    out = {"epochs": RUNNER_EPOCHS, "steps": first.num_steps,
           "m_max": first.m_max, "k_max": first.k_max,
           "k_max_2x2": [hier.k_max, hier.k_max_inter],
           "losses": curve.tolist(), "cpu_losses": cpu.tolist(),
           "runs": {k: runner_epochs(v) for k, v in runs.items()},
           "runners": counts, "launches": launches, "peak_bytes": peaks,
           "run_state_load_s": load_s}
    log(f"runner: {PARTS} workers x {RUNNER_EPOCHS} epochs x "
        f"{first.num_steps} steps; (a) trace_count 1, host parity on every "
        f"epoch, run twice bit-identical, first {CPU_LOSS_STEPS} losses "
        f"within rtol=1e-4 atol=1e-5 of the CPU port; (b) lazy card "
        f"schedules, (c) baseline, (d) 2x2, (e) resumed from a run state "
        f"after epoch 1, (f) cache-loss (epoch 1 degraded, trace_count "
        f"{lost.trace_count}): every curve bit-equal to (a); losses "
        f"{['%.6f' % v for v in curve[::first.num_steps]]} at each "
        f"epoch's start")
    for name, epochs in out["runs"].items():
        for e in epochs:
            tiers = (f" (intra {e['intra_wire_rows']} + inter "
                     f"{e['inter_wire_rows']})"
                     if e["inter_wire_rows"] else "")
            log(f"runner {name} epoch {e['epoch']}: "
                f"{e['train_ms_per_step']:.2f} ms/step, wall "
                f"{e['wall_time_s']:.3f} s, stage_s {e['stage_s']:.3f}, "
                f"exposed_stage_s {e['exposed_stage_s']:.3f}, copy "
                f"{e['copy_ms']:.2f} ms, miss lanes {e['miss_lanes']}, "
                f"wire rows {e['wire_rows']}{tiers}"
                + (f", degraded ({e['degraded']})" if e["degraded"] else ""))
    log("runner launches " + json.dumps(launches))
    log("runner peak device memory MiB above each run's start " + json.dumps(
        {k: round(v / 2 ** 20, 1) for k, v in peaks.items()}))
    log("runner staging " + json.dumps(
        {k: {f: round(v, 4) if isinstance(v, float) else v
             for f, v in c.items()} for k, c in counts.items()}))
    return out


# ---------------------------------------------------------------------------
# phase 9: the paper-metrics campaign, the fault campaign, the chaos sweep
# ---------------------------------------------------------------------------

CAMPAIGN_EPOCHS = 3
CAMPAIGN_N_HOT = 4096
#: launches each cell must make (the schedule's seg_sort is (b)'s only)
HOST_CELL_KERNELS = ("gather_agg", "gather_agg_bwd")
DEVICE_CELL_KERNELS = ("search", "assemble", "gather_agg", "gather_agg_bwd")
#: the differential layers the full-width campaign must run
CAMPAIGN_CHECKS = ("miss_parity", "payload_bytes", "vector_pull_bytes",
                   "fetch_not_more", "loss_agreement", "topology_miss_parity",
                   "topology_byte_sum", "topology_loss_parity",
                   "one_compilation")


def campaign_spec(schedule_backend: str):
    """The paper's GraphSAGE at full width as a campaign: rapid vs the
    on-demand baseline on both backends, and the device pair again on
    two hosts of two workers (6 cells)."""
    import dataclasses

    from repro_torch.eval import CampaignSpec, grid

    cells = grid(backends=("host", "device"),
                 systems=("rapidgnn", "dgl-metis"), datasets=(DATASET,),
                 batch_sizes=(TRAIN_BATCH,), workers=(PARTS,),
                 n_hots=(CAMPAIGN_N_HOT,), epochs=CAMPAIGN_EPOCHS, seed=42,
                 fanouts=(25, 10), hidden=256, partition="greedy",
                 schedule_backend=schedule_backend)
    cells += [dataclasses.replace(c, topology="2x2")
              for c in cells if c.backend == "device"]
    return CampaignSpec(name=f"paper-{DATASET}-{schedule_backend}",
                        cells=tuple(cells))


def campaign_run(torch, device, spec, counters, out_path):
    """Every cell through the port's cell runners, one at a time with
    the launch counts set to 0 just before it and read just after (device
    cells of one scenario share their schedules), then the differential
    checks and the report, as ``run_campaign`` makes them."""
    from repro_torch.eval import (build_report, run_device_cells,
                                  run_host_cell, verify_cells, write_report)

    cells, launches, peaks, scenarios = [], [], [], {}
    t0 = time.perf_counter()
    for c in spec.cells:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        for k in counters:
            k.reset()
        if c.backend == "host":
            cells.append(run_host_cell(c, device=device))
        else:
            cells.append(run_device_cells([c], device=device,
                                          scenarios=scenarios)[0])
        torch.cuda.synchronize()
        launches.append({k.name: k.value for k in counters})
        peaks.append(torch.cuda.max_memory_allocated() - held)
        want = HOST_CELL_KERNELS if c.backend == "host" \
            else DEVICE_CELL_KERNELS
        idle = [k for k in want if launches[-1][k] == 0]
        seg = launches[-1]["seg_sort"]
        if idle or launches[-1]["merge_gather"] or (
                (seg == 0) == (c.schedule_backend == "device")):
            raise RuntimeError(f"campaign cell {c.label()}: launches "
                               f"{launches[-1]}")
    report = build_report(spec.name, cells, verify_cells(cells))
    write_report(report, out_path)
    return {"cells": cells, "report": report, "launches": launches,
            "peaks": peaks, "wall_s": time.perf_counter() - t0}


def campaign_gates(run, runner):
    """The report validates, every check passes with every layer
    present, each device cell traced one input shape, and the device
    rapid cell's curve is phase 8's run (a) bit for bit: the same
    schedules, parameters and kernels, so its first steps also agree
    with phase 8's CPU steps."""
    import numpy as np
    from repro_torch.eval import validate_report

    report = run["report"]
    probs = validate_report(report)
    fails = [c for c in report["differential"] if c["status"] == "FAIL"]
    ran = {c["check"] for c in report["differential"]}
    missing = [k for k in CAMPAIGN_CHECKS if k not in ran]
    if probs or fails or missing or not report["all_checks_pass"]:
        raise RuntimeError(f"campaign {report['campaign']}: invalid {probs}, "
                           f"failed {fails}, layers missing {missing}")
    traces = [c.trace_count for c in run["cells"] if c.backend == "device"]
    if traces != [1] * 4:
        raise RuntimeError(f"device cells traced {traces}: expected 1 each")
    rapid = next(c for c in run["cells"] if c.backend == "device"
                 and c.system == "rapidgnn" and c.spec["topology"] == "flat")
    curve = np.asarray(rapid.losses, np.float32)
    if curve.tobytes() != np.asarray(runner["losses"],
                                     np.float32).tobytes():
        raise RuntimeError("the campaign's device rapid cell is not phase "
                           "8's run (a)")
    np.testing.assert_allclose(curve[:CPU_LOSS_STEPS], runner["cpu_losses"],
                               rtol=1e-4, atol=1e-5)


#: the fields of a cell that no clock decides
CELL_COUNTS = ("num_steps", "warm_steps", "rpc_count", "remote_requests",
               "cache_hits", "cache_misses", "hit_rate", "remote_bytes",
               "vector_pull_bytes", "payload_bytes", "miss_matrix",
               "wire_rows", "device_cache_bytes", "request_bytes",
               "intra_misses", "inter_misses", "intra_bytes", "inter_bytes",
               "intra_wire_rows", "inter_wire_rows", "trace_count",
               "degraded_epochs", "fault_events", "losses", "accs")


def campaign_cell_lines(name, run):
    for c, ln, pk in zip(run["cells"], run["launches"], run["peaks"]):
        tiers = (f" (intra {c.intra_wire_rows} + inter {c.inter_wire_rows})"
                 if c.backend == "device" else "")
        log(f"campaign {name} {c.spec['backend']}/{c.system}/"
            f"{c.spec['topology']}: step_time_ms {c.step_time_ms:.3f}, "
            f"warm_wall_s {c.warm_wall_s:.3f}, rpc_count {c.rpc_count}, "
            f"remote_bytes {c.remote_bytes}, vector_pull_bytes "
            f"{c.vector_pull_bytes}, wire_rows {c.wire_rows}{tiers}, "
            f"hit_rate {c.hit_rate:.4f}, trace_count {c.trace_count}, "
            f"stage_time_s {c.stage_time_s:.3f} / exposed_stage_s "
            f"{c.exposed_stage_s:.3f}, launches "
            f"{json.dumps({k: v for k, v in ln.items() if v})}, peak "
            f"{pk / 2 ** 20:.1f} MiB")
    for p in run["report"]["pairs"]:
        e = p["energy"]
        log(f"campaign {name} pair {p['backend']}/"
            f"{p['scenario']['topology']} rapid vs {p['baseline_system']}: "
            f"throughput_speedup {p['throughput_speedup']}x, "
            f"fetch_reduction_x {p['fetch_reduction_x']}, "
            f"bytes_reduction_x {p['bytes_reduction_x']}; modelled energy "
            f"(Table 3 power x measured time) cpu_ratio {e['cpu_ratio']}, "
            f"gpu_ratio {e['gpu_ratio']}, total_ratio {e['total_ratio']}")
    n = {s: sum(1 for c in run["report"]["differential"] if c["status"] == s)
         for s in ("PASS", "FAIL", "SKIP")}
    log(f"campaign {name} differential: {n['PASS']} passed, {n['FAIL']} "
        f"failed, {n['SKIP']} skipped; wall {run['wall_s']:.2f} s")


def chaos_lines(out, cpu):
    for r, c in zip(out["runs"], cpu["runs"]):
        log(f"chaos train {r['plan']}: fires {r['fires']}, {r['outcome']} "
            f"(CPU: fires {c['fires']}, {c['outcome']})")
    for r in out["serve"]["runs"]:
        log(f"chaos serve {r['plan']}: fires {r['fires']}, ok {r['ok']}, "
            f"shed {r['shed']}, typed {r['typed']}, stale {r['stale']}")


def campaign_phase(torch, device, counters, runner):
    """(a) the paper campaign at full width, (b) the same grid with
    every schedule compiled on the card, (c) the fault campaign, (d) the
    chaos sweep on the card beside the same sweep on the CPU."""
    from repro_torch.eval import validate_fault_report
    from repro_torch.eval.campaign import run_fault_campaign
    from repro_torch.fault.chaos import run_chaos

    os.makedirs(OUT_DIR, exist_ok=True)
    walls = {}
    runs = {}
    for name, backend in (("a", "numpy"), ("b", "device")):
        suffix = "" if backend == "numpy" else "_device"
        runs[name] = campaign_run(
            torch, device, campaign_spec(backend), counters,
            os.path.join(OUT_DIR, f"BENCH_torch_paper{suffix}.json"))
        campaign_gates(runs[name], runner)
        walls[name] = runs[name]["wall_s"]
    for ca, cb in zip(runs["a"]["cells"], runs["b"]["cells"]):
        diff = [k for k in CELL_COUNTS if getattr(ca, k) != getattr(cb, k)]
        if diff:
            raise RuntimeError(f"{cb.spec['backend']}/{cb.system}/"
                               f"{cb.spec['topology']}: (b) differs from (a) "
                               f"in {diff}")
    for name in ("a", "b"):
        campaign_cell_lines(name, runs[name])
    log("campaign (a) numpy schedules vs (b) schedules on the card, "
        "step_time_ms: " + ", ".join(
            f"{ca.spec['backend']}/{ca.system}/{ca.spec['topology']} "
            f"{ca.step_time_ms:.3f} vs {cb.step_time_ms:.3f}"
            for ca, cb in zip(runs["a"]["cells"], runs["b"]["cells"])))

    t0 = time.perf_counter()
    for k in counters:
        k.reset()
    fault = run_fault_campaign(
        device=device, out_path=os.path.join(OUT_DIR,
                                             "BENCH_torch_fault.json"))
    torch.cuda.synchronize()
    walls["c"] = time.perf_counter() - t0
    fault_launches = {k.name: k.value for k in counters}
    probs = validate_fault_report(fault)
    if probs or not fault["all_checks_pass"] or not any(
            r["degraded_epochs"] > 0 for r in fault["fault_summary"]):
        raise RuntimeError(f"fault campaign: invalid {probs}, failed "
                           f"{[c for c in fault['differential'] if c['status'] == 'FAIL']}")
    for r in fault["fault_summary"]:
        log(f"fault {r['backend']} {r['fault_profile']}: fires "
            f"{r['fault_events']}, degraded {r['degraded_epochs']}, retries "
            f"{r['retry_total']}, recovery_wall_s {r['recovery_wall_s']}")

    t0 = time.perf_counter()
    for k in counters:
        k.reset()
    chaos = run_chaos(seed=0, fast=True, device=device, log=lambda s: None)
    torch.cuda.synchronize()
    walls["d"] = time.perf_counter() - t0
    chaos_launches = {k.name: k.value for k in counters}
    t0 = time.perf_counter()
    cpu = run_chaos(seed=0, fast=True, device=torch.device("cpu"),
                    log=lambda s: None)
    walls["d CPU"] = time.perf_counter() - t0
    plans = [(r["plan"], r["fires"], r["outcome"]) for r in chaos["runs"]]
    if not chaos["ok"] or chaos["serve"]["trace_count"] != 1 or plans != [
            (r["plan"], r["fires"], r["outcome"]) for r in cpu["runs"]]:
        raise RuntimeError(f"chaos: ok {chaos['ok']}, failed "
                           f"{chaos['failed_plans']}, serve trace_count "
                           f"{chaos['serve']['trace_count']}, plans {plans}")
    idle = [k for k in DEVICE_CELL_KERNELS if chaos_launches[k] == 0]
    if idle or fault_launches["gather_agg_bwd"] == 0:
        raise RuntimeError(f"chaos launches {chaos_launches}, fault "
                           f"launches {fault_launches}")
    chaos_lines(chaos, cpu)
    log(f"chaos: {len(chaos['runs'])} train plans as on the CPU, "
        f"{len(chaos['serve']['runs'])} serve plans, serve trace_count 1, "
        f"checkpoint drill {chaos['checkpoint_drill']}; launches "
        + json.dumps({k: v for k, v in chaos_launches.items() if v}))
    log("fault campaign launches " + json.dumps(
        {k: v for k, v in fault_launches.items() if v}))
    total = {}
    for ln in runs["a"]["launches"]:
        for k, v in ln.items():
            total[k] = total.get(k, 0) + v
    log("campaign (a) launches over its 6 cells " + json.dumps(total))
    log("campaign walls s " + json.dumps(
        {k: round(v, 2) for k, v in walls.items()}))
    with open(os.path.join(OUT_DIR, "chaos_torch.json"), "w") as f:
        json.dump({"card": chaos, "cpu": cpu}, f, indent=1)
    return {"walls": walls, "launches_a": total,
            "launches": {k: v["launches"] for k, v in runs.items()},
            "peaks": {k: v["peaks"] for k, v in runs.items()},
            "pairs": {k: v["report"]["pairs"] for k, v in runs.items()},
            "fault_summary": fault["fault_summary"],
            "fault_launches": fault_launches,
            "chaos": {"train": chaos["runs"], "serve": chaos["serve"]["runs"]},
            "chaos_launches": chaos_launches}


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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.gather_agg import ops as gather_ops
    from repro_torch.kernels.seg_sort import ops as sort_ops

    # float32 products in full float32 on the card (the plain versions and
    # the decode-vs-prefill check compare float32 sums)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        fn = ""
        for line in text.splitlines():
            entry = re.search(r"entry function '(\S+)'", line)
            if entry:
                name = re.search(r"([a-z][a-z_]*_kernel)I((?:L\w\d+E)+)E",
                                 entry.group(1))
                args = re.findall(r"L\w(\d+)E", name.group(2)) if name \
                    else ()
                fn = f"{name.group(1)}<{','.join(args)}> " if name else ""
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {fam}: {fn}{line.strip()}")

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
    train_rows, forward = train_kernel_phase(
        torch, device, train_cfg, sort_input, captured, m_max,
        train["launches"])
    kernels += train_rows
    # the forward's row is timed at the serving shapes; training's two
    # layers, which carry most of its launches, ride along in the record
    next(k for k in kernels if k["name"] == "gather_agg")[
        "training_layers"] = forward
    del captured, sort_input
    lm, lm_rows = lm_phase(torch, device, [fa_ops.LAUNCHES, fd_ops.LAUNCHES])
    kernels += lm_rows
    dist_counters = train_counters + [search_ops.MERGE_LAUNCHES]
    dist, dist_in = dist_phase(torch, device, g, pg, dist_counters)
    emb, emb_in = embedding_phase(torch, device, dist_counters)
    kernels.append(merge_kernel_row(
        torch, device, dist_in, emb_in,
        dist["launches"]["rapid staged"]["merge_gather"]
        + emb["launches"]["merge_gather"]))
    del dist_in, emb_in
    runner = runner_phase(torch, device, g, pg, dist_counters)
    campaign = campaign_phase(torch, device, dist_counters, runner)
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
                   "launches": launches, "train": train, "lm": lm,
                   "dist": dist, "embedding": emb, "runner": runner,
                   "campaign": campaign}, f,
                  indent=1)
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
