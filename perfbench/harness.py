"""One run of one cell: set-up, the measured window, the traced slice,
the comparison with the reference, and the result.

Set-up (``setup_s``, from the process's start): the configuration's
graph made by ``graphgen`` from its ``graph_seed``; the program's
partition (``repro_torch.graph.partition_graph``), its schedules
(``build_schedule``, the traffic's compiler, ahead or lazy), its
``DeviceView``, mesh and ``DeviceRapidGNNRunner`` (fused assembly, flat
topology); the weights drawn from ``--seed`` by the program's
``init_params``; then the warm-up at the cell's shapes, the job's first
``WARM_EPOCHS`` epochs through the runner's own ``run``: ``[0, 1)``,
then ``[1, WARM_EPOCHS)`` from the state the first call left, staging
each next epoch while one trains, as the window's passes do. The
program's state after them is what the reference judges.

The window: whole passes of ``runner.run(params, opt_state, start,
E)``, the first finishing the job that set-up began, then the job again
from epoch 0, weights and optimizer state carried across; it ends at
the first pass's end past ``--seconds``. The rates divide by the
window's measured wall.

With ``--trace 1`` two passes run after the window under
``torch.profiler``: a whole pass of the job with the card's activity
alone traced (the kernel times, the busy time, the device operations;
the idle share sets the busy time against the window's untraced whole
passes, since tracing slows the host), then ``GAP_EPOCHS`` epochs with
the host's operators traced too (what the host did in each idle gap). The
per-layer metrics are read from the window's epoch reports, the traced
passes and the schedules' counts.

Then the program's card state is freed and the reference judges what
the program produced (``reference/``).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import graphgen, hostinfo, manifest, summary, trace
from perfbench.reference import check, model, partition, sampler
from perfbench.rng import rng_from


#: epochs set-up trains, and the reference follows
WARM_EPOCHS = 3
#: epochs of the pass traced with the host's operators
GAP_EPOCHS = 3


def _host(tree) -> Dict[str, torch.Tensor]:
    """The program's parameter tree -> ``layers.<l>.<name>`` CPU copies."""
    return {f"layers.{l}.{k}": v.detach().to("cpu", copy=True)
            for l, layer in enumerate(tree["layers"])
            for k, v in layer.items()}


class Context:
    """What a per-layer reader reads: the window's epoch reports and
    wall, the seeds trained, the median wall of the window's whole
    passes (``window_pass_s``, or None), the traced pass (``trace``: a
    ``trace.TraceData`` or None), the epochs it ran, and each epoch's
    schedule counts (``summary(e)``)."""

    def __init__(self, cell, peaks, reports, window_s, seeds,
                 summary_of: Callable[[int], Dict[str, Any]],
                 traced: Optional[trace.TraceData] = None,
                 traced_epochs: Optional[List[int]] = None,
                 window_pass_s: Optional[float] = None):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.peaks = peaks
        self.reports = reports
        self.window_s = window_s
        self.seeds = seeds
        self.summary = summary_of
        self.trace = traced
        self.traced_epochs = traced_epochs or []
        self.window_pass_s = window_pass_s

    def layer_dims(self) -> List[int]:
        return model.layer_dims(self.config)


class CellRun:
    """Builds the program for one cell and drives it."""

    def __init__(self, cell: manifest.Cell, seed: int, device: torch.device):
        self.cell, self.seed, self.device = cell, seed, device
        self.info: Dict[str, Any] = {}
        self._summaries: Dict[int, Dict[str, Any]] = {}

    # -- set-up ---------------------------------------------------------

    def setup(self, prebuilt=None) -> None:
        """``prebuilt``: a (graph, partition) pair of an earlier run of
        the same configuration, reused (the calibration's seeds share
        them; a benchmark run builds its own)."""
        from repro_torch.core import build_schedule
        from repro_torch.dist import (DeviceRapidGNNRunner, DeviceView,
                                      Topology, make_mesh)
        from repro_torch.graph import Graph, KHopSampler, partition_graph
        from repro_torch.models.gnn import GNNConfig, init_params
        from repro_torch.train import AdamW

        c, tr, dev = self.cell.config, self.cell.traffic, self.device
        self.P = int(c["num_workers"])
        if prebuilt is None:
            t = time.perf_counter()
            g = graphgen.make_graph(c, int(c["graph_seed"]))
            self.info["graph_s"] = time.perf_counter() - t
            t = time.perf_counter()
            G = Graph(indptr=g.indptr, indices=g.indices,
                      features=g.features, labels=g.labels,
                      num_classes=g.num_classes, train_mask=g.train_mask)
            self.pg = partition_graph(G, self.P, c["partition"],
                                      seed=int(c["partition_seed"]))
            self.info["partition_s"] = time.perf_counter() - t
        else:
            g, self.pg = prebuilt
            G = self.pg.graph
        self.graph = g
        t = time.perf_counter()
        self.E = int(c["epochs"])
        self.B = int(tr["batch_size"])
        self.lazy = tr["schedule"] == "lazy"
        smp = KHopSampler(G, fanouts=list(c["fanouts"]), batch_size=self.B)
        self.schedules = [
            build_schedule(smp, self.pg, worker=w, s0=self.seed,
                           num_epochs=self.E, n_hot=int(c["n_hot"]),
                           compiler=tr["compiler"], lazy=self.lazy,
                           device=dev)
            for w in range(self.P)]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.info["schedule_s"] = time.perf_counter() - t
        t = time.perf_counter()
        gcfg = GNNConfig(kind=c["model"], in_dim=int(c["feat_dim"]),
                         hidden_dim=int(c["hidden_dim"]),
                         num_classes=int(c["num_classes"]),
                         num_layers=int(c["num_layers"]),
                         fanouts=tuple(c["fanouts"]), agg_backend="kernel")
        o = c["optimizer"]
        opt = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                    weight_decay=o["weight_decay"])
        self.runner = DeviceRapidGNNRunner(
            self.schedules, DeviceView.build(self.pg), gcfg, opt,
            make_mesh((self.P,), ("data",), device=dev), self.B, g.labels,
            seed=self.seed, assemble_backend="fused",
            topology=Topology.flat(self.P))
        self.info["runner_s"] = time.perf_counter() - t
        t = time.perf_counter()
        params = init_params(gcfg, torch.Generator().manual_seed(self.seed),
                             dev)
        self.p0 = _host(params)
        r = self.runner
        self.warm_epochs = min(WARM_EPOCHS, self.E)
        self.warm = r.run(params, opt.init(params), 0, 1)
        if self.warm_epochs > 1:
            self.warm += r.run(r.params, r.opt_state, 1, self.warm_epochs)
        # what the reference follows: every step's loss, and the
        # parameters and first moments after the last
        self.warm_losses = [float(x) for rep in self.warm
                            for x in rep.losses]
        self.warm_p = _host(r.params)
        self.warm_mu = _host(r.opt_state.mu)
        self.next_epoch = self.warm_epochs % self.E
        self.info["warmup_s"] = time.perf_counter() - t
        self.seeds_per_epoch = int(g.train_mask.sum())
        # what set-up built stays: keep the collector off it in the window
        gc.collect()
        gc.freeze()

    # -- the window ----------------------------------------------------

    def window(self, seconds: float) -> None:
        r = self.runner
        reports, passes, e = [], [], self.next_epoch
        h0 = hostinfo.snapshot()
        t0 = time.perf_counter()
        while True:
            tp = time.perf_counter()
            reports += r.run(r.params, r.opt_state, e, self.E)
            passes.append([self.E - e, time.perf_counter() - tp])
            e = 0
            if time.perf_counter() - t0 >= seconds:
                break
        self.window_s = time.perf_counter() - t0
        self.info["host"] = hostinfo.delta(h0, hostinfo.snapshot())
        self.reports = reports
        self.info["passes"] = passes
        self.info["epochs"] = len(reports)
        self.info["epoch_wall_q"] = _quartiles([x.wall_time_s
                                                for x in reports])

    def traced_pass(self) -> None:
        """A whole pass of the job with the card's activity traced, then
        ``GAP_EPOCHS`` epochs with the host's operators traced too."""
        from torch.profiler import ProfilerActivity, profile, record_function

        r, cuda = self.runner, self.device.type == "cuda"

        def sync():
            if cuda:
                torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            self.traced_reports = r.run(r.params, r.opt_state, 0, self.E)
            sync()
            wall = time.perf_counter() - t0
        self.trace = trace.collect_device(prof, wall)
        self.traced_epochs = list(range(self.E))
        full = [w for n, w in self.info["passes"] if n == self.E]
        self.info["traced_pass_s"] = wall
        self.info["window_pass_s"] = (float(np.median(full)) if full
                                      else None)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(trace.SLICE):
                self.traced_reports += r.run(r.params, r.opt_state, 0,
                                             min(GAP_EPOCHS, self.E))
                sync()
        host_trace, start, end = trace.collect(prof)
        self.idle_gaps = host_trace.idle_gaps(start, end)
        self.info["trace_s"] = time.perf_counter() - t

    # -- the program's schedule, for counts and the judgement ------------

    def program_epoch(self, e: int):
        return [ws.epoch(e) for ws in self.schedules]

    def summary(self, e: int) -> Dict[str, Any]:
        if e not in self._summaries:
            es = self.program_epoch(e)
            self._summaries[e] = summary.epoch_summary(
                [x.flat for x in es], [x.cache_ids for x in es])
        return self._summaries[e]

    def free(self) -> None:
        """Drop the program's card state (its schedules stay on the host
        for the judgement)."""
        self.runner = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the judgement -------------------------------------------------

    def judge(self, ref_owner: Optional[np.ndarray] = None
              ) -> Dict[str, float]:
        """``ref_owner``: the reference's partition of an earlier run of
        the same configuration, reused by the calibration."""
        c, g, P = self.cell.config, self.graph, self.P
        t = time.perf_counter()
        self.ref_owner = (ref_owner if ref_owner is not None
                          else partition.greedy_owner(
                              g.indptr, g.indices, P,
                              int(c["partition_seed"])))
        nums = {"partition_mismatch": float(check.array_mismatch(
            np.asarray(self.pg.owner), self.ref_owner))}
        self.info["ref_partition_s"] = time.perf_counter() - t

        # the schedule and hot sets of the epochs set-up trained and of
        # epochs drawn from the rest
        t = time.perf_counter()
        rng = rng_from(self.seed, 7)
        W = self.warm_epochs
        k = min(int(self.cell.traffic["check_epochs"]), self.E - W)
        epochs = list(range(W)) + sorted(int(x) for x in rng.choice(
            np.arange(W, self.E), size=k, replace=False))
        self.info["check_epochs"] = epochs
        ref_epochs = {}
        mism = hot = 0
        for e in epochs:
            ref_epochs[e] = [sampler.sample_epoch(
                g.indptr, g.indices, self.ref_owner, g.train_mask,
                c["fanouts"], self.B, int(c["n_hot"]), self.seed, w, e)
                for w in range(P)]
            for w, (es, ref) in enumerate(zip(self.program_epoch(e),
                                              ref_epochs[e])):
                mism += _schedule_mismatch(es.flat, ref.batches)
                hot += check.array_mismatch(es.cache_ids, ref.cache_ids)
        nums["schedule_mismatch"] = float(mism)
        nums["hot_set_mismatch"] = float(hot)
        self.info["ref_schedule_s"] = time.perf_counter() - t

        # the rows of the exchange in the sampled epochs: each worker's
        # residual-miss rows (remote, not in its hot set) against the
        # epoch reports', and the padded rows the exchange moved, which
        # cannot fall short of them
        t = time.perf_counter()
        lanes = {e: np.array([sum(int(sampler.miss_counts(
            b.input_nodes, self.ref_owner, w, ref.cache_ids, P).sum())
            for b in ref.batches) for w, ref in enumerate(ref_epochs[e])],
            np.int64) for e in epochs}
        reps = [r for r in (self.warm + self.reports
                            + getattr(self, "traced_reports", []))
                if r.epoch in lanes]
        nums["miss_rows_gap"] = float(sum(
            int(np.abs(np.asarray(r.miss_lanes) - lanes[r.epoch]).sum())
            for r in reps))
        nums["wire_rows_short"] = float(sum(
            max(0, int(lanes[r.epoch].sum()) - int(r.wire_rows))
            for r in reps))
        self.info["ref_rows_s"] = time.perf_counter() - t

        # training: set-up's epochs, followed by the reference
        t = time.perf_counter()
        self.ref_epochs = ref_epochs
        ref = self.ref_train = self.reference_training()
        nums.update(check.training_numbers(
            self.warm_losses, self.p0, self.warm_p, self.warm_mu,
            self.ref_p0, ref))
        self.info["ref_train_s"] = time.perf_counter() - t
        return nums

    def reference_training(self, tf32: bool = False,
                           half_batch: bool = False,
                           no_exchange: bool = False) -> Dict[str, Any]:
        """The reference over the epochs set-up trained, from the
        reference's own schedule (``judge`` samples it)."""
        c, g = self.cell.config, self.graph
        self.ref_p0 = model.init_params(model.layer_dims(c), self.seed)
        X = torch.from_numpy(g.features).to(self.device)
        y = torch.from_numpy(g.labels).to(self.device)
        trained = [self.ref_epochs[e] for e in range(self.warm_epochs)]
        keep = None
        if no_exchange:     # a fault: rows pulled from other workers lost
            keep = [[[((self.ref_owner[b.input_nodes] == w)
                       | np.isin(b.input_nodes, ref.cache_ids))
                      for b in ref.batches]
                     for w, ref in enumerate(ep)] for ep in trained]
        out = model.train_steps(self.ref_p0, int(c["num_layers"]), X, y,
                                [[ref.batches for ref in ep]
                                 for ep in trained],
                                c["optimizer"], tf32=tf32,
                                half_batch=half_batch, keep=keep)
        del X, y
        return out


def _quartiles(xs: List[float]) -> List[float]:
    return ([float(q) for q in np.percentile(xs, [0, 25, 50, 75, 100])]
            if xs else [])


def _schedule_mismatch(flat, batches) -> int:
    """Elements of a program epoch's packed schedule that differ from
    the reference's batches."""
    if flat.num_batches != len(batches):
        return abs(flat.num_batches - len(batches)) + 1
    if not batches:
        return 0
    L = len(batches[0].num_dst)
    n = check.array_mismatch(flat.seeds,
                             np.concatenate([b.seeds for b in batches]))
    n += check.array_mismatch(flat.input_nodes, np.concatenate(
        [b.input_nodes for b in batches]))
    n += check.array_mismatch(np.asarray(flat.num_dst).reshape(L, -1),
                              np.array([b.num_dst for b in batches]).T)
    for l in range(L):
        for mine, theirs in ((flat.edge_src[l], "edge_src"),
                             (flat.edge_dst[l], "edge_dst"),
                             (flat.edge_mask[l], "edge_mask")):
            n += check.array_mismatch(mine, np.concatenate(
                [getattr(b, theirs)[l] for b in batches]))
    return n


def load_reader(root: Path, name: str):
    """``perfbench/readers/<name>.py`` of the checkout at ``root``."""
    path = Path(root) / "perfbench" / "readers" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_readers_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_metrics(cell: manifest.Cell, ctx: Context, trace_on: bool,
                 window_s: float, seeds: int) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    if not trace_on:
        values = {"train_seeds_per_s": seeds / window_s}
        for m in cell.end_to_end:
            if m["name"] in values:
                out[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        return out
    for m in cell.per_layer:
        v = load_reader(cell.root, m["spec"]["reader"]).read(ctx, m["spec"])
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace_on: bool,
             device: torch.device, t_start: float,
             root: Path = manifest.ROOT) -> Dict[str, Any]:
    """-> the result object; its ``checks`` come last, each number
    beside its limit, and ``correct`` holds when every number is finite
    and within its limit and no step's loss is non-finite."""
    cell = manifest.load_cell(name, root)
    run = CellRun(cell, seed, device)
    run.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    run.window(seconds)
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if trace_on:
        run.traced_pass()
    run.free()
    t = time.perf_counter()
    nums = run.judge()
    run.info["judge_s"] = time.perf_counter() - t

    seeds = run.seeds_per_epoch * len(run.reports)
    peaks = manifest._read(Path(root) / "perfbench" / "peaks.json")
    ctx = Context(cell, peaks, run.reports, run.window_s, seeds,
                  run.summary,
                  getattr(run, "trace", None),
                  getattr(run, "traced_epochs", None),
                  run.info.get("window_pass_s"))
    metrics = read_metrics(cell, ctx, trace_on, run.window_s, seeds)
    if not trace_on:
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    steps = sum(int(r.steps) for r in run.reports)
    failed = sum(int((~np.isfinite(np.asarray(r.losses))).sum())
                 for r in run.reports)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": None, "attempted": steps,
                              "failed": failed, "metrics": metrics,
                              "device": dev}
    if trace_on:
        tr = run.trace
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": run.idle_gaps}
    run.info.update(setup_s=setup_s, window_s=run.window_s,
                    seeds=seeds, steps=steps)
    result["info"] = run.info
    checks = {}
    for k, v in nums.items():
        checks[k] = {"value": v, "limit": float(cell.limits[k])}
    result["correct"] = bool(failed == 0 and all(
        np.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    result["checks"] = checks
    return result
