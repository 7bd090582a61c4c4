"""Cell execution: one `CellSpec` -> one unified `CellResult` (the port
of ``repro/eval/cells.py``).

Host cells run the metered host-sim runners (``repro_torch.core.
runtime``) in-process, one per worker, and aggregate their
``RunMetrics``; each step trains on the torch ``device``. Device cells
run the multi-epoch device runners (``repro_torch.dist.runner``) IN
PROCESS: the cell's P workers share one device through the port's mesh
(``Topology.make_mesh(device)``). The reference runs its device cells
in a subprocess only because JAX fixes its emulated device count when
it first starts; the port's mesh has no such lock, so it needs neither
that child process nor its time limit.

Every ``GNNConfig`` built here aggregates through the ``gather_agg``
kernel (``agg_backend="kernel"`` with the cell's effective fan-outs):
it is deterministic forward and backward, where the ``"segment"``
oracle (``index_add_``) sums with atomics on CUDA, and the bit-equality
checks of the differential layer need the same curve on every run.

Both backends land in the same ``CellResult`` schema as the reference's
(a port cell's ``to_dict`` loads into the reference's ``from_dict`` and
back), so the campaign's differential checks (repro_torch.eval.
differential) and ratio derivations (repro_torch.eval.report) never
branch on backend.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.eval.spec import CellSpec
from repro_torch.models.gnn import GNNConfig, init_params


@dataclasses.dataclass
class CellResult:
    """Backend-agnostic record of one campaign cell.

    ``warm_*`` fields exclude epoch 0 (JIT/bootstrap warm-up) whenever
    the cell ran more than one epoch; time-derived ratios use them,
    byte/RPC counters always cover every epoch. ``miss_matrix[e][i]`` is
    worker ``workers_run[i]``'s epoch-``e`` residual-miss count -- the
    quantity the host-vs-device differential pins (host-sim
    ``cache_misses`` vs device pull-lane counts)."""
    spec: Dict[str, Any]
    feat_dim: int
    itemsize: int
    workers_run: List[int]
    num_steps: int
    warm_steps: int
    wall_time_s: float
    warm_wall_s: float
    step_time_ms: float
    rpc_count: int
    remote_requests: int
    cache_hits: int
    cache_misses: int
    hit_rate: float
    remote_bytes: int
    vector_pull_bytes: int
    payload_bytes: int
    sync_net_time_s: float
    warm_sync_net_time_s: float
    modeled_net_time_s: float
    miss_matrix: List[List[int]]
    losses: List[float]
    accs: List[float]
    energy: Dict[str, float]
    #: per-epoch detail records -- host: worker-0's ``EpochMetrics``
    #: dicts (``RunMetrics.to_dict``), device: ``DeviceEpochReport``
    #: dicts -- the drill-down layer of the campaign's artifact
    epoch_metrics: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)
    wire_rows: int = 0
    trace_count: int = 0
    device_cache_bytes: int = 0
    #: request-leg wire bytes (the id/pos lane tensors shipped through
    #: the all_to_all BEFORE the payload comes back); device backend
    #: only, == wire_rows * index-lane itemsize by construction
    request_bytes: int = 0
    #: two-tier topology split (device backend; on a flat mesh the whole
    #: exchange is the intra tier and every ``inter_*`` field is 0).
    #: Identities pinned by repro_torch.eval.differential:
    #:   intra_misses + inter_misses == cache_misses
    #:   intra_bytes  + inter_bytes  == remote_bytes (payload leg)
    intra_misses: int = 0
    inter_misses: int = 0
    intra_bytes: int = 0
    inter_bytes: int = 0
    intra_wire_rows: int = 0
    inter_wire_rows: int = 0
    stage_time_s: float = 0.0
    #: staging wall left exposed after training (device backend with
    #: background staging)
    exposed_stage_s: float = 0.0
    #: fault-plane accounting (DESIGN.md §10); all zero on clean cells.
    #: ``fault_events`` counts injections that actually fired, the rest
    #: count the recoveries they forced: degraded epochs (stale C_sec /
    #: lost staged cache), bounded retries per site, spill heals,
    #: stage-deadline overruns, and the wall spent recovering.
    degraded_epochs: int = 0
    stage_retries: int = 0
    pull_retries: int = 0
    prefetch_retries: int = 0
    csec_degraded: int = 0
    spill_rebuilds: int = 0
    deadline_overruns: int = 0
    recovery_wall_s: float = 0.0
    fault_events: int = 0

    @property
    def backend(self) -> str:
        return self.spec["backend"]

    @property
    def system(self) -> str:
        return self.spec["system"]

    @property
    def row_bytes(self) -> int:
        return self.feat_dim * self.itemsize

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CellResult":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


def _energy(spec: CellSpec, warm_wall_s: float) -> Dict[str, float]:
    from repro_torch.core import modelled_energy
    return modelled_energy(warm_wall_s,
                           "rapidgnn" if spec.is_rapid else "baseline")


def cell_config(spec: CellSpec, g) -> GNNConfig:
    """The cell's model: GraphSAGE (GCN for the ``gcn`` system) over the
    effective fan-outs, aggregating through the ``gather_agg`` kernel."""
    fanouts = spec.effective_fanouts
    return GNNConfig(kind="gcn" if spec.system == "gcn" else "sage",
                     in_dim=g.feat_dim, hidden_dim=spec.hidden,
                     num_classes=g.num_classes, num_layers=len(fanouts),
                     fanouts=tuple(fanouts), agg_backend="kernel")


def initial_params(cfg: GNNConfig, seed: int, device: torch.device):
    """Every cell's initial parameters (the device runner's own default
    for ``seed``)."""
    return init_params(cfg, torch.Generator().manual_seed(seed), device)


# ---------------------------------------------------------------------------
# host backend
# ---------------------------------------------------------------------------

def run_host_cell(spec: CellSpec, worker: int = 0, net=None,
                  device=None) -> CellResult:
    """Run one host-sim cell. ``spec.all_workers`` runs every worker's
    schedule (each against its own feature-store view, as the paper's
    cluster would); otherwise only ``worker`` runs. ``net`` overrides
    the spec-derived ``NetworkModel``. Steps train on ``device``
    (``None`` means ``cuda``; raises without a card)."""
    from repro_torch.graph import load_dataset, partition_graph, KHopSampler
    from repro_torch.core import (build_schedule, ShardedFeatureStore,
                                  RapidGNNRunner, BaselineRunner,
                                  NetworkModel)
    from repro_torch.models import batch_to_device, make_train_step
    from repro_torch.train import AdamW
    from repro_torch.fault import active_plan, plan_from_profile

    if spec.backend != "host":
        raise ValueError(f"run_host_cell got backend {spec.backend!r}")
    device = resolve_device(device)
    plan = (plan_from_profile(spec.fault_profile, seed=spec.fault_seed)
            if spec.fault_profile != "none" else None)
    g = load_dataset(spec.dataset)
    pg = partition_graph(g, spec.workers, spec.partition_method)
    fanouts = spec.effective_fanouts
    sampler = KHopSampler(g, fanouts=list(fanouts),
                          batch_size=spec.batch_size)
    workers = list(range(spec.workers)) if spec.all_workers else [worker]

    cfg = cell_config(spec, g)
    opt = AdamW(lr=3e-3)
    step = make_train_step(cfg, opt) if spec.train else None

    runs = []           # (RunMetrics, losses, accs, cache_bytes, steps/ep)
    for w in workers:
        ws = build_schedule(sampler, pg, worker=w, s0=spec.seed,
                            num_epochs=spec.epochs,
                            n_hot=spec.n_hot if spec.is_rapid else 0,
                            compiler=spec.effective_compiler,
                            device=device)
        state = {"losses": [], "accs": []}
        if spec.train:
            params = initial_params(cfg, spec.seed, device)
            box = {"p": params, "o": opt.init(params)}

            def train_fn(feats, cb, _box=box, _state=state):
                batch = batch_to_device(cb, feats, device)
                _box["p"], _box["o"], aux = step(_box["p"], _box["o"],
                                                 batch)
                _state["losses"].append(float(aux["loss"]))
                _state["accs"].append(float(aux["acc"]))
                return _state["losses"][-1]
        else:
            def train_fn(feats, cb):
                return 0.0

        store = ShardedFeatureStore(
            pg, worker=w,
            net=net if net is not None
            else NetworkModel(enabled=spec.net_enabled))
        if spec.is_rapid:
            runner = RapidGNNRunner(ws, store,
                                    batch_size=spec.batch_size,
                                    Q=spec.Q, train_fn=train_fn)
        else:
            runner = BaselineRunner(ws, store,
                                    batch_size=spec.batch_size,
                                    train_fn=train_fn)
        with active_plan(plan):     # None-tolerant: no-op when clean
            m = runner.run()
        runs.append((m, state["losses"], state["accs"],
                     getattr(runner, "device_cache_bytes", 0),
                     [ws.epoch(e).num_batches
                      for e in range(spec.epochs)],
                     int(ws.spill_rebuilds)))

    return _host_cell_result(spec, g, workers, runs,
                             fault_events=plan.total_fires() if plan
                             else 0)


def _host_cell_result(spec: CellSpec, g, workers, runs,
                      fault_events: int = 0) -> CellResult:
    E = spec.epochs
    tot: Dict[str, float] = {k: 0 for k in (
        "rpc_count", "remote_requests", "cache_hits", "cache_misses",
        "remote_bytes", "vector_pull_bytes", "sync_net_time_s",
        "warm_sync_net_time_s", "modeled_net_time_s", "pull_retries",
        "prefetch_retries", "csec_degraded")}
    miss = np.zeros((E, len(workers)), np.int64)
    wall = warm_wall = 0.0
    num_steps = warm_steps = 0
    spill_rebuilds = sum(r[5] for r in runs if len(r) > 5)
    for i, (m, *_rest) in enumerate(runs):
        steps_per_epoch = _rest[3]
        t = m.totals()
        for k in ("rpc_count", "remote_requests", "cache_hits",
                  "cache_misses", "remote_bytes", "vector_pull_bytes",
                  "sync_net_time_s", "modeled_net_time_s",
                  "pull_retries", "prefetch_retries", "csec_degraded"):
            tot[k] += t[k]
        warm_eps = m.epochs[1:] if E > 1 else m.epochs
        tot["warm_sync_net_time_s"] += sum(e.sync_net_time_s
                                           for e in warm_eps)
        miss[:, i] = [e.cache_misses for e in m.epochs]
        # workers run concurrently on a real cluster: the cell's wall
        # time is the slowest worker, counters are the cluster total
        wall = max(wall, sum(e.wall_time_s for e in m.epochs))
        warm_wall = max(warm_wall, sum(e.wall_time_s for e in warm_eps))
        num_steps = max(num_steps, sum(steps_per_epoch))
        warm_steps = max(warm_steps, sum(
            steps_per_epoch[1:] if E > 1 else steps_per_epoch))
    hits, misses = int(tot["cache_hits"]), int(tot["cache_misses"])
    losses, accs = runs[0][1], runs[0][2]
    return CellResult(
        spec=spec.to_dict(), feat_dim=g.feat_dim,
        itemsize=int(g.features.itemsize), workers_run=list(workers),
        num_steps=num_steps, warm_steps=warm_steps,
        wall_time_s=wall, warm_wall_s=warm_wall,
        step_time_ms=1e3 * warm_wall / max(warm_steps, 1),
        rpc_count=int(tot["rpc_count"]),
        remote_requests=int(tot["remote_requests"]),
        cache_hits=hits, cache_misses=misses,
        hit_rate=hits / max(hits + misses, 1),
        remote_bytes=int(tot["remote_bytes"]),
        vector_pull_bytes=int(tot["vector_pull_bytes"]),
        payload_bytes=int(tot["remote_bytes"]),
        sync_net_time_s=float(tot["sync_net_time_s"]),
        warm_sync_net_time_s=float(tot["warm_sync_net_time_s"]),
        modeled_net_time_s=float(tot["modeled_net_time_s"]),
        miss_matrix=miss.tolist(), losses=list(losses), accs=list(accs),
        energy=_energy(spec, warm_wall),
        epoch_metrics=runs[0][0].to_dict()["epochs"],
        device_cache_bytes=int(max(r[3] for r in runs)),
        # a degraded host epoch == one that kept a stale steady cache
        degraded_epochs=int(tot["csec_degraded"]),
        pull_retries=int(tot["pull_retries"]),
        prefetch_retries=int(tot["prefetch_retries"]),
        csec_degraded=int(tot["csec_degraded"]),
        spill_rebuilds=int(spill_rebuilds),
        fault_events=int(fault_events))


# ---------------------------------------------------------------------------
# device backend: P workers on one device, in process
# ---------------------------------------------------------------------------

def run_device_cells(specs: Sequence[CellSpec], device=None,
                     scenarios: Optional[Dict[tuple, dict]] = None
                     ) -> List[CellResult]:
    """Run device cells in this process on ``device`` (``None`` means
    ``cuda``; raises without a card). Cells of one scenario share their
    schedules (``scenario_key``); pass a dict as ``scenarios`` to share
    them across calls too (a caller running one cell at a time)."""
    device = resolve_device(device)
    for s in specs:
        if s.backend != "device":
            raise ValueError(f"run_device_cells got backend {s.backend!r}")
    if scenarios is None:
        scenarios = {}
    results = []
    for spec in specs:
        key = spec.scenario_key()
        if key not in scenarios:
            scenarios[key] = _build_device_scenario(spec, device)
        results.append(_run_device_cell(spec, scenarios[key], device))
    return results


def _build_device_scenario(spec: CellSpec, device) -> dict:
    from repro_torch.graph import load_dataset, partition_graph, KHopSampler
    from repro_torch.core import build_schedule
    from repro_torch.dist import DeviceView

    g = load_dataset(spec.dataset)
    pg = partition_graph(g, spec.workers, spec.partition_method)
    sampler = KHopSampler(g, fanouts=list(spec.fanouts),
                          batch_size=spec.batch_size)
    # the device schedule backend also goes LAZY (device-resident): the
    # runner's staging thread rebuilds each epoch overlapped with train
    schedules = [build_schedule(sampler, pg, worker=w, s0=spec.seed,
                                num_epochs=spec.epochs, n_hot=spec.n_hot,
                                compiler=spec.effective_compiler,
                                lazy=spec.schedule_backend == "device",
                                device=device)
                 for w in range(spec.workers)]
    # NOTE: no mesh here -- the scenario cache is keyed by
    # ``scenario_key()``, which deliberately excludes ``topology`` (flat
    # and hierarchical cells share schedules by the parity contract), so
    # the mesh is a per-CELL artifact built in ``_run_device_cell``.
    return {"g": g, "pg": pg, "schedules": schedules,
            "dv": DeviceView.build(pg)}


def _run_device_cell(spec: CellSpec, sc: dict, device) -> CellResult:
    from repro_torch.train import AdamW
    from repro_torch.dist import DeviceRapidGNNRunner, DeviceBaselineRunner
    from repro_torch.fault import active_plan, plan_from_profile

    g, schedules = sc["g"], sc["schedules"]
    cfg = cell_config(spec, g)
    topo = spec.topology_obj()
    cls = DeviceRapidGNNRunner if spec.is_rapid else DeviceBaselineRunner
    runner = cls(schedules, sc["dv"], cfg, AdamW(lr=3e-3),
                 topo.make_mesh(device), spec.batch_size, g.labels,
                 seed=spec.seed, stage_deadline_s=spec.stage_deadline_s,
                 topology=topo)
    plan = (plan_from_profile(spec.fault_profile, seed=spec.fault_seed)
            if spec.fault_profile != "none" else None)
    params = initial_params(cfg, spec.seed, device)
    with active_plan(plan):
        reports = runner.run(params=params)
    return device_cell_result(spec, g, schedules, runner, reports,
                              fault_events=plan.total_fires() if plan
                              else 0)


def device_cell_result(spec: CellSpec, g, schedules, runner,
                       reports, fault_events: int = 0) -> CellResult:
    """Fold DeviceEpochReports into the unified cell schema.

    ``rpc_count``/``cache_misses``/``remote_bytes`` are the pull-lane
    accounting (residual misses, == host-sim by the parity contract);
    ``vector_pull_bytes`` mirrors the host bootstrap + C_sec builds:
    every epoch's cache rows are staged exactly once."""
    row = g.feat_dim * g.features.itemsize
    E = len(reports)
    rep_dicts = [r.to_dict() for r in reports]
    lanes_total = sum(r.total_miss_lanes for r in reports)
    warm = reports[1:] if E > 1 else reports
    wall = sum(r.wall_time_s for r in reports)
    warm_wall = sum(r.wall_time_s for r in warm)
    num_steps = sum(r.steps for r in reports)
    warm_steps = sum(r.steps for r in warm)
    vec_bytes = 0
    if spec.is_rapid:
        vec_bytes = sum(int(ws.epoch(r.epoch).cache_ids.shape[0]) * row
                        for ws in schedules for r in reports)
    payload = lanes_total * row
    intra_misses = sum(sum(d["intra_lanes"]) for d in rep_dicts)
    inter_misses = sum(sum(d["inter_lanes"]) for d in rep_dicts)
    return CellResult(
        spec=spec.to_dict(), feat_dim=g.feat_dim,
        itemsize=int(g.features.itemsize),
        workers_run=list(range(spec.workers)),
        num_steps=int(num_steps), warm_steps=int(warm_steps),
        wall_time_s=float(wall), warm_wall_s=float(warm_wall),
        step_time_ms=1e3 * warm_wall / max(warm_steps, 1),
        rpc_count=int(lanes_total), remote_requests=int(lanes_total),
        cache_hits=0, cache_misses=int(lanes_total), hit_rate=0.0,
        remote_bytes=int(payload), vector_pull_bytes=int(vec_bytes),
        payload_bytes=int(payload),
        sync_net_time_s=0.0, warm_sync_net_time_s=0.0,
        modeled_net_time_s=0.0,
        miss_matrix=[r["miss_lanes"] for r in rep_dicts],
        losses=[x for r in rep_dicts for x in r["losses"]],
        accs=[x for r in rep_dicts for x in r["accs"]],
        energy=_energy(spec, warm_wall),
        epoch_metrics=rep_dicts,
        wire_rows=sum(int(r.wire_rows) for r in reports),
        request_bytes=sum(r.request_bytes() for r in reports),
        intra_misses=int(intra_misses), inter_misses=int(inter_misses),
        intra_bytes=int(intra_misses * row),
        inter_bytes=int(inter_misses * row),
        intra_wire_rows=sum(int(r.intra_wire_rows) for r in reports),
        inter_wire_rows=sum(int(r.inter_wire_rows) for r in reports),
        trace_count=int(runner.trace_count),
        stage_time_s=float(runner.stage_time_s),
        exposed_stage_s=float(runner.exposed_stage_s),
        degraded_epochs=sum(int(r.degraded) for r in reports),
        stage_retries=int(getattr(runner, "stage_retries", 0)),
        spill_rebuilds=sum(int(ws.spill_rebuilds) for ws in schedules),
        deadline_overruns=int(getattr(runner, "deadline_overruns", 0)),
        recovery_wall_s=float(getattr(runner, "recovery_wall_s", 0.0)),
        fault_events=int(fault_events))
