"""Multi-epoch device runners: Alg. 1's epoch loop over the port's mesh,
the port of ``repro/dist/runner.py``.

``DeviceRapidGNNRunner`` drives N epochs through ``make_pipelined_epoch``
with the paper's double-buffer protocol: while epoch e trains on the
card against C_s, a background staging thread builds epoch e+1 -- the
next epoch's schedule itself when the ``WorkerSchedule`` is lazy (the
train-overlapped next-epoch build), then its C_sec (``remap_cache`` +
``stack_caches``) and pull plans. The collation runs on the runner's
device (``device_collate.collate_epoch_on_device``, bit-equal to the
numpy ``collate_device_epoch``): the staging thread uploads the
workers' flat schedules and the stacked C_sec once, unpadded, and
builds the padded (S, P, ...) tensors there, on a CUDA stream of its
own. At the epoch boundary (Alg. 1 l.18) the main thread swaps them in
with no copy: its stream waits on the event the staging stream recorded
after them (``DeviceEpochReport.copy_s``, the handoff's wall).
Whatever staging wall is left after training completes is the EXPOSED
staging wall (``exposed_stage_s``).

The port's epoch is eager: the main thread dispatches it kernel by
kernel. So the stage of epoch e+1 is submitted BEFORE epoch e starts,
and its numpy work competes with the dispatch for the interpreter lock.
When the lazy schedule compiler runs on the card (``compiler="device"``)
its kernels (``seg_sort``, the device sampler) are issued from the
staging thread on that stream too, and it hands back host arrays, so
neither the compile nor the collation queues behind the epoch's
kernels; the staged tensors are the only ones that cross the streams.

Every epoch is collated to GLOBAL static bounds: ``merge_pad_bounds``
across workers, one ``k_max`` (and ``k_max_inter`` on a hierarchical
topology) maxed over every epoch's caches, and ``num_steps`` = the max
worker batch count (short workers get fully masked empty steps). So
every epoch's inputs have one set of shapes: ``trace_count`` -- the
distinct shape keys the epoch function was called with -- stays 1 (at
most 2 with one degraded epoch, whose lane bound may grow).

Supervision: a deadline on the staging future with an eager rebuild on
overrun or a dead thread, a bounded retry budget with exponential
back-off for transient stage faults (``StagingError`` when spent), a
degrade-to-uncached epoch when the staged C_s is lost, and periodic
atomic run-state checkpoints (``train.checkpoint.save_run_state``)
with the ``[start_epoch, stop_epoch)`` resume window. The fault plane's
``stage``, ``stage_cache`` and ``run_crash`` probes sit where the
reference's do.

Every timing of a report is the length of a ``repro_torch.core.trace``
span (``runner.epoch``, ``runner.boundary_copy``, ``runner.stage``,
``runner.await_stage``, ``runner.recover``), read whether the tracer
records or not; with it on, ``run`` also records ``runner.run``,
``runner.table_copy``, ``runner.drain``, the stage's parts
(``stage.compile``, ``stage.hot_set``, ``stage.collate``) on the staging
thread, and counts the bytes it copies to the card
(``runner.h2d_bytes``: the table a ``run`` call, the staging thread's
uploads) and the epochs staged through the device collation
(``runner.card_collations``).

``DeviceBaselineRunner`` is the same loop over ``make_ondemand_epoch``
with EMPTY caches: no C_s, no software pipeline, every remote id pulled
on the critical path.

``assert_host_parity`` checks the runner's per-epoch residual-miss lane
counts against the host-sim ``RapidGNNRunner``'s ``cache_misses``,
batch-exact on the identical schedule.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeout
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.schedule import WorkerSchedule, merge_pad_bounds
from repro_torch.dist.device_collate import (collate_epoch_on_device,
                                             lane_totals, upload)
from repro_torch.dist.gnn_step import (DeviceCache, DeviceView, empty_caches,
                                       epoch_k_max, epoch_k_max_split,
                                       make_ondemand_epoch,
                                       make_pipelined_epoch, stack_caches)
from repro_torch.dist.topology import Topology
from repro_torch.fault.inject import TransientFault, fault_point
from repro_torch.models.gnn import GNNConfig, init_params
from repro_torch.train.checkpoint import save_run_state


class StagingError(RuntimeError):
    """Epoch staging failed persistently (retry budget exhausted or a
    non-transient error); the original failure rides as ``__cause__``."""


@dataclasses.dataclass
class DeviceEpochReport:
    """Per-epoch accounting from one device runner epoch."""
    epoch: int
    steps: int                  # steps an epoch (global, padded)
    miss_lanes: np.ndarray      # (P,) residual-miss pull lanes per worker
    wire_rows: int              # padded rows the exchange actually moves
    losses: np.ndarray          # (S,) worker-averaged per step
    accs: np.ndarray            # (S,)
    wall_time_s: float
    #: host wall of staging the NEXT epoch (schedule build if lazy +
    #: collation + C_sec), overlapped with this epoch's training ...
    stage_s: float = 0.0
    #: ... and the slice of it left exposed after training finished
    #: (what a synchronous stage would add to the critical path is
    #: ``stage_s``; the overlap hides ``stage_s - exposed_stage_s``).
    exposed_stage_s: float = 0.0
    #: 1 when this epoch ran in a degraded mode (e.g. staged cache lost
    #: -> uncached baseline-style epoch), with the reason alongside
    degraded: int = 0
    degrade_reason: str = ""
    #: staging retries spent producing THIS epoch's buffers
    stage_retries: int = 0
    #: two-tier split of ``miss_lanes`` on a hierarchical topology:
    #: same-host lanes vs cross-host lanes; ``intra + inter ==
    #: miss_lanes`` elementwise (flat: intra = miss_lanes, inter = 0 --
    #: every peer counts as same-host)
    intra_lanes: Optional[np.ndarray] = None    # (P,)
    inter_lanes: Optional[np.ndarray] = None    # (P,)
    #: padded-row split of ``wire_rows`` by tier (flat: all intra)
    intra_wire_rows: int = 0
    inter_wire_rows: int = 0
    #: the port's epoch-boundary swap: host wall of handing this epoch's
    #: staged tensors, already on the card, from the staging stream to
    #: the runner's. Not in ``to_dict``, whose keys are the reference's.
    copy_s: float = 0.0

    @property
    def total_miss_lanes(self) -> int:
        return int(self.miss_lanes.sum())

    def payload_bytes(self, feat_dim: int, itemsize: int = 4) -> int:
        """True feature bytes requested (== host-sim remote_bytes)."""
        return self.total_miss_lanes * feat_dim * itemsize

    def request_bytes(self, itemsize: int = 4) -> int:
        """Id bytes shipped on the request legs (the padded int32 id
        matrices of every pull this epoch)."""
        return int(self.wire_rows) * itemsize

    def to_dict(self) -> Dict[str, Any]:
        """JSON-ready export, with the reference's keys."""
        intra = (self.miss_lanes if self.intra_lanes is None
                 else self.intra_lanes)
        inter = (np.zeros_like(self.miss_lanes)
                 if self.inter_lanes is None else self.inter_lanes)
        return {"epoch": self.epoch, "steps": self.steps,
                "miss_lanes": [int(x) for x in self.miss_lanes],
                "wire_rows": int(self.wire_rows),
                "intra_lanes": [int(x) for x in intra],
                "inter_lanes": [int(x) for x in inter],
                "intra_wire_rows": int(self.intra_wire_rows),
                "inter_wire_rows": int(self.inter_wire_rows),
                "losses": [float(x) for x in self.losses],
                "accs": [float(x) for x in self.accs],
                "wall_time_s": float(self.wall_time_s),
                "stage_s": float(self.stage_s),
                "exposed_stage_s": float(self.exposed_stage_s),
                "degraded": int(self.degraded),
                "degrade_reason": self.degrade_reason,
                "stage_retries": int(self.stage_retries)}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of a staged tree (dicts and lists)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree]


def shape_key(tree) -> Tuple:
    """The static shapes and dtypes of a staged epoch's tensors."""
    if isinstance(tree, dict):
        return tuple((k, shape_key(tree[k])) for k in sorted(tree))
    if isinstance(tree, list):
        return tuple(shape_key(t) for t in tree)
    return tuple(tree.shape), str(tree.dtype)


class _DeviceRunnerBase:
    """Shared epoch-loop machinery; subclasses pick program + caches."""

    uses_cache = True
    pulls_beyond_steps = 0      # pulls per epoch in excess of S steps

    def __init__(self, schedules: Sequence[WorkerSchedule], dv: DeviceView,
                 cfg: GNNConfig, opt, mesh, batch_size: int,
                 labels: np.ndarray, seed: int = 0,
                 assemble_backend: str = "auto", *,
                 stage_deadline_s: Optional[float] = None,
                 max_stage_retries: int = 2,
                 stage_retry_base_s: float = 0.01,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 1,
                 topology: Optional[Topology] = None):
        self.assemble_backend = assemble_backend
        # supervision knobs: a deadline on the overlapped stage future, a
        # bounded retry budget for transient stage failures, and optional
        # periodic atomic run-state checkpoints
        self.stage_deadline_s = stage_deadline_s
        self.max_stage_retries = max_stage_retries
        self.stage_retry_base_s = stage_retry_base_s
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.stage_retries = 0
        self.degraded_epochs = 0
        self.deadline_overruns = 0
        self.recovery_wall_s = 0.0
        self.schedules = list(schedules)
        self.P = len(self.schedules)
        if mesh.model > 1:
            raise ValueError(f"the runners train over data workers; a mesh "
                             f"of {mesh.model} model shards a worker "
                             f"({mesh.shape}) is the transformer's")
        if mesh.num_workers != self.P:
            raise ValueError(f"{self.P} schedules for a "
                             f"{mesh.num_workers}-worker mesh")
        self.topo = topology if topology is not None \
            else Topology.flat(self.P)
        if self.topo.num_workers != self.P:
            raise ValueError(
                f"topology {self.topo.describe()} describes "
                f"{self.topo.num_workers} workers, runner has {self.P}")
        if self.topo.is_hierarchical and tuple(mesh.axis_names) != \
                ("dcn", "data"):
            raise ValueError(
                f"hierarchical topology needs a ('dcn', 'data') mesh, "
                f"got axes {tuple(mesh.axis_names)}")
        n_epochs = {len(ws.epochs) for ws in self.schedules}
        if len(n_epochs) != 1:
            raise ValueError(f"workers disagree on epoch count: {n_epochs}")
        self.num_epochs = n_epochs.pop()
        self.dv = dv
        self.cfg = cfg
        self.opt = opt
        self.mesh = mesh
        self.device = mesh.device
        self.batch_size = batch_size
        self.labels = labels
        self.seed = seed

        # global static bounds: pad_bounds merged across workers, steps /
        # lane bound maxed over every (worker, epoch) -- one set of input
        # shapes for every epoch. Only the bound SCALARS are retained:
        # cache feature rows are rebuilt per staged epoch, so at most two
        # epochs' C_s/C_sec are live at once.
        self.m_max, self.edge_max = merge_pad_bounds(self.schedules)
        self.n_hot = max(1, max(ws.n_hot for ws in self.schedules))
        # hierarchical: k_max bounds the INTRA tier, k_max_inter the
        # cross-host tier; flat: k_max is the single-tier bound and
        # k_max_inter stays 1 (unused)
        self.num_steps, self.k_max, self.k_max_inter = 0, 1, 1
        for e in range(self.num_epochs):
            es_list = [ws.epoch(e) for ws in self.schedules]
            # ids-only cache view: the lane bound never touches feats
            ids_only = self._caches_for(es_list, ids_only=True)
            self.num_steps = max(self.num_steps,
                                 max(es.num_batches for es in es_list))
            if self.topo.is_hierarchical:
                k_i, k_x = epoch_k_max_split(es_list, ids_only, self.dv,
                                             self.topo)
                self.k_max = max(self.k_max, k_i)
                self.k_max_inter = max(self.k_max_inter, k_x)
            else:
                self.k_max = max(self.k_max,
                                 epoch_k_max(es_list, ids_only, self.dv))

        self._shape_keys: set = set()
        self._fn = self._make_epoch_fn()
        # the staging thread's card work (the lazy schedule compiler)
        # runs on a stream of its own
        self._stage_stream = (torch.cuda.Stream(device=self.device)
                              if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        # the collation's lookups, uploaded at the first stage
        self._g2d: Optional[torch.Tensor] = None
        self._labels: Optional[torch.Tensor] = None
        self.params: Optional[Any] = None
        self.opt_state: Optional[Any] = None
        self.stage_time_s = 0.0     # host-side staging wall (cumulative)
        self.exposed_stage_s = 0.0  # slice of it NOT hidden by training

    @property
    def trace_count(self) -> int:
        """Distinct static-shape keys the epoch function was called with
        (the reference's count of XLA traces)."""
        return len(self._shape_keys)

    def _caches_for(self, es_list, ids_only: bool = False
                    ) -> List[DeviceCache]:
        d = self.dv.table.shape[-1]
        if not self.uses_cache:
            return empty_caches(self.P, d)
        if ids_only:
            return [DeviceCache(ids=np.sort(self.dv.g2d[es.cache_ids]),
                                feats=np.zeros((0, d), np.float32))
                    for es in es_list]
        return [self.dv.remap_cache(es.cache_ids) for es in es_list]

    # -- per-epoch staging (the host half of the double buffer) ---------

    def _stage(self, e: int, attempt: int = 0,
               cause: Optional[trace.Span] = None, **attrs
               ) -> Dict[str, Any]:
        """Stage epoch ``e`` in a ``runner.stage`` span (``cause``: the
        ``runner.epoch`` span that submitted it from another thread)."""
        fault_point("stage", attempt=attempt, epoch=e)
        with trace.timed("runner.stage", cause=cause, epoch=e,
                         **attrs) as sp:
            if self._stage_stream is None:
                out = self._stage_inner(e)
            else:
                with torch.cuda.stream(self._stage_stream):
                    out = self._stage_inner(e)
        with self._lock:
            self.stage_time_s += sp.seconds
        out["stage_s"] = sp.seconds
        return out

    def _collate_and_account(self, es_list, caches, k_max: int,
                             k_max_inter: int) -> Dict[str, Any]:
        """Collate one epoch on the runner's device and derive its
        per-tier lane/wire accounting: true per-requesting-worker lane
        counts (the collation's, brought back to the host), padded wire
        rows from the static shapes. On a flat topology the whole
        exchange counts as the intra tier (every peer is same-host);
        hierarchical splits by tier, and the tiers' lanes sum to exactly
        what the flat plan would count."""
        if self._g2d is None:
            self._g2d = upload(self.dv.g2d, self.device)
            self._labels = upload(self.labels, self.device)
        batches, counts = collate_epoch_on_device(
            es_list, caches, self.dv, self._labels, self.batch_size,
            self.m_max, self.edge_max, k_max, self.num_steps,
            topology=self.topo, k_max_inter=k_max_inter,
            device=self.device, g2d=self._g2d)
        trace.count("runner.card_collations", 1)
        intra, inter = lane_totals(counts)
        # padded rows the exchange moves: the pipelined epoch pulls once
        # before its steps (the reference's pulled0; the port skips the
        # dead final prefetch, the reference moves it fully masked and
        # counts it, and so does this count), the on-demand epoch S times
        pulls = self.num_steps + self.pulls_beyond_steps
        if self.topo.is_hierarchical:
            _, P_, D, k_i = batches["intra_mask"].shape
            k_x = batches["inter_mask"].shape[-1]
            wire_intra = pulls * P_ * D * k_i
            wire_inter = pulls * P_ * P_ * k_x
        else:
            _, P_, _, k = batches["send_mask"].shape
            wire_intra = pulls * P_ * P_ * k
            wire_inter = 0
        return {
            "batches": batches,
            "lanes": intra + inter,
            "intra_lanes": intra,
            "inter_lanes": inter,
            "wire_rows": wire_intra + wire_inter,
            "intra_wire_rows": wire_intra,
            "inter_wire_rows": wire_inter,
        }

    def _stage_inner(self, e: int) -> Dict[str, Any]:
        with trace.span("stage.compile"):   # lazy schedules compile here
            es_list = [ws.epoch(e) for ws in self.schedules]
        with trace.span("stage.hot_set"):
            caches = self._caches_for(es_list)
        with trace.span("stage.collate"):
            staged = self._collate_and_account(es_list, caches, self.k_max,
                                               self.k_max_inter)
        if self.uses_cache:
            # the staged C_s can be LOST (fault plane): the epoch then
            # degrades to an uncached rebuild instead of failing the run
            if fault_point("stage_cache", epoch=e):
                staged["cache_lost"] = True
            else:
                with trace.span("stage.hot_set"):
                    self._stage_caches(staged, caches)
        return self._handoff(staged)

    def _stage_caches(self, staged: Dict[str, Any],
                      caches: Sequence[DeviceCache]) -> None:
        """C_sec stacked (``stack_caches``) and uploaded with the epoch."""
        cids, cfeats = stack_caches(caches, self.dv, self.n_hot)
        staged["cids"] = upload(cids, self.device)
        staged["cfeats"] = upload(cfeats, self.device)

    def _handoff(self, staged: Dict[str, Any]) -> Dict[str, Any]:
        """Mark the staged tensors ready: on the card, an event recorded
        on the stream that built them (the staging stream, or the runner's
        own for a rebuild on the critical path), which the boundary
        waits on."""
        if self.device.type == "cuda":
            staged["ready"] = torch.cuda.Event()
            staged["ready"].record(torch.cuda.current_stream(self.device))
        return staged

    def _stage_supervised(self, e: int, start_attempt: int = 0, **attrs
                          ) -> Tuple[Dict[str, Any], int]:
        """Stage epoch ``e`` with a bounded transient-retry budget
        (``attrs``: the ``runner.stage`` span's).

        Returns ``(staged, retries_used)``. Staging is deterministic
        given ``(schedule, e)``, so a retried or eagerly rebuilt stage is
        bit-identical to the one the background thread would have built.
        """
        err: Optional[BaseException] = None
        for i in range(self.max_stage_retries + 1):
            if i:
                time.sleep(self.stage_retry_base_s * 2 ** (i - 1))
                self.stage_retries += 1
            try:
                return self._stage(e, attempt=start_attempt + i,
                                   **attrs), i
            except TransientFault as exc:
                err = exc
        raise StagingError(f"staging epoch {e} failed after "
                           f"{self.max_stage_retries} retries") from err

    def _await_stage(self, fut, e: int) -> Tuple[Dict[str, Any], int]:
        """Collect the overlapped stage of epoch ``e``; on deadline
        overrun or a dead staging thread, rebuild EAGERLY on the critical
        path (counted in ``recovery_wall_s``) -- graceful degradation,
        never a different schedule. A failure that the rebuild meets
        again raises there."""
        try:
            return fut.result(timeout=self.stage_deadline_s), 0
        except FuturesTimeout:
            self.deadline_overruns += 1
        except Exception:   # a dead stage thread: the rebuild retries
            pass
        # start_attempt=1: the background attempt 0 already fired, so a
        # transient fault keyed to attempt 0 clears here deterministically
        with trace.timed("runner.recover") as sp:
            staged, retries = self._stage_supervised(e, start_attempt=1)
        self.recovery_wall_s += sp.seconds
        self.stage_retries += 1
        return staged, retries + 1

    def _degrade_uncached(self, e: int) -> Dict[str, Any]:
        """Rebuild epoch ``e`` with EMPTY caches after the staged C_s was
        lost: every remote id goes through the pull pipeline for this one
        epoch (baseline-style, counted as degraded). The lane bound may
        grow past the cached ``k_max`` -- the collation takes the grown
        bound, so this epoch may add one shape key; feature values are
        unchanged, so the loss curve still matches the clean run bit for
        bit."""
        es_list = [ws.epoch(e) for ws in self.schedules]
        d = self.dv.table.shape[-1]
        caches = empty_caches(self.P, d)
        if self.topo.is_hierarchical:
            k_i, k_x = epoch_k_max_split(es_list, caches, self.dv,
                                         self.topo)
            k = max(self.k_max, k_i)
            kx = max(self.k_max_inter, k_x)
        else:
            k = max(self.k_max, epoch_k_max(es_list, caches, self.dv))
            kx = self.k_max_inter
        staged = self._collate_and_account(es_list, caches, k, kx)
        self._stage_caches(staged, caches)
        staged["stage_s"] = 0.0
        return self._handoff(staged)

    def _to_device(self, staged: Dict[str, Any]) -> Tuple[Dict, float]:
        """The epoch-boundary swap: the staged tensors the epoch function
        reads, already on the device, handed to this thread's stream,
        which waits on the staging stream's event. -> (tensors, seconds).

        The tensors were allocated on the staging stream; each is marked
        used on this stream (``record_stream``), so the caching allocator
        does not hand its memory to the next stage before this stream's
        work on it is done. (That work is done anyway when the tensors are
        released: the next boundary comes after ``runner.drain``, which
        waits for the epoch, its side-stream pulls joined into it.)"""
        x = {k: staged[k] for k in ("batches", "cids", "cfeats")
             if k in staged}
        with trace.timed("runner.boundary_copy") as sp:
            ready = staged.get("ready")
            if ready is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ready)
                for t in _tensors(x):
                    t.record_stream(cur)
        return x, sp.seconds

    # -- the epoch loop --------------------------------------------------

    def run(self, params=None, opt_state=None, start_epoch: int = 0,
            stop_epoch: Optional[int] = None) -> List[DeviceEpochReport]:
        """Drive epochs ``[start_epoch, stop_epoch)`` (defaults: all).

        The window exists for checkpoint resume: run ``[0, k)``, save
        ``self.params``/``self.opt_state``, then a FRESH runner restored
        from the checkpoint runs ``[k, N)`` -- static bounds are global,
        so both windows see the same shapes and the concatenated loss
        curve matches an uninterrupted run bit for bit."""
        if stop_epoch is None:
            stop_epoch = self.num_epochs
        if not 0 <= start_epoch < stop_epoch <= self.num_epochs:
            raise ValueError(f"bad epoch window [{start_epoch}, "
                             f"{stop_epoch}) for {self.num_epochs} epochs")
        if params is None:
            params = init_params(self.cfg,
                                 torch.Generator().manual_seed(self.seed),
                                 self.device)
        if opt_state is None:
            opt_state = self.opt.init(params)
        with trace.span("runner.run"):
            return self._run(params, opt_state, start_epoch, stop_epoch)

    def _run(self, params, opt_state, start_epoch: int, stop_epoch: int
             ) -> List[DeviceEpochReport]:
        with trace.span("runner.table_copy"):
            table = torch.from_numpy(self.dv.table).to(self.device)
            offsets = torch.from_numpy(self.dv.offsets).to(self.device)
        trace.count("runner.h2d_bytes",
                    self.dv.table.nbytes + self.dv.offsets.nbytes)
        reports: List[DeviceEpochReport] = []
        # bootstrap C_s (Alg. 1 l.4), supervised: transient stage faults
        # retry in place instead of killing the run
        staged, pending_retries = self._stage_supervised(start_epoch,
                                                         bootstrap=1)
        with ThreadPoolExecutor(max_workers=1,
                                thread_name_prefix="runner-stage") as pool:
            for e in range(start_epoch, stop_epoch):
                with trace.timed("runner.epoch", epoch=e) as ep:
                    degraded, reason = 0, ""
                    if self.uses_cache and staged.get("cache_lost"):
                        # staged cache lost: run e UNCACHED (one degraded
                        # epoch, Alg. 1 degenerating to the baseline path)
                        with trace.timed("runner.recover") as rec:
                            staged = self._degrade_uncached(e)
                        self.recovery_wall_s += rec.seconds
                        self.degraded_epochs += 1
                        degraded, reason = 1, "cache_lost"
                    x, copy_s = self._to_device(staged)
                    # stage e+1 (lazy schedule build + C_sec + plans) in
                    # the background WHILE this thread dispatches epoch e
                    fut = (pool.submit(self._stage, e + 1, 0, ep)
                           if e + 1 < stop_epoch else None)
                    self._shape_keys.add(shape_key(x))
                    params, opt_state, losses, accs = self._run_epoch(
                        params, opt_state, table, offsets, x)
                    with trace.span("runner.drain"):   # waits for the epoch
                        losses = losses.cpu().numpy()
                        accs = accs.cpu().numpy()
                    nxt, nxt_retries, exposed = None, 0, 0.0
                    if fut is not None:
                        with trace.timed("runner.await_stage") as aw:
                            nxt, nxt_retries = self._await_stage(fut, e + 1)
                        exposed = aw.seconds
                    self.exposed_stage_s += exposed
                reports.append(DeviceEpochReport(
                    epoch=e, steps=self.num_steps,
                    miss_lanes=staged["lanes"],
                    wire_rows=staged["wire_rows"],
                    intra_lanes=staged.get("intra_lanes"),
                    inter_lanes=staged.get("inter_lanes"),
                    intra_wire_rows=staged.get("intra_wire_rows", 0),
                    inter_wire_rows=staged.get("inter_wire_rows", 0),
                    losses=losses, accs=accs,
                    wall_time_s=ep.seconds,
                    stage_s=(nxt["stage_s"] if nxt is not None else 0.0),
                    exposed_stage_s=exposed,
                    degraded=degraded, degrade_reason=reason,
                    stage_retries=pending_retries, copy_s=copy_s))
                self.params, self.opt_state = params, opt_state
                if (self.checkpoint_dir is not None
                        and (e + 1) % self.checkpoint_every == 0):
                    # atomic run-state commit; the crash probe AFTER it
                    # models dying between epochs -- resume picks up from
                    # LATEST and the stitched loss curve is bit-equal
                    save_run_state(self.checkpoint_dir,
                                   {"params": params, "opt": opt_state},
                                   step=e + 1)
                    fault_point("run_crash", epoch=e + 1)
                staged, pending_retries = nxt, nxt_retries
        self.params, self.opt_state = params, opt_state
        return reports

    # subclass hooks ------------------------------------------------------

    def _make_epoch_fn(self):
        raise NotImplementedError

    def _run_epoch(self, params, opt_state, table, offsets, x):
        raise NotImplementedError


class DeviceRapidGNNRunner(_DeviceRunnerBase):
    """Paper Alg. 1 on the mesh: C_s/C_sec double buffer + pipelined pull."""

    uses_cache = True
    pulls_beyond_steps = 1      # the pull before the first step

    def _make_epoch_fn(self):
        return make_pipelined_epoch(self.cfg, self.opt, self.mesh,
                                    self.m_max,
                                    assemble_backend=self.assemble_backend,
                                    topology=self.topo)

    def _run_epoch(self, params, opt_state, table, offsets, x):
        return self._fn(params, opt_state, table, offsets, x["cids"],
                        x["cfeats"], x["batches"])


class DeviceBaselineRunner(_DeviceRunnerBase):
    """DGL-style on-demand path: no cache, pull on the critical path."""

    uses_cache = False

    def _make_epoch_fn(self):
        return make_ondemand_epoch(self.cfg, self.opt, self.mesh,
                                   self.m_max,
                                   assemble_backend=self.assemble_backend,
                                   topology=self.topo)

    def _run_epoch(self, params, opt_state, table, offsets, x):
        return self._fn(params, opt_state, table, offsets, x["batches"])


def host_miss_matrix(schedules: Sequence[WorkerSchedule], pg,
                     batch_size: int) -> np.ndarray:
    """(E, P) host-sim ``cache_misses`` per (epoch, worker): every worker
    run through ``core.runtime.RapidGNNRunner`` on the same schedule."""
    from repro_torch.core.fetch import ShardedFeatureStore
    from repro_torch.core.metrics import NetworkModel
    from repro_torch.core.runtime import RapidGNNRunner

    E = len(schedules[0].epochs)
    out = np.zeros((E, len(schedules)), np.int64)
    for w, ws in enumerate(schedules):
        store = ShardedFeatureStore(pg, worker=w,
                                    net=NetworkModel(enabled=False))
        m = RapidGNNRunner(ws, store, batch_size=batch_size).run()
        out[:, w] = [em.cache_misses for em in m.epochs]
    return out


def assert_host_parity(schedules: Sequence[WorkerSchedule], pg,
                       batch_size: int,
                       reports: Sequence[DeviceEpochReport]) -> np.ndarray:
    """Device residual-miss lanes == host-sim cache_misses, per (epoch,
    worker). The two paths count the SAME miss sets from independent code
    (numpy searchsorted vs pull-plan lanes), so equality pins the device
    fetch accounting to the paper's. Returns the matrix."""
    host = host_miss_matrix(schedules, pg, batch_size)
    dev = np.stack([r.miss_lanes for r in reports])
    np.testing.assert_array_equal(
        dev, host,
        err_msg="device pull-lane counts diverge from host cache_misses")
    return host
