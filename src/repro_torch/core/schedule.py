"""Offline enumeration + cache-candidate selection (paper §3, Alg. 1 l.1-4).

The port's own copy of the JAX package's ``repro.core.schedule``, kept
bit-identical to it. Precomputes, per worker, the full deterministic
training schedule:
  * every epoch's batch metadata  {B_e}  (ids / offsets / locality only),
    compiled whole-epoch by ``KHopSampler.sample_epoch_batched`` into a
    packed ``FlatEpoch`` (the per-batch ``sample_epoch`` loop survives
    as the parity oracle, ``compiler="loop"``, and ``compiler="device"``
    runs the sort-bound middle on the card through the ``seg_sort``
    kernel, ``graph/device_sampler.py`` -- all three bit-identical),
  * the access union  N = U_e U_i N_i^e  and  N_remote = N \\ N_local,
  * per-epoch remote access frequencies  freq(.)  over {B_e},
  * the hot set  N_cache = top-n_hot of N_remote by (freq desc, id asc)
    -- the DETERMINISTIC tie-break Prop 3.1 needs -- (per epoch, so the
    double buffer C_sec for e+1 can differ from C_s for e),
  * padding bounds  m_max  and per-layer edge maxima (static shapes).

Like the paper's SSD streaming, epochs can be spilled to disk
(``spill_dir``): the FlatEpoch arrays go straight into one ``np.savez``
file per (worker, epoch) -- flat ndarray blocks, no pickled object
graph -- so spills are smaller and reload without per-batch
reconstruction. The writes themselves run on a background
``SpillWriter`` thread, off the build loop's critical path. A schedule
can instead stay resident (``lazy=True``): no payload retention, no
spill -- ``epoch(e)`` re-runs the deterministic compiler on demand.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
import zipfile
import zlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fault.inject import fault_point
from repro_torch.graph.partition import PartitionedGraph
from repro_torch.graph.sampler import FlatEpoch, KHopSampler, SampledBatch


class SpillCorruptError(RuntimeError):
    """A spilled epoch failed integrity at load: unreadable archive,
    missing entries, or a per-array crc32 mismatch. ``WorkerSchedule.
    epoch`` heals it by rebuilding from the deterministic compiler."""

    def __init__(self, msg: str, path: Optional[str] = None):
        super().__init__(msg)
        self.path = path


class EpochSchedule:
    """One worker-epoch of the schedule: packed batches + hot-set
    metadata.

    The canonical batch payload is ``flat`` (a ``FlatEpoch``: CSR-style
    whole-epoch arrays, DESIGN.md §2.1); ``batches`` materializes the
    legacy ``List[SampledBatch]`` form lazily as zero-copy views for
    the per-batch oracle/compat paths (host-sim runners, loop
    collation). Constructing from ``batches=`` packs them into a
    FlatEpoch, so synthetic-schedule builders keep working unchanged.
    """

    def __init__(self, epoch: int, flat: Optional[FlatEpoch] = None,
                 batches: Optional[List[SampledBatch]] = None,
                 remote_ids: Optional[np.ndarray] = None,
                 remote_freq: Optional[np.ndarray] = None,
                 cache_ids: Optional[np.ndarray] = None,
                 m_max: int = 0):
        if flat is None:
            if batches is None:
                raise ValueError("EpochSchedule needs flat= or batches=")
            worker = batches[0].worker if batches else 0
            flat = FlatEpoch.from_batches(batches, epoch=epoch,
                                          worker=worker)
            self._batches: Optional[List[SampledBatch]] = list(batches)
        else:
            self._batches = None
        self.epoch = epoch
        self.flat = flat
        z = np.zeros(0, np.int64)
        self.remote_ids = remote_ids if remote_ids is not None else z
        self.remote_freq = remote_freq if remote_freq is not None \
            else z.copy()
        self.cache_ids = cache_ids if cache_ids is not None else z.copy()
        self.m_max = m_max

    @property
    def batches(self) -> List[SampledBatch]:
        if self._batches is None:
            self._batches = self.flat.to_batches()
        return self._batches

    @property
    def num_batches(self) -> int:
        return self.flat.num_batches


# ---------------------------------------------------------------------------
# npz spill format (flat arrays only -- no pickled objects)
# ---------------------------------------------------------------------------

def spill_path(spill_dir: str, worker: int, e: int) -> str:
    return os.path.join(spill_dir, f"w{worker}_e{e}.npz")


def save_epoch_npz(path: str, es: EpochSchedule) -> None:
    """Spill one epoch: every FlatEpoch array plus the hot-set metadata
    as plain ndarray entries (``allow_pickle`` stays off on reload).

    Integrity (DESIGN.md §10): each array gets a ``crc32_<name>``
    companion entry so bit-rot/tearing is detected at load (and healed
    by rebuild); the write is atomic (tmp + fsync + rename) so a crash
    mid-spill can never leave a half-written file under the final name."""
    flat = es.flat
    arrs = {
        "meta": np.array([es.epoch, flat.worker, es.m_max,
                          flat.num_layers], np.int64),
        "seeds": flat.seeds, "seed_starts": flat.seed_starts,
        "input_nodes": flat.input_nodes,
        "input_starts": flat.input_starts, "num_dst": flat.num_dst,
        "remote_ids": es.remote_ids, "remote_freq": es.remote_freq,
        "cache_ids": es.cache_ids,
    }
    for l in range(flat.num_layers):
        arrs[f"edge_src_{l}"] = flat.edge_src[l]
        arrs[f"edge_dst_{l}"] = flat.edge_dst[l]
        arrs[f"edge_mask_{l}"] = flat.edge_mask[l]
        arrs[f"edge_starts_{l}"] = flat.edge_starts[l]
    for k in list(arrs):
        arrs[f"crc32_{k}"] = np.uint32(_array_crc(arrs[k]))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        # repro: allow(SPILL-SAFETY) -- the port's copy of the sanctioned flat npz spill writer; allow_pickle stays off
        np.savez(f, **arrs)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _array_crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


class SpillWriter:
    """Background npz spill writer: ``save_epoch_npz`` runs on a worker
    thread so disk writes come OFF the build loop's critical path (the
    write of epoch ``e`` overlaps the build of epoch ``e+1``).
    ``flush()`` joins the queue at epoch boundaries -- at most one spill
    is ever in flight, bounding live payload memory at two epochs -- and
    re-raises any writer-thread failure on the submitting thread."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._closed = False
        self._t = threading.Thread(target=self._run, daemon=True,
                                   name="spill-writer")
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, es = item
                save_epoch_npz(path, es)
                # spill-damage probe (corrupt/truncate/drop the file
                # just written): detection happens at LOAD via the crc
                # entries, recovery via the builder rebuild
                fault_point("spill_write", path=path, epoch=es.epoch,
                            worker=es.flat.worker)
            except BaseException as exc:      # surfaced at next flush()
                with self._err_lock:
                    self._err = exc
            finally:
                self._q.task_done()

    def submit(self, path: str, es: EpochSchedule) -> None:
        if self._closed:
            raise RuntimeError("SpillWriter.submit() after close()")
        self._raise_pending()
        self._q.put((path, es))

    def flush(self) -> None:
        self._q.join()
        self._raise_pending()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Idempotent teardown, safe on exception paths: the sentinel is
        posted and the worker joined (bounded) even if flush() raises a
        pending writer error. A writer that outlives the deadline raises
        a loud ``TimeoutError`` naming the thread (never a silent leak)."""
        if self._closed:
            return
        self._closed = True
        try:
            self.flush()
        finally:
            self._q.put(None)
            self._t.join(timeout=timeout)
            if self._t.is_alive():
                raise TimeoutError(
                    f"spill writer thread {self._t.name} still alive "
                    f"after {timeout}s join deadline")

    def _raise_pending(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError("background spill write failed") from err


def _verify_spill(z, path: str) -> None:
    """Per-array crc check. Files spilled before the crc entries existed
    stay loadable (no companion entry -> no check)."""
    for k in z.files:
        if k.startswith("crc32_"):
            continue
        want = f"crc32_{k}"
        if want not in z.files:
            continue
        if _array_crc(z[k]) != int(z[want]):
            raise SpillCorruptError(
                f"crc mismatch for array {k!r} in spill {path}",
                path=path)


def load_epoch_npz(path: str) -> EpochSchedule:
    """Load one spilled epoch, raising ``SpillCorruptError`` on ANY
    integrity failure -- missing/truncated/unreadable archive, missing
    entries, or crc mismatch -- instead of leaking raw numpy/zipfile
    errors (the caller's heal path keys on the typed error)."""
    try:
        # repro: allow(SPILL-SAFETY) -- the port's copy of the sanctioned flat npz spill reader; allow_pickle stays off
        with np.load(path) as z:
            _verify_spill(z, path)
            e, worker, m_max, L = (int(x) for x in z["meta"])
            flat = FlatEpoch(
                epoch=e, worker=worker, seeds=z["seeds"],
                seed_starts=z["seed_starts"],
                input_nodes=z["input_nodes"],
                input_starts=z["input_starts"], num_dst=z["num_dst"],
                edge_src=[z[f"edge_src_{l}"] for l in range(L)],
                edge_dst=[z[f"edge_dst_{l}"] for l in range(L)],
                edge_mask=[z[f"edge_mask_{l}"] for l in range(L)],
                edge_starts=[z[f"edge_starts_{l}"] for l in range(L)])
            return EpochSchedule(epoch=e, flat=flat,
                                 remote_ids=z["remote_ids"],
                                 remote_freq=z["remote_freq"],
                                 cache_ids=z["cache_ids"], m_max=m_max)
    except SpillCorruptError:
        raise
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as exc:
        raise SpillCorruptError(f"unreadable spill {path}: {exc!r}",
                                path=path) from exc


@dataclasses.dataclass
class WorkerSchedule:
    worker: int
    s0: int
    n_hot: int
    epochs: List[Optional[EpochSchedule]]
    spill_dir: Optional[str] = None
    #: per-epoch (m_max, edge_maxima) pad metadata, captured at build time
    #: so pad-bound queries never re-load spilled epochs from disk.
    epoch_meta: Optional[List[Tuple[int, List[int]]]] = None
    #: on-demand epoch recompiler (bit-identical by Prop 3.1). In lazy /
    #: device-resident mode it IS the payload source (``epoch(e)``
    #: re-runs it every call); for spilled schedules it is the HEAL path:
    #: a spill that fails integrity at load is rebuilt and re-spilled.
    builder: Optional[Callable[[int], EpochSchedule]] = None
    #: spilled epochs healed by rebuild (fault plane, DESIGN.md §10)
    spill_rebuilds: int = 0

    def epoch(self, e: int) -> EpochSchedule:
        if self.epochs[e] is not None:
            return self.epochs[e]
        if self.spill_dir is not None:                  # spilled
            path = spill_path(self.spill_dir, self.worker, e)
            try:
                return load_epoch_npz(path)
            except SpillCorruptError:
                if self.builder is None:
                    raise
                # heal: the deterministic compiler IS the backup copy --
                # rebuild bit-identically and re-spill for the next read
                self.spill_rebuilds += 1
                es = self.builder(e)
                save_epoch_npz(path, es)
                return es
        if self.builder is not None:                    # device-resident
            return self.builder(e)
        raise RuntimeError(
            f"epoch {e} has no payload, spill_dir, or builder")

    def _meta(self) -> List[Tuple[int, List[int]]]:
        if self.epoch_meta is None:     # schedules built before the cache
            self.epoch_meta = []        # existed: one-time backfill
            for e in range(len(self.epochs)):
                es = self.epoch(e)
                self.epoch_meta.append((es.m_max, epoch_edge_maxima(es)))
        return self.epoch_meta

    @property
    def m_max(self) -> int:
        return max(m for m, _ in self._meta())

    def pad_bounds(self) -> Tuple[int, List[int]]:
        """Static (m_max, edge_maxima) across ALL epochs -> one padded
        shape; served from cached metadata, never from spill_dir.
        Empty epochs (all-zero or empty edge maxima) don't shrink the
        merged bound."""
        metas = self._meta()
        m_max = max(m for m, _ in metas)
        edge_max: List[int] = []
        for _, em in metas:
            edge_max = _merge_edge_maxima(edge_max, em)
        return m_max, edge_max


def _merge_edge_maxima(acc: List[int], em: Sequence[int]) -> List[int]:
    """Elementwise max-merge of per-layer edge maxima; an empty list
    (epoch/worker with no batches) never shrinks the accumulator."""
    if not em:
        return acc
    if not acc:
        return list(em)
    return [max(a, b) for a, b in zip(acc, em)]


def merge_pad_bounds(
        schedules: Sequence["WorkerSchedule"]) -> Tuple[int, List[int]]:
    """Global static (m_max, edge_maxima) across WORKERS: max-merge each
    schedule's all-epoch ``pad_bounds()``, skipping all-empty workers'
    empty edge lists -- the one-compilation bound the multi-epoch device
    runner collates every epoch to."""
    m_max, edge_max = 0, []
    for ws in schedules:
        m, em = ws.pad_bounds()
        m_max = max(m_max, m)
        edge_max = _merge_edge_maxima(edge_max, em)
    return m_max, edge_max


def select_hot_set(remote_ids: np.ndarray, remote_freq: np.ndarray,
                   n_hot: int,
                   weight: Optional[np.ndarray] = None) -> np.ndarray:
    """Top-``n_hot`` remote ids by (freq desc, id asc), returned SORTED.

    The lexicographic tie-break is load-bearing: ``argpartition`` (the
    historical selection) breaks frequency ties arbitrarily across numpy
    versions/platforms, and a schedule whose C_s depends on partition
    internals is not the paper's deterministic schedule (Prop 3.1).
    ``remote_ids`` arrives ascending (``np.unique`` output), so a STABLE
    sort on descending frequency realises (-freq, id) order exactly.

    ``weight`` (aligned with ``remote_ids``) multiplies the frequency
    before ranking -- the topology-aware admission bias (DESIGN.md
    §6.7): cross-DCN owners get ``weight > 1`` so the cache preferably
    saves the expensive fetches. ``weight=None`` (and any all-equal
    weight) leaves the selection bit-identical to the unbiased path.
    """
    k = min(n_hot, remote_ids.shape[0])
    if k <= 0:
        return np.zeros(0, np.int64)
    eff = remote_freq if weight is None \
        else remote_freq.astype(np.float64) * weight
    order = np.argsort(-eff, kind="stable")
    return np.sort(remote_ids[order[:k]])


def _build_epoch(sampler: KHopSampler, pg: PartitionedGraph, worker: int,
                 s0: int, e: int, train_nodes: np.ndarray, n_hot: int,
                 compiler: str = "batched",
                 owner_bias: Optional[np.ndarray] = None,
                 device=None) -> EpochSchedule:
    if compiler == "batched":
        flat = sampler.sample_epoch_batched(s0, worker, e, train_nodes)
    elif compiler == "device":
        from repro_torch.graph.device_sampler import \
            sample_epoch_batched_device
        flat = sample_epoch_batched_device(sampler, s0, worker, e,
                                           train_nodes, device=device)
    elif compiler == "loop":
        flat = FlatEpoch.from_batches(
            sampler.sample_epoch(s0, worker, e, train_nodes), epoch=e,
            worker=worker, num_layers=len(sampler.fanouts))
    else:
        raise ValueError(f"unknown schedule compiler {compiler!r} "
                         f"(expected 'batched', 'device' or 'loop')")
    m_counts = flat.m_counts
    m_max = int(m_counts.max()) if m_counts.size else 0
    # frequency over the epoch: one count per batch containing the node
    # (N_i^e is a set; input_nodes are unique per batch, so one bincount
    # over the flat stream IS the per-batch indicator sum)
    remote = flat.input_nodes[pg.owner[flat.input_nodes] != worker]
    if compiler == "device" and owner_bias is None:
        from repro_torch.graph.device_sampler import (
            device_remote_freq, device_select_hot_set)
        remote_ids, remote_freq = device_remote_freq(
            remote, int(pg.graph.num_nodes), device=device)
        cache_ids = device_select_hot_set(remote_ids, remote_freq, n_hot,
                                          device=device)
    else:
        # owner_bias (topology-aware admission, DESIGN.md §6.7) routes
        # through the numpy selector on every compiler: the weighted
        # ranking has no device port, and schedule determinism only
        # needs the selection itself to be platform-independent
        if remote.size:
            remote_ids, remote_freq = np.unique(remote,
                                                return_counts=True)
        else:
            remote_ids = np.zeros(0, np.int64)
            remote_freq = np.zeros(0, np.int64)
        weight = (None if owner_bias is None
                  else np.asarray(owner_bias,
                                  np.float64)[pg.owner[remote_ids]])
        cache_ids = select_hot_set(remote_ids, remote_freq, n_hot,
                                   weight=weight)
    return EpochSchedule(epoch=e, flat=flat, remote_ids=remote_ids,
                         remote_freq=remote_freq, cache_ids=cache_ids,
                         m_max=m_max)


def build_schedule(sampler: KHopSampler, pg: PartitionedGraph, worker: int,
                   s0: int, num_epochs: int, n_hot: int,
                   spill_dir: Optional[str] = None,
                   compiler: str = "batched",
                   lazy: bool = False,
                   owner_bias: Optional[np.ndarray] = None,
                   device=None) -> WorkerSchedule:
    """Paper Alg. 1 lines 1-3, for one worker.

    ``compiler`` picks the epoch sampler: ``"batched"`` (default) is the
    vectorized whole-epoch compiler, ``"device"`` its port to the card
    (on the torch ``device``: ``None`` means ``cuda``, and raises
    without a card), ``"loop"`` the per-batch oracle -- all three
    produce bit-identical schedules (the parity suites pin it).

    ``lazy=True`` is the device-resident mode: one metadata prepass
    captures pad bounds + per-epoch maxima, then epoch PAYLOADS are
    dropped and ``epoch(e)`` re-runs the deterministic compiler on
    demand -- at most two epochs ever live in memory, and disk spill is
    skipped entirely (the schedule re-materializes from (s0, w, e)
    faster than an npz read-back on device). Spilled (non-lazy) builds
    write their npz files on a background ``SpillWriter`` thread, so
    epoch ``e``'s write overlaps epoch ``e+1``'s build.

    ``owner_bias`` ((P,) float, e.g. ``Topology.owner_bias``) weights
    the hot-set frequency per owning worker -- the topology-aware cache
    admission (DESIGN.md §6.7). None keeps the unbiased paper schedule
    bit-identical."""
    local = pg.local_nodes[worker]
    tm = pg.graph.train_mask
    train_nodes = local[tm[local]] if tm is not None else local
    if lazy:
        spill_dir = None        # device-resident: no disk spill at all
    epochs: List[Optional[EpochSchedule]] = []
    epoch_meta: List[Tuple[int, List[int]]] = []
    writer: Optional[SpillWriter] = None
    if spill_dir is not None:
        os.makedirs(spill_dir, exist_ok=True)
        writer = SpillWriter()
    try:
        for e in range(num_epochs):
            es = _build_epoch(sampler, pg, worker, s0, e, train_nodes,
                              n_hot, compiler=compiler,
                              owner_bias=owner_bias, device=device)
            epoch_meta.append(
                (es.m_max,
                 epoch_edge_maxima(es, num_layers=len(sampler.fanouts))))
            if lazy:
                epochs.append(None)     # payload rebuilt on demand
            elif writer is not None:
                writer.flush()          # epoch boundary: e-1's write done
                writer.submit(spill_path(spill_dir, worker, e), es)
                epochs.append(None)
            else:
                epochs.append(es)
    finally:
        if writer is not None:
            writer.close()

    # the builder closure is ALWAYS attached: it is the payload source in
    # lazy mode and the spill heal path otherwise (a corrupt/missing npz
    # rebuilds bit-identically from (s0, worker, e) -- Prop 3.1)
    def builder(e: int) -> EpochSchedule:
        return _build_epoch(sampler, pg, worker, s0, e, train_nodes,
                            n_hot, compiler=compiler,
                            owner_bias=owner_bias, device=device)
    return WorkerSchedule(worker=worker, s0=s0, n_hot=n_hot, epochs=epochs,
                          spill_dir=spill_dir, epoch_meta=epoch_meta,
                          builder=builder)


# ---------------------------------------------------------------------------
# Padded device-ready collation (static shapes; DESIGN.md §2)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CollatedBatch:
    """Static-shape batch: every array padded to epoch-level maxima.
    Padded input-node slots carry id -1 and are masked everywhere."""
    seeds: np.ndarray          # (B,) int32, -1 padded
    seed_mask: np.ndarray      # (B,) bool
    labels: np.ndarray         # (B,) int32
    input_nodes: np.ndarray    # (m_max,) int64, -1 padded
    input_mask: np.ndarray     # (m_max,) bool
    num_inputs: int
    # per layer: (E_max,) arrays
    edge_src: List[np.ndarray]
    edge_dst: List[np.ndarray]
    edge_mask: List[np.ndarray]
    num_dst: List[int]         # true dst count per layer (static per batch)


def collate(batch: SampledBatch, labels: np.ndarray, batch_size: int,
            m_max: int, edge_max: Sequence[int]) -> CollatedBatch:
    b = batch
    m = b.num_input_nodes
    inp = np.full(m_max, -1, dtype=np.int64)
    inp[:m] = b.input_nodes
    imask = np.zeros(m_max, dtype=bool)
    imask[:m] = True

    B = b.seeds.shape[0]
    seeds = np.full(batch_size, -1, dtype=np.int64)
    seeds[:B] = b.seeds
    smask = np.zeros(batch_size, dtype=bool)
    smask[:B] = True
    lab = np.zeros(batch_size, dtype=np.int32)
    lab[:B] = labels[b.seeds]

    es, ed, em, ndst = [], [], [], []
    for l, blk in enumerate(b.blocks):
        E = blk.edge_src.shape[0]
        pe = np.zeros(edge_max[l], dtype=np.int32)
        pd = np.zeros(edge_max[l], dtype=np.int32)
        pm = np.zeros(edge_max[l], dtype=bool)
        pe[:E] = blk.edge_src
        pd[:E] = blk.edge_dst
        pm[:E] = blk.edge_mask
        es.append(pe)
        ed.append(pd)
        em.append(pm)
        ndst.append(blk.num_dst)
    return CollatedBatch(seeds=seeds, seed_mask=smask, labels=lab,
                         input_nodes=inp, input_mask=imask, num_inputs=m,
                         edge_src=es, edge_dst=ed, edge_mask=em,
                         num_dst=ndst)


def epoch_edge_maxima(es: EpochSchedule,
                      num_layers: Optional[int] = None) -> List[int]:
    """Per-layer max padded edge count over the epoch's batches, read
    straight off the FlatEpoch segment offsets (one ``diff().max()`` per
    layer, no batch loop).

    An epoch with no batches (a worker whose partition holds no train
    nodes) contributes all-zero maxima (layer count from ``num_layers``
    or the flat layout itself) -- ``pad_bounds`` skips those when
    merging."""
    flat = es.flat
    if flat.num_batches == 0:
        return [0] * (num_layers if num_layers is not None
                      else flat.num_layers)
    return [int(np.diff(s).max()) for s in flat.edge_starts]
