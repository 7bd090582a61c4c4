"""Declarative campaign grids: which cells to run, on which backend.

A *cell* is one (backend, system, scenario) point: backend picks the
execution substrate (``host`` = the metered host-sim runners in
``repro_torch.core.runtime``, ``device`` = the SPMD runners in
``repro_torch.dist.runner`` on an emulated/real mesh), system picks the data
path (``rapidgnn`` vs the on-demand baselines), and the scenario --
dataset, batch size, worker count, cache budget, epochs, seed, fanouts,
partitioner -- is shared verbatim by every cell of a pair so measured
differences isolate exactly one axis.

Cells that share ``scenario_key()`` but differ in *backend* are
differentially verified against each other (repro_torch.eval.differential);
cells that share it but differ in *system* yield the paper's headline
ratios (repro_torch.eval.report).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

#: host-sim systems (benchmarks §5.1 naming); the device backend
#: realises the first two (rapid vs on-demand baseline) on the mesh.
HOST_SYSTEMS = ("rapidgnn", "dgl-metis", "dgl-random", "gcn")
DEVICE_SYSTEMS = ("rapidgnn", "dgl-metis")


@dataclasses.dataclass(frozen=True)
class CellSpec:
    backend: str                    # "host" | "device"
    system: str                     # one of HOST_SYSTEMS
    dataset: str
    batch_size: int
    workers: int
    n_hot: int                      # cache budget (rapidgnn only)
    epochs: int
    seed: int = 42
    fanouts: Tuple[int, ...] = (25, 10)
    partition: str = "metis"        # "dgl-random" forces "random"
    hidden: int = 32
    Q: int = 4                      # host prefetch queue depth (rapid)
    train: bool = True
    all_workers: bool = True        # host: run every worker (device always)
    net_enabled: bool = True        # host network-model sleeps
    #: epoch sampler: "batched" = the vectorized schedule compiler
    #: (default), "loop" = the per-batch oracle. Bit-identical schedules
    #: by the parity contract, so deliberately NOT part of
    #: ``scenario_key()`` -- cells differing only here still pair.
    schedule_compiler: str = "batched"
    #: where the schedule compiler runs: "numpy" = host compilers as
    #: picked by ``schedule_compiler``, "device" = the accelerator port
    #: (DESIGN.md §2.2) with lazy device-resident schedules on the
    #: device backend. Same bit-parity contract as ``schedule_compiler``,
    #: so likewise EXCLUDED from ``scenario_key()``.
    schedule_backend: str = "numpy"
    #: fault-plane profile (repro_torch.fault.plan.PROFILES) activated around
    #: this cell's runs; "none" = clean. Faulted cells are a DIFFERENT
    #: scenario from clean ones (they may degrade epochs), so both fault
    #: fields ARE part of ``scenario_key()``; ``verify_fault_pairs``
    #: compares a faulted cell to its clean twin by neutralizing them.
    fault_profile: str = "none"
    fault_seed: int = 0
    #: deadline on the device runner's overlapped stage future (None =
    #: wait forever); a timing knob, NOT part of the scenario key.
    stage_deadline_s: Optional[float] = None
    #: device-mesh topology: "flat" = the classic ("data",) mesh, or
    #: "HxD" (e.g. "2x2") = H emulated hosts x D devices with two-tier
    #: pull plans (repro_torch.dist.topology, DESIGN.md §6.7). The two-tier
    #: exchange is bit-equal to the flat one (the parity contract), so
    #: like the schedule knobs this is EXCLUDED from ``scenario_key()``
    #: -- a hierarchical cell pairs with its flat twin and the
    #: intra+inter byte-sum identity is checked against it.
    topology: str = "flat"

    def __post_init__(self):
        if self.backend not in ("host", "device"):
            raise ValueError(f"unknown backend {self.backend!r}")
        systems = HOST_SYSTEMS if self.backend == "host" else DEVICE_SYSTEMS
        if self.system not in systems:
            raise ValueError(f"system {self.system!r} not available on "
                             f"backend {self.backend!r} (have {systems})")
        if self.schedule_compiler not in ("batched", "loop"):
            raise ValueError(f"unknown schedule_compiler "
                             f"{self.schedule_compiler!r}")
        if self.schedule_backend not in ("numpy", "device"):
            raise ValueError(f"unknown schedule_backend "
                             f"{self.schedule_backend!r}")
        if self.fault_profile != "none":
            from repro_torch.fault.plan import PROFILES
            if self.fault_profile not in PROFILES:
                raise ValueError(f"unknown fault_profile "
                                 f"{self.fault_profile!r}")
        if self.topology != "flat":
            if self.backend != "device":
                raise ValueError("hierarchical topology needs the device "
                                 f"backend, got {self.backend!r}")
            from repro_torch.dist.topology import Topology
            Topology.parse(self.topology, self.workers)  # validates HxD
        object.__setattr__(self, "fanouts", tuple(self.fanouts))

    @property
    def is_rapid(self) -> bool:
        return self.system == "rapidgnn"

    @property
    def effective_compiler(self) -> str:
        """The ``build_schedule`` compiler this cell actually runs:
        ``schedule_backend="device"`` overrides the host compiler choice
        with the accelerator port."""
        return ("device" if self.schedule_backend == "device"
                else self.schedule_compiler)

    @property
    def partition_method(self) -> str:
        return "random" if self.system == "dgl-random" else self.partition

    @property
    def effective_fanouts(self) -> Tuple[int, ...]:
        """gcn is DEFINED as the wider-block baseline (paper §5.1), so
        its sampler ignores the grid's fanouts."""
        return (50, 50) if self.system == "gcn" else self.fanouts

    def scenario_key(self) -> Tuple:
        """Everything shared across a differential pair: two cells with
        equal keys consumed the IDENTICAL deterministic schedule. Built
        from the EFFECTIVE partition/fanouts, so dgl-random (random
        partition) and gcn (50,50 fanouts) cells never key-match a
        rapidgnn cell -- their schedules differ by design, and only the
        grid-level ratio pairing (repro_torch.eval.report) may compare them."""
        return (self.dataset, self.batch_size, self.workers, self.n_hot,
                self.epochs, self.seed, self.effective_fanouts,
                self.partition_method, self.fault_profile,
                self.fault_seed)

    def topology_obj(self):
        """-> ``repro_torch.dist.topology.Topology`` for this cell."""
        from repro_torch.dist.topology import Topology
        return Topology.parse(self.topology, self.workers)

    def label(self) -> str:
        base = (f"{self.backend}/{self.system}/{self.dataset}"
                f"/b{self.batch_size}/w{self.workers}/h{self.n_hot}"
                f"/e{self.epochs}")
        if self.topology != "flat":
            base += f"/t{self.topology}"
        if self.fault_profile != "none":
            base += f"/f{self.fault_profile}"
        return base

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["fanouts"] = list(self.fanouts)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "CellSpec":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["fanouts"] = tuple(kw.get("fanouts", (25, 10)))
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    name: str
    cells: Tuple[CellSpec, ...]

    def __iter__(self):
        return iter(self.cells)

    def device_cells(self) -> List[CellSpec]:
        return [c for c in self.cells if c.backend == "device"]

    def host_cells(self) -> List[CellSpec]:
        return [c for c in self.cells if c.backend == "host"]


def grid(backends: Sequence[str], systems: Sequence[str],
         datasets: Sequence[str], batch_sizes: Sequence[int],
         workers: Sequence[int], n_hots: Sequence[int],
         epochs: int, **common) -> List[CellSpec]:
    """Cross-product cell builder; skips systems a backend lacks."""
    out = []
    for be, sy, ds, bs, w, nh in itertools.product(
            backends, systems, datasets, batch_sizes, workers, n_hots):
        if be == "device" and sy not in DEVICE_SYSTEMS:
            continue
        out.append(CellSpec(backend=be, system=sy, dataset=ds,
                            batch_size=bs, workers=w, n_hot=nh,
                            epochs=epochs, **common))
    return out


def fast_grid() -> CampaignSpec:
    """CPU-sized paired grid: rapid vs baseline on BOTH backends over the
    tiny graph, every cell of a scenario sharing schedules exactly, so
    the host-vs-device differential checks run on every pair. Each
    device cell additionally re-runs on the hierarchical 2x2 topology
    (2 emulated hosts x 2 devices), pairing with its flat twin for the
    cross-topology parity + byte-sum checks."""
    cells = grid(backends=("host", "device"),
                 systems=("rapidgnn", "dgl-metis"),
                 datasets=("tiny",), batch_sizes=(16,), workers=(4,),
                 n_hots=(64,), epochs=3, seed=42, fanouts=(5, 5),
                 partition="greedy")
    cells += [dataclasses.replace(c, topology="2x2")
              for c in cells if c.backend == "device"]
    return CampaignSpec(name="fast", cells=tuple(cells))


def full_grid() -> CampaignSpec:
    """Paper-scale host grid (Tables 2/3, Figs 4-6 axes) plus the device
    pair for differential coverage. Slow: minutes on CPU."""
    host = grid(backends=("host",), systems=HOST_SYSTEMS,
                datasets=("ogbn_products_sim", "reddit_sim"),
                batch_sizes=(100, 200), workers=(4,), n_hots=(32768,),
                epochs=2, seed=42, fanouts=(25, 10), partition="metis",
                all_workers=False)
    dev = grid(backends=("host", "device"),
               systems=("rapidgnn", "dgl-metis"),
               datasets=("tiny",), batch_sizes=(16,), workers=(4,),
               n_hots=(64,), epochs=3, seed=42, fanouts=(5, 5),
               partition="greedy")
    return CampaignSpec(name="full", cells=tuple(host + dev))


def fault_grid(fault_seed: int = 7) -> CampaignSpec:
    """Fault campaign (BENCH_fault.json): the fast-grid rapidgnn
    scenario re-run under named fault profiles on both backends, each
    faulted cell paired with a clean twin for bit-parity verification.
    Device profiles exercise staging/caching/crash sites, host profiles
    the prefetch/pull/C_sec sites; ``cache-loss`` guarantees the report
    its >=1 degraded-epoch cell."""
    common = dict(dataset="tiny", batch_size=16, workers=4, n_hot=64,
                  epochs=3, seed=42, fanouts=(5, 5), partition="greedy")
    cells = []
    for prof in ("none", "cache-loss", "stage-flaky"):
        cells.append(CellSpec(backend="device", system="rapidgnn",
                              fault_profile=prof,
                              fault_seed=0 if prof == "none"
                              else fault_seed, **common))
    for prof in ("none", "csec-loss", "pull-flaky", "prefetch-flaky"):
        cells.append(CellSpec(backend="host", system="rapidgnn",
                              fault_profile=prof,
                              fault_seed=0 if prof == "none"
                              else fault_seed, **common))
    return CampaignSpec(name="fault", cells=tuple(cells))


def tiny_host_grid(epochs: int = 2) -> CampaignSpec:
    """Host-only tiny pair -- the fast pytest lane's campaign (no
    subprocess, a few seconds end to end)."""
    cells = grid(backends=("host",), systems=("rapidgnn", "dgl-metis"),
                 datasets=("tiny",), batch_sizes=(16,), workers=(4,),
                 n_hots=(64,), epochs=epochs, seed=42, fanouts=(5, 5),
                 partition="greedy")
    return CampaignSpec(name="tiny-host", cells=tuple(cells))
