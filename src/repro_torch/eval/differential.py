"""Differential verification: the campaign doubles as a correctness
harness (DESIGN.md §7).

Three layers, all operating on serialized ``CellResult`` records (so a
corrupted counter in the artifact is caught exactly like a live one):

  * internal      -- accounting identities within one cell: remote bytes
                     == fetched rows x row bytes, the per-(epoch, worker)
                     miss matrix sums to the scalar counter, device cells
                     compiled exactly once.
  * cross-backend -- host-sim vs device cells of the SAME system +
                     scenario: the device pull-lane miss matrix must
                     equal the host ``cache_misses`` matrix per (epoch,
                     worker) (the ``assert_host_parity`` contract,
                     generalized to every paired cell of a campaign),
                     payload bytes must match, and the rapid cells'
                     VectorPull staging bytes must match.
  * cross-system  -- rapid vs baseline cells of the SAME backend +
                     scenario: identical schedules + exact feature paths
                     imply bit-identical loss curves (the cache is
                     lossless), and rapid may never fetch more than the
                     baseline.
  * cross-topology -- flat vs hierarchical device cells of the SAME
                     system + scenario: the two-tier pull plan is a
                     repartition of the flat one, so miss matrices and
                     loss curves must be BIT-equal and the hierarchical
                     cell's intra + inter bytes must sum to the flat
                     cell's remote bytes exactly (DESIGN.md §6.7).

Every check yields a ``CheckResult``; ``verify_cells`` never raises --
the campaign collects FAILs into the report and the CLI exits non-zero.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.eval.cells import CellResult

PASS, FAIL, SKIP = "PASS", "FAIL", "SKIP"

#: loss agreement only holds between systems sampling identical blocks
#: (gcn uses wider fanouts, dgl-random a different partition -> different
#: schedules); these two share everything but the cache.
LOSS_COMPARABLE = {"rapidgnn", "dgl-metis"}


@dataclasses.dataclass
class CheckResult:
    cell: str                   # label of the (primary) cell checked
    check: str
    status: str                 # PASS | FAIL | SKIP
    detail: str = ""

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


def _label(c: CellResult) -> str:
    s = c.spec
    base = (f"{s['backend']}/{s['system']}/{s['dataset']}"
            f"/b{s['batch_size']}/w{s['workers']}/h{s['n_hot']}"
            f"/e{s['epochs']}")
    if _topology(c) != "flat":
        base += f"/t{s['topology']}"
    if s.get("fault_profile", "none") != "none":
        base += f"/f{s['fault_profile']}"
    return base


def _topology(c: CellResult) -> str:
    return c.spec.get("topology", "flat")


def _scenario(c: CellResult) -> Tuple:
    """EFFECTIVE schedule key (CellSpec.scenario_key): equal keys really
    did consume identical schedules, so dgl-random / gcn cells -- whose
    partition/fanouts differ by design -- never pair with rapidgnn."""
    from repro_torch.eval.spec import CellSpec
    return CellSpec.from_dict(c.spec).scenario_key()


# ---------------------------------------------------------------------------
# layer 1: internal identities
# ---------------------------------------------------------------------------

def check_cell_internal(c: CellResult) -> List[CheckResult]:
    out = []
    name = _label(c)

    want = c.rpc_count * c.row_bytes
    out.append(CheckResult(name, "bytes_identity",
                           PASS if c.remote_bytes == want else FAIL,
                           f"remote_bytes={c.remote_bytes} vs "
                           f"rpc_count*row={want}"))

    msum = int(np.asarray(c.miss_matrix, dtype=np.int64).sum())
    out.append(CheckResult(name, "miss_matrix_sum",
                           PASS if msum == c.cache_misses else FAIL,
                           f"sum(miss_matrix)={msum} vs "
                           f"cache_misses={c.cache_misses}"))

    if c.backend == "device":
        # a degraded (uncached) epoch may widen the pull-lane bound and
        # cost at most ONE extra trace each; non-degraded runs stay at 1
        bound = 1 + c.degraded_epochs
        out.append(CheckResult(
            name, "one_compilation",
            PASS if 1 <= c.trace_count <= bound else FAIL,
            f"trace_count={c.trace_count} (multi-epoch runner must "
            f"compile once, +<=1 per degraded epoch; "
            f"degraded={c.degraded_epochs})"))
        out.append(CheckResult(
            name, "payload_identity",
            PASS if c.payload_bytes == c.cache_misses * c.row_bytes
            else FAIL,
            f"payload_bytes={c.payload_bytes} vs "
            f"lanes*row={c.cache_misses * c.row_bytes}"))
        # request leg: the padded int32 id matrices every pull ships
        # BEFORE the payload comes back (satellite bugfix: previously
        # never accounted anywhere)
        want_req = c.wire_rows * 4
        out.append(CheckResult(
            name, "request_bytes_identity",
            PASS if c.request_bytes == want_req else FAIL,
            f"request_bytes={c.request_bytes} vs "
            f"wire_rows*4={want_req}"))
        # two-tier split: tiers partition the flat counters exactly
        # (flat cells: intra == total, inter == 0)
        tier_ok = (c.intra_misses + c.inter_misses == c.cache_misses
                   and c.intra_bytes + c.inter_bytes == c.remote_bytes
                   and c.intra_wire_rows + c.inter_wire_rows
                   == c.wire_rows)
        out.append(CheckResult(
            name, "tier_sum_identity",
            PASS if tier_ok else FAIL,
            f"intra+inter misses={c.intra_misses}+{c.inter_misses} vs "
            f"{c.cache_misses}, bytes={c.intra_bytes}+{c.inter_bytes} "
            f"vs {c.remote_bytes}, wire={c.intra_wire_rows}+"
            f"{c.inter_wire_rows} vs {c.wire_rows}"))
    return out


# ---------------------------------------------------------------------------
# layer 2: host vs device (same system, same scenario)
# ---------------------------------------------------------------------------

def check_backend_pair(host: CellResult, dev: CellResult
                       ) -> List[CheckResult]:
    out = []
    name = f"{_label(host)} <> {_label(dev)}"
    if host.workers_run != dev.workers_run:
        return [CheckResult(name, "miss_parity", SKIP,
                            f"host ran workers {host.workers_run}, "
                            f"device {dev.workers_run} -- run the host "
                            f"cell with all_workers=True to pair")]

    hm = np.asarray(host.miss_matrix, dtype=np.int64)
    dm = np.asarray(dev.miss_matrix, dtype=np.int64)
    if hm.shape != dm.shape:
        out.append(CheckResult(name, "miss_parity", FAIL,
                               f"shape {hm.shape} vs {dm.shape}"))
    elif not np.array_equal(hm, dm):
        bad = np.argwhere(hm != dm)[:4].tolist()
        out.append(CheckResult(
            name, "miss_parity", FAIL,
            f"device pull-lane counts diverge from host cache_misses "
            f"at (epoch, worker) {bad}"))
    else:
        out.append(CheckResult(name, "miss_parity", PASS,
                               f"{hm.shape[0]}x{hm.shape[1]} matrix "
                               f"equal, total={int(hm.sum())}"))

    out.append(CheckResult(
        name, "payload_bytes",
        PASS if host.remote_bytes == dev.payload_bytes else FAIL,
        f"host remote_bytes={host.remote_bytes} vs device "
        f"payload={dev.payload_bytes}"))

    if host.system == "rapidgnn":
        out.append(CheckResult(
            name, "vector_pull_bytes",
            PASS if host.vector_pull_bytes == dev.vector_pull_bytes
            else FAIL,
            f"host C_s/C_sec staging={host.vector_pull_bytes} vs "
            f"device={dev.vector_pull_bytes}"))
    return out


# ---------------------------------------------------------------------------
# layer 3: rapid vs baseline (same backend, same scenario)
# ---------------------------------------------------------------------------

def check_system_pair(rapid: CellResult, base: CellResult
                      ) -> List[CheckResult]:
    out = []
    name = f"{_label(rapid)} <> {_label(base)}"

    out.append(CheckResult(
        name, "fetch_not_more",
        PASS if rapid.rpc_count <= base.rpc_count else FAIL,
        f"rapid fetches {rapid.rpc_count} vs baseline "
        f"{base.rpc_count}"))

    if (base.system in LOSS_COMPARABLE and rapid.spec["train"]
            and base.spec["train"]):
        rl, bl = np.asarray(rapid.losses), np.asarray(base.losses)
        if rl.shape != bl.shape:
            out.append(CheckResult(name, "loss_agreement", FAIL,
                                   f"curve lengths {rl.shape} vs "
                                   f"{bl.shape}"))
        elif not np.allclose(rl, bl, rtol=1e-4, atol=1e-5):
            i = int(np.argmax(np.abs(rl - bl)))
            out.append(CheckResult(
                name, "loss_agreement", FAIL,
                f"curves diverge at step {i}: {rl[i]:.6f} vs "
                f"{bl[i]:.6f} (cache must be lossless)"))
        else:
            out.append(CheckResult(name, "loss_agreement", PASS,
                                   f"{rl.shape[0]} steps agree"))
    return out


# ---------------------------------------------------------------------------
# layer 3b: flat vs hierarchical topology (same system, same scenario)
# ---------------------------------------------------------------------------

def check_topology_pair(flat: CellResult, hier: CellResult
                        ) -> List[CheckResult]:
    """Two-tier exchange vs its flat twin: the hierarchical plan is a
    bit-exact repartition of the flat one (verified empirically for the
    all_to_all semantics, pinned here for whole campaigns): same misses,
    same losses, and the tier bytes sum to the flat payload exactly."""
    out = []
    name = f"{_label(flat)} <> {_label(hier)}"

    fm = np.asarray(flat.miss_matrix, dtype=np.int64)
    hm = np.asarray(hier.miss_matrix, dtype=np.int64)
    if fm.shape != hm.shape or not np.array_equal(fm, hm):
        out.append(CheckResult(
            name, "topology_miss_parity", FAIL,
            f"hierarchical miss matrix diverges from flat "
            f"(flat total={int(fm.sum())}, hier total={int(hm.sum())})"))
    else:
        out.append(CheckResult(name, "topology_miss_parity", PASS,
                               f"{fm.shape[0]}x{fm.shape[1]} matrix "
                               f"equal, total={int(fm.sum())}"))

    tier_sum = hier.intra_bytes + hier.inter_bytes
    out.append(CheckResult(
        name, "topology_byte_sum",
        PASS if tier_sum == flat.remote_bytes else FAIL,
        f"intra+inter={hier.intra_bytes}+{hier.inter_bytes}={tier_sum} "
        f"vs flat remote_bytes={flat.remote_bytes}"))

    fl, hl = np.asarray(flat.losses), np.asarray(hier.losses)
    if fl.shape != hl.shape:
        out.append(CheckResult(name, "topology_loss_parity", FAIL,
                               f"curve lengths {fl.shape} vs "
                               f"{hl.shape}"))
    elif not np.array_equal(fl, hl):
        i = int(np.argmax(fl != hl))
        out.append(CheckResult(
            name, "topology_loss_parity", FAIL,
            f"curves diverge at step {i}: {fl[i]!r} vs {hl[i]!r} "
            f"(two-tier exchange must be bit-equal to flat)"))
    else:
        out.append(CheckResult(name, "topology_loss_parity", PASS,
                               f"{fl.shape[0]} steps bit-equal"))
    return out


# ---------------------------------------------------------------------------
# layer 4: faulted vs clean twin (same backend+system, fault neutralized)
# ---------------------------------------------------------------------------

def verify_fault_pairs(cells: Sequence[CellResult]) -> List[CheckResult]:
    """Recovery verification for the fault campaign: each faulted cell
    must (a) actually have fired its injections, (b) end with a loss
    curve BIT-equal to its clean twin (every tolerated fault recovers
    losslessly -- DESIGN.md §10), and (c) on the device backend keep
    non-degraded epochs' pull-lane rows identical to the clean cell's
    (degraded epochs legitimately pull more)."""
    from repro_torch.eval.spec import CellSpec

    out: List[CheckResult] = []
    groups: Dict[Tuple, Dict[str, CellResult]] = {}
    for c in cells:
        spec = CellSpec.from_dict(c.spec)
        neutral = dataclasses.replace(spec, fault_profile="none",
                                      fault_seed=0)
        groups.setdefault((c.backend, c.system, neutral.scenario_key()),
                          {})[spec.fault_profile] = c

    for (_be, _sy, _key), group in sorted(groups.items(),
                                          key=lambda kv: str(kv[0])):
        clean = group.get("none")
        for prof in sorted(group):
            if prof == "none":
                continue
            c = group[prof]
            name = _label(c)
            out.append(CheckResult(
                name, "fault_fired",
                PASS if c.fault_events > 0 else FAIL,
                f"fault_events={c.fault_events} (profile {prof!r} must "
                f"actually inject)"))
            if clean is None:
                out.append(CheckResult(name, "fault_loss_parity", SKIP,
                                       "no clean twin cell in campaign"))
                continue
            fl = np.asarray(c.losses)
            cl = np.asarray(clean.losses)
            if fl.shape != cl.shape:
                out.append(CheckResult(
                    name, "fault_loss_parity", FAIL,
                    f"curve lengths {fl.shape} vs clean {cl.shape}"))
            elif not np.array_equal(fl, cl):
                i = int(np.argmax(fl != cl))
                out.append(CheckResult(
                    name, "fault_loss_parity", FAIL,
                    f"recovered curve diverges from clean at step {i}: "
                    f"{fl[i]!r} vs {cl[i]!r} (recovery must be "
                    f"bit-exact)"))
            else:
                out.append(CheckResult(
                    name, "fault_loss_parity", PASS,
                    f"{fl.shape[0]} steps bit-equal under {prof!r}"))
            if c.backend == "device":
                flags = [int(em.get("degraded", 0))
                         for em in c.epoch_metrics]
                fm = np.asarray(c.miss_matrix, np.int64)
                cm = np.asarray(clean.miss_matrix, np.int64)
                keep = [e for e, d in enumerate(flags) if not d]
                ok = (fm.shape == cm.shape
                      and np.array_equal(fm[keep], cm[keep]))
                out.append(CheckResult(
                    name, "fault_miss_parity",
                    PASS if ok else FAIL,
                    f"non-degraded epochs {keep}: pull lanes "
                    f"{'equal clean' if ok else 'diverge from clean'}"))
    return out


# ---------------------------------------------------------------------------
# campaign-level entry point
# ---------------------------------------------------------------------------

def verify_cells(cells: Sequence[CellResult]) -> List[CheckResult]:
    """All applicable checks over a campaign's cells. Pairings are
    derived from the specs: equal scenario + system across backends,
    equal scenario + backend across systems."""
    out: List[CheckResult] = []
    for c in cells:
        out.extend(check_cell_internal(c))

    # topology is part of every grouping key: a hierarchical device cell
    # shares its scenario key with its flat twin BY DESIGN (identical
    # schedules), so keying on scenario alone would silently overwrite
    # one of them and drop its checks
    by_sys: Dict[Tuple, Dict[str, CellResult]] = {}
    by_backend: Dict[Tuple, Dict[str, CellResult]] = {}
    by_topo: Dict[Tuple, Dict[str, CellResult]] = {}
    for c in cells:
        topo = _topology(c)
        by_sys.setdefault((_scenario(c), c.system, topo),
                          {})[c.backend] = c
        by_backend.setdefault((_scenario(c), c.backend, topo),
                              {})[c.system] = c
        if c.backend == "device":
            by_topo.setdefault((_scenario(c), c.system), {})[topo] = c

    for group in by_sys.values():
        if "host" in group and "device" in group:
            out.extend(check_backend_pair(group["host"],
                                          group["device"]))
    for group in by_backend.values():
        rapid = group.get("rapidgnn")
        if rapid is None:
            continue
        for sysname, cell in sorted(group.items()):
            if sysname != "rapidgnn":
                out.extend(check_system_pair(rapid, cell))
    for group in by_topo.values():
        flat = group.get("flat")
        if flat is None:
            continue
        for topo, cell in sorted(group.items()):
            if topo != "flat":
                out.extend(check_topology_pair(flat, cell))
    return out


def all_pass(checks: Sequence[CheckResult]) -> bool:
    return all(c.status != FAIL for c in checks)


def failures(checks: Sequence[CheckResult]) -> List[CheckResult]:
    return [c for c in checks if c.status == FAIL]
