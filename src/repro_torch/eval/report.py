"""Headline-ratio derivation + the ``BENCH_paper.json`` schema.

Mapping to the paper (see DESIGN.md §7):

  * ``throughput_speedup``   -> Table 2 (2.46-3.00x end-to-end);
                                baseline step time / rapid step time,
                                both warm (epoch 0 excluded).
  * ``fetch_reduction_x``    -> §5.3 headline (9.70-15.39x fewer remote
                                fetches); baseline fetched rows / rapid
                                residual-miss rows.
  * ``bytes_reduction_x``    -> Fig. 4 (mean data per step); includes
                                rapid's off-critical-path VectorPull
                                staging bytes, so the cache is charged
                                for its own fills.
  * ``energy``               -> Table 3 (44 % CPU / 32 % GPU savings);
                                modelled E = P_mean x warm duration with
                                the paper's measured power envelopes.

Ratios are derived per (backend, grid-scenario) pair of cells -- rapid
vs each baseline system of that grid point. dgl-random and gcn run a
DIFFERENT schedule by definition (random partition / 50,50 fanouts,
recorded per pair as ``baseline_partition``/``baseline_fanouts``);
schedule-identical comparison is the differential layer's domain
(``repro_torch.eval.differential``, keyed by ``CellSpec.scenario_key``).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Sequence

from repro_torch.eval.cells import CellResult
from repro_torch.eval.differential import CheckResult, all_pass

#: v2 adds the fault/degradation counters (degraded_epochs, retry
#: totals, recovery_wall_s, fault_events) to every cell record.
SCHEMA = "rapidgnn.bench_paper/v2"
#: BENCH_fault.json: the fault campaign's recovery scorecard.
FAULT_SCHEMA = "rapidgnn.bench_fault/v1"
#: BENCH_serve.json: online-serving latency under clean vs fault lanes.
SERVE_SCHEMA = "rapidgnn.bench_serve/v1"

#: the paper's headline claims, pinned so readers of the artifact can
#: compare without the PDF (ranges are across its dataset grid).
PAPER_TARGETS = {
    "throughput_speedup": [2.46, 3.00],
    "fetch_reduction_x": [9.70, 15.39],
    "cpu_energy_saving": 0.44,
    "gpu_energy_saving": 0.32,
}

_REQUIRED_CELL_FIELDS = (
    "spec", "feat_dim", "num_steps", "warm_steps", "wall_time_s",
    "warm_wall_s", "step_time_ms", "rpc_count", "remote_bytes",
    "vector_pull_bytes", "payload_bytes", "miss_matrix", "losses",
    "energy", "hit_rate",
    # v2: fault/degradation counters
    "degraded_epochs", "stage_retries", "pull_retries",
    "prefetch_retries", "recovery_wall_s", "fault_events")
_REQUIRED_PAIR_FIELDS = (
    "backend", "baseline_system", "scenario", "throughput_speedup",
    "fetch_reduction_x", "bytes_reduction_x", "energy")


def _scenario_dict(c: CellResult) -> Dict:
    s = c.spec
    d = {k: s[k] for k in ("dataset", "batch_size", "workers",
                           "n_hot", "epochs", "seed", "fanouts",
                           "partition")}
    d["topology"] = s.get("topology", "flat")
    return d


def derive_pair(rapid: CellResult, base: CellResult) -> Dict:
    """Headline ratios for one rapid-vs-baseline cell pair.

    Ratio pairing is GRID-level (paper Table 2 compares systems, not
    schedules): dgl-random and gcn intentionally run a different
    partition / fanouts, recorded as ``baseline_partition`` /
    ``baseline_fanouts`` so the scenario block (the rapid cell's
    schedule) is never read as shared. Schedule-identical pairing is
    the differential layer's job (``CellSpec.scenario_key``)."""
    from repro_torch.eval.spec import CellSpec

    r_bytes = rapid.remote_bytes + rapid.vector_pull_bytes
    b_bytes = base.remote_bytes + base.vector_pull_bytes
    er, eb = rapid.energy, base.energy
    bspec = CellSpec.from_dict(base.spec)
    return {
        "backend": rapid.backend,
        "baseline_system": base.system,
        "baseline_partition": bspec.partition_method,
        "baseline_fanouts": list(bspec.effective_fanouts),
        "scenario": _scenario_dict(rapid),
        "throughput_speedup": round(
            base.step_time_ms / max(rapid.step_time_ms, 1e-9), 4),
        "fetch_reduction_x": round(
            base.rpc_count / max(rapid.rpc_count, 1), 4),
        "bytes_reduction_x": round(b_bytes / max(r_bytes, 1), 4),
        "net_time_speedup": round(
            base.warm_sync_net_time_s /
            max(rapid.warm_sync_net_time_s, 1e-9), 4)
        if base.warm_sync_net_time_s else None,
        "energy": {
            "cpu_ratio": round(er["cpu_J"] / max(eb["cpu_J"], 1e-9), 4),
            "gpu_ratio": round(er["gpu_J"] / max(eb["gpu_J"], 1e-9), 4),
            "total_ratio": round(
                er["total_J"] / max(eb["total_J"], 1e-9), 4),
            "cpu_saving": round(
                1.0 - er["cpu_J"] / max(eb["cpu_J"], 1e-9), 4),
            "gpu_saving": round(
                1.0 - er["gpu_J"] / max(eb["gpu_J"], 1e-9), 4),
        },
    }


def derive_pairs(cells: Sequence[CellResult]) -> List[Dict]:
    groups: Dict[tuple, Dict[str, CellResult]] = {}
    for c in cells:
        s = c.spec
        # topology is in the key: a hierarchical device cell must pair
        # with the hierarchical baseline, not overwrite the flat one
        key = (c.backend, s["dataset"], s["batch_size"], s["workers"],
               s["n_hot"], s["epochs"], s["seed"], tuple(s["fanouts"]),
               s["partition"], s.get("topology", "flat"))
        groups.setdefault(key, {})[c.system] = c
    out = []
    for _, group in sorted(groups.items(), key=lambda kv: str(kv[0])):
        rapid = group.get("rapidgnn")
        if rapid is None:
            continue
        for sysname in sorted(group):
            if sysname != "rapidgnn":
                out.append(derive_pair(rapid, group[sysname]))
    return out


def build_report(campaign: str, cells: Sequence[CellResult],
                 checks: Sequence[CheckResult]) -> Dict:
    return {
        "schema": SCHEMA,
        "campaign": campaign,
        "created_unix": time.time(),
        "paper_targets": PAPER_TARGETS,
        "num_cells": len(cells),
        "cells": [c.to_dict() for c in cells],
        "pairs": derive_pairs(cells),
        "differential": [c.to_dict() for c in checks],
        "all_checks_pass": all_pass(checks),
    }


def build_fault_report(campaign: str, cells: Sequence[CellResult],
                       checks: Sequence[CheckResult]) -> Dict:
    """BENCH_fault.json: per-cell recovery scorecard + the differential
    checks (including the ``fault_*`` recovery layer). No headline
    pairs -- the fault grid is rapidgnn-only by construction."""
    rows = []
    for c in cells:
        s = c.spec
        rows.append({
            "cell": f"{c.backend}/{s.get('fault_profile', 'none')}",
            "backend": c.backend,
            "fault_profile": s.get("fault_profile", "none"),
            "fault_seed": s.get("fault_seed", 0),
            "fault_events": c.fault_events,
            "degraded_epochs": c.degraded_epochs,
            "stage_retries": c.stage_retries,
            "pull_retries": c.pull_retries,
            "prefetch_retries": c.prefetch_retries,
            "csec_degraded": c.csec_degraded,
            "spill_rebuilds": c.spill_rebuilds,
            "deadline_overruns": c.deadline_overruns,
            "recovery_wall_s": round(c.recovery_wall_s, 6),
            "retry_total": (c.stage_retries + c.pull_retries
                            + c.prefetch_retries),
        })
    return {
        "schema": FAULT_SCHEMA,
        "campaign": campaign,
        "created_unix": time.time(),
        "num_cells": len(cells),
        "cells": [c.to_dict() for c in cells],
        "fault_summary": rows,
        "differential": [c.to_dict() for c in checks],
        "all_checks_pass": all_pass(checks),
    }


def validate_fault_report(report: Dict) -> List[str]:
    """Schema check for BENCH_fault.json. Beyond shape, enforces the
    campaign's reason to exist: at least one cell must have actually
    DEGRADED and recovered (a fault grid where nothing fires proves
    nothing)."""
    probs: List[str] = []
    for key in ("schema", "campaign", "num_cells", "cells",
                "fault_summary", "differential", "all_checks_pass"):
        if key not in report:
            probs.append(f"missing top-level key {key!r}")
    if probs:
        return probs
    if report["schema"] != FAULT_SCHEMA:
        probs.append(f"schema {report['schema']!r} != {FAULT_SCHEMA!r}")
    if report["num_cells"] != len(report["cells"]):
        probs.append("num_cells does not match len(cells)")
    for i, cell in enumerate(report["cells"]):
        for f in _REQUIRED_CELL_FIELDS:
            if f not in cell:
                probs.append(f"cells[{i}] missing {f!r}")
    for i, row in enumerate(report["fault_summary"]):
        for f in ("fault_profile", "fault_events", "degraded_epochs",
                  "retry_total", "recovery_wall_s"):
            if f not in row:
                probs.append(f"fault_summary[{i}] missing {f!r}")
    faulted = [r for r in report["fault_summary"]
               if r.get("fault_profile", "none") != "none"]
    if not faulted:
        probs.append("no faulted cells in the fault campaign")
    if not any(r.get("fault_events", 0) > 0 for r in faulted):
        probs.append("no fault actually fired across the campaign")
    if not any(r.get("degraded_epochs", 0) > 0
               for r in report["fault_summary"]):
        probs.append("no cell degraded an epoch -- the campaign must "
                     "exercise at least one degraded recovery")
    for i, chk in enumerate(report["differential"]):
        if chk.get("status") not in ("PASS", "FAIL", "SKIP"):
            probs.append(f"differential[{i}] bad status "
                         f"{chk.get('status')!r}")
    return probs


_REQUIRED_LANE_FIELDS = (
    "lane", "fault_profile", "requests", "served", "shed", "errors",
    "latency_ms", "health")


def build_serve_report(config: Dict, lanes: Sequence[Dict],
                       ratio_bound: float = 5.0) -> Dict:
    """BENCH_serve.json: p50/p99 serving latency per lane (clean vs
    fault-injected) plus the degradation-bound verdict. The fault lane
    may shed or degrade, but its p99 must stay within ``ratio_bound``x
    of the clean lane's -- the serving tier's 'graceful, not cliff'
    contract (DESIGN.md §11)."""
    clean = [r for r in lanes if r["fault_profile"] == "none"]
    fault = [r for r in lanes if r["fault_profile"] != "none"]
    clean_p99 = min(r["latency_ms"]["p99"] for r in clean)
    worst_p99 = max(r["latency_ms"]["p99"] for r in fault)
    ratio = worst_p99 / max(clean_p99, 1e-9)
    return {
        "schema": SERVE_SCHEMA,
        "created_unix": time.time(),
        "config": dict(config),
        "lanes": [dict(r) for r in lanes],
        "p99_ratio": round(ratio, 3),
        "ratio_bound": ratio_bound,
        "ok": bool(ratio <= ratio_bound),
    }


def validate_serve_report(report: Dict) -> List[str]:
    """Schema check for BENCH_serve.json. Beyond shape, enforces the
    bench's reason to exist: a clean lane AND at least one faulted lane
    that actually served traffic, every lane on a single XLA trace, and
    an ``ok`` verdict consistent with the recorded ratio."""
    probs: List[str] = []
    for key in ("schema", "config", "lanes", "p99_ratio", "ratio_bound",
                "ok"):
        if key not in report:
            probs.append(f"missing top-level key {key!r}")
    if probs:
        return probs
    if report["schema"] != SERVE_SCHEMA:
        probs.append(f"schema {report['schema']!r} != {SERVE_SCHEMA!r}")
    for i, lane in enumerate(report["lanes"]):
        for f in _REQUIRED_LANE_FIELDS:
            if f not in lane:
                probs.append(f"lanes[{i}] missing {f!r}")
        lat = lane.get("latency_ms", {})
        for f in ("p50", "p99", "mean"):
            if f not in lat:
                probs.append(f"lanes[{i}].latency_ms missing {f!r}")
        if {"p50", "p99"} <= set(lat) and lat["p50"] > lat["p99"]:
            probs.append(f"lanes[{i}] p50 > p99")
        if lane.get("served", 0) <= 0:
            probs.append(f"lanes[{i}] served no requests")
        if lane.get("health", {}).get("trace_count") != 1:
            probs.append(f"lanes[{i}] trace_count != 1 -- the static "
                         "collation contract broke (retrace)")
    lanes = report["lanes"]
    if not any(r.get("fault_profile") == "none" for r in lanes):
        probs.append("no clean lane")
    if not any(r.get("fault_profile", "none") != "none" for r in lanes):
        probs.append("no fault lane -- the bench must exercise serving "
                     "under an active fault plan")
    if report["ok"] != (report["p99_ratio"] <= report["ratio_bound"]):
        probs.append("ok verdict inconsistent with p99_ratio vs bound")
    return probs


def write_report(report: Dict, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    return path


def validate_report(report: Dict) -> List[str]:
    """Schema check for BENCH_paper.json; returns a list of problems
    (empty == valid). Used by tests and by CI before upload."""
    probs: List[str] = []
    for key in ("schema", "campaign", "paper_targets", "num_cells",
                "cells", "pairs", "differential", "all_checks_pass"):
        if key not in report:
            probs.append(f"missing top-level key {key!r}")
    if probs:
        return probs
    if report["schema"] != SCHEMA:
        probs.append(f"schema {report['schema']!r} != {SCHEMA!r}")
    if report["num_cells"] != len(report["cells"]):
        probs.append("num_cells does not match len(cells)")
    for i, cell in enumerate(report["cells"]):
        for f in _REQUIRED_CELL_FIELDS:
            if f not in cell:
                probs.append(f"cells[{i}] missing {f!r}")
    if not report["pairs"]:
        probs.append("no rapid-vs-baseline pairs derived")
    for i, pair in enumerate(report["pairs"]):
        for f in _REQUIRED_PAIR_FIELDS:
            if f not in pair:
                probs.append(f"pairs[{i}] missing {f!r}")
        en = pair.get("energy", {})
        for f in ("cpu_ratio", "gpu_ratio", "total_ratio"):
            if f not in en:
                probs.append(f"pairs[{i}].energy missing {f!r}")
    for i, chk in enumerate(report["differential"]):
        if chk.get("status") not in ("PASS", "FAIL", "SKIP"):
            probs.append(f"differential[{i}] bad status "
                         f"{chk.get('status')!r}")
    return probs
