"""Paper-metrics campaign runner + CLI (the port of
``repro/eval/campaign.py``).

``python -m repro_torch.eval.campaign --fast``   -- the paired grid:
host-sim AND device runners over the tiny graph, every host/device and
rapid/baseline pair differentially verified in-line, headline ratios
(throughput speedup, fetch reduction, modelled energy) derived per
pair, everything written to ``artifacts/BENCH_torch_paper.json``.

``--device`` picks the torch device every cell trains on: ``cuda`` (the
default; raises without a card) or ``cpu``. Device cells run in this
process, their P workers sharing that one device.
``--full`` swaps in the paper-scale host grid (Tables 2/3 axes; slow).
``--host-only`` skips the device cells.
``--loop-sampler`` swaps every cell's schedule path to the per-batch
oracle (``build_schedule(compiler="loop")``); the default is the
vectorized epoch-at-once compiler -- schedules are bit-identical either
way, so all differential checks must pass under both.
``--schedule-backend device`` swaps every cell to the device schedule
compiler (the ``seg_sort`` kernel; device cells also go lazy, rebuilt
by the runners' staging thread) -- same bit-parity contract, same
all-checks-pass bar.
``--inject-miscount`` perturbs one cell's counters AFTER measurement --
the differential layer must then fail and the CLI exit non-zero; this
is the self-test proving the checks have teeth.
``--fault`` runs the fault campaign instead
(``artifacts/BENCH_torch_fault.json``).

The artifacts carry the reference's schema strings, so one validator
reads both packages' reports; their default names differ from the
reference's so neither package overwrites the other's.

Exit code: 0 iff every differential check passes.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, List, Optional

from repro_torch.device import resolve_device
from repro_torch.eval.spec import CampaignSpec, fast_grid, fault_grid, full_grid
from repro_torch.eval.cells import CellResult, run_host_cell, run_device_cells
from repro_torch.eval.differential import verify_cells, verify_fault_pairs
from repro_torch.eval.report import (build_fault_report, build_report,
                                     validate_fault_report, write_report)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_OUT = os.path.join(ROOT, "artifacts", "BENCH_torch_paper.json")
FAULT_OUT = os.path.join(ROOT, "artifacts", "BENCH_torch_fault.json")


def run_campaign(spec: CampaignSpec, include_device: bool = True,
                 out_path: Optional[str] = None,
                 log: Callable[[str], None] = lambda s: None,
                 mutate_cells: Optional[Callable[[List[CellResult]],
                                                 None]] = None,
                 device=None) -> dict:
    """Run every cell on ``device``, verify, derive ratios, optionally
    write the artifact. ``mutate_cells`` is the injection hook: it edits
    the measured cells before verification (tests + ``--inject-
    miscount`` use it to prove a perturbed counter is caught)."""
    device = resolve_device(device)
    cells: List[CellResult] = []
    for c in spec.host_cells():
        log(f"[cell] {c.label()} ...")
        cells.append(run_host_cell(c, device=device))
        log(f"[cell] {c.label()} done: "
            f"step={cells[-1].step_time_ms:.2f}ms "
            f"rpc={cells[-1].rpc_count}")
    dev = spec.device_cells()
    if dev and include_device:
        log(f"[cell] {len(dev)} device cell(s) on {device} ...")
        cells.extend(run_device_cells(dev, device=device))
        for c in cells[-len(dev):]:
            log(f"[cell] {c.spec['backend']}/{c.spec['system']} done: "
                f"step={c.step_time_ms:.2f}ms lanes={c.rpc_count}")
    if mutate_cells is not None:
        mutate_cells(cells)
    checks = verify_cells(cells)
    report = build_report(spec.name, cells, checks)
    if out_path:
        write_report(report, out_path)
        log(f"[out] {out_path}")
    return report


def run_fault_campaign(include_device: bool = True,
                       out_path: Optional[str] = None,
                       log: Callable[[str], None] = lambda s: None,
                       device=None) -> dict:
    """The fault campaign: the fast-grid rapidgnn scenario re-run under
    named fault profiles, each injection verified to (a) fire and (b)
    recover bit-exactly against its clean twin."""
    device = resolve_device(device)
    spec = fault_grid()
    cells: List[CellResult] = []
    for c in spec.host_cells():
        log(f"[cell] {c.label()} ...")
        cells.append(run_host_cell(c, device=device))
        log(f"[cell] {c.label()} done: fires={cells[-1].fault_events} "
            f"degraded={cells[-1].degraded_epochs}")
    dev = spec.device_cells()
    if dev and include_device:
        log(f"[cell] {len(dev)} device cell(s) on {device} ...")
        cells.extend(run_device_cells(dev, device=device))
        for c in cells[-len(dev):]:
            log(f"[cell] {c.spec['backend']}/"
                f"{c.spec.get('fault_profile', 'none')} done: "
                f"fires={c.fault_events} degraded={c.degraded_epochs} "
                f"retries={c.stage_retries}")
    checks = verify_cells(cells) + verify_fault_pairs(cells)
    report = build_fault_report(spec.name, cells, checks)
    if out_path:
        write_report(report, out_path)
        log(f"[out] {out_path}")
    return report


def _print_checks(report: dict) -> None:
    n_fail = sum(1 for c in report["differential"]
                 if c["status"] == "FAIL")
    n_pass = sum(1 for c in report["differential"]
                 if c["status"] == "PASS")
    print(f"differential: {n_pass} passed, {n_fail} failed")
    for c in report["differential"]:
        if c["status"] == "FAIL":
            print(f"  FAIL {c['check']} @ {c['cell']}: {c['detail']}")


def _print_fault_report(report: dict) -> None:
    print(f"campaign={report['campaign']} cells={report['num_cells']}")
    for r in report["fault_summary"]:
        print(f"  {r['backend']:6s} f={r['fault_profile']:15s} "
              f"fires={r['fault_events']} degraded={r['degraded_epochs']} "
              f"retries={r['retry_total']} "
              f"recovery_wall={r['recovery_wall_s']}s")
    _print_checks(report)


def _print_report(report: dict) -> None:
    print(f"campaign={report['campaign']} cells={report['num_cells']} "
          f"pairs={len(report['pairs'])}")
    for p in report["pairs"]:
        sc = p["scenario"]
        print(f"  {p['backend']:6s} rapid vs {p['baseline_system']:10s} "
              f"{sc['dataset']}/b{sc['batch_size']}: "
              f"speedup={p['throughput_speedup']}x "
              f"fetch_reduction={p['fetch_reduction_x']}x "
              f"modelled energy_total_ratio={p['energy']['total_ratio']}")
    _print_checks(report)


def _inject_miscount(cells: List[CellResult]) -> None:
    """Perturb one measured counter (the self-test of the checks)."""
    c = cells[0]
    c.rpc_count += 1
    if c.miss_matrix and c.miss_matrix[0]:
        c.miss_matrix[0][0] += 1
    print(f"[inject] perturbed counters of "
          f"{c.spec['backend']}/{c.spec['system']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="RapidGNN paper-metrics campaign (PyTorch port)")
    ap.add_argument("--fast", action="store_true",
                    help="the paired tiny-graph grid (default)")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale host grid + device pair (slow)")
    ap.add_argument("--host-only", action="store_true",
                    help="skip device-backend cells")
    ap.add_argument("--fault", action="store_true",
                    help="run the fault-injection campaign instead "
                         "(artifacts/BENCH_torch_fault.json)")
    ap.add_argument("--loop-sampler", action="store_true",
                    help="build schedules with the per-batch oracle "
                         "sampler instead of the batched compiler")
    ap.add_argument("--schedule-backend", choices=("numpy", "device"),
                    default="numpy",
                    help="where schedules compile: numpy (default) or "
                         "the device compiler (seg_sort kernel)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="artifact path (default artifacts/"
                         "BENCH_torch_paper.json)")
    ap.add_argument("--inject-miscount", action="store_true",
                    help="perturb one cell's counters post-measurement; "
                         "differential checks must fail")
    ap.add_argument("--device", default="cuda",
                    help="torch device every cell trains on (cuda | cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    if args.fault:
        out = (args.out if args.out != DEFAULT_OUT else FAULT_OUT)
        report = run_fault_campaign(include_device=not args.host_only,
                                    out_path=out, log=print, device=device)
        _print_fault_report(report)
        probs = validate_fault_report(report)
        for p in probs:
            print(f"  INVALID: {p}")
        if not report["all_checks_pass"]:
            print("recovery FAILED: fault campaign checks did not pass")
        return 0 if report["all_checks_pass"] and not probs else 1

    spec = full_grid() if args.full else fast_grid()
    if args.loop_sampler:
        spec = CampaignSpec(
            name=f"{spec.name}-loop",
            cells=tuple(dataclasses.replace(c, schedule_compiler="loop")
                        for c in spec.cells))
    if args.schedule_backend != "numpy":
        spec = CampaignSpec(
            name=f"{spec.name}-{args.schedule_backend}",
            cells=tuple(dataclasses.replace(
                c, schedule_backend=args.schedule_backend)
                for c in spec.cells))
    report = run_campaign(
        spec, include_device=not args.host_only, out_path=args.out,
        log=print,
        mutate_cells=_inject_miscount if args.inject_miscount else None,
        device=device)
    _print_report(report)
    return 0 if report["all_checks_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
