"""Paper-metrics campaign subsystem (DESIGN.md §7), the port of
``repro.eval``.

One evaluation pipeline: declarative ``CampaignSpec`` grids sweep
{host-sim, device} x {rapid, baseline} x scenario cells into a unified
``CellResult`` schema, derive the paper's headline ratios (throughput
speedup, remote-fetch reduction, modelled CPU/GPU energy), and
differentially verify every paired cell -- host miss counters vs device
pull lanes, byte accounting, loss-curve agreement -- so the benchmark
campaign doubles as a system-level correctness harness. ``spec``,
``differential``, ``report`` and ``replay`` are copies of the
reference's numpy modules; ``cells`` and ``campaign`` run on torch.

Entry point: ``python -m repro_torch.eval.campaign --fast`` (``--device
cpu`` without a card); artifact: ``artifacts/BENCH_torch_paper.json``.
"""
from repro_torch.eval.spec import (CellSpec, CampaignSpec, grid, fast_grid,
                                   fault_grid, full_grid, tiny_host_grid,
                                   HOST_SYSTEMS, DEVICE_SYSTEMS)
from repro_torch.eval.cells import (CellResult, run_host_cell,
                                    run_device_cells, device_cell_result)
from repro_torch.eval.differential import (CheckResult, verify_cells,
                                           verify_fault_pairs,
                                           check_cell_internal,
                                           check_backend_pair,
                                           check_system_pair, all_pass,
                                           failures)
from repro_torch.eval.report import (SCHEMA, FAULT_SCHEMA, PAPER_TARGETS,
                                     derive_pair, derive_pairs, build_report,
                                     build_fault_report, write_report,
                                     validate_report, validate_fault_report)
from repro_torch.eval.replay import replay_device_bytes
# NOTE: repro_torch.eval.campaign (the CLI + run_campaign) is
# intentionally NOT imported here: `python -m repro_torch.eval.campaign`
# would otherwise re-import it under two names (runpy RuntimeWarning).

__all__ = [
    "CellSpec", "CampaignSpec", "grid", "fast_grid", "fault_grid",
    "full_grid", "tiny_host_grid", "HOST_SYSTEMS", "DEVICE_SYSTEMS",
    "CellResult", "run_host_cell", "run_device_cells",
    "device_cell_result",
    "CheckResult", "verify_cells", "verify_fault_pairs",
    "check_cell_internal", "check_backend_pair", "check_system_pair",
    "all_pass", "failures",
    "SCHEMA", "FAULT_SCHEMA", "PAPER_TARGETS", "derive_pair",
    "derive_pairs", "build_report", "build_fault_report",
    "write_report", "validate_report", "validate_fault_report",
    "replay_device_bytes",
]
