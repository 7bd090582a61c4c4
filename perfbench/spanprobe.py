"""The program's own spans over one cell, and what its tracer costs.

    python3 perfbench/spanprobe.py --workload <cell> --seed <n> \
        [--pairs 4] [--out <file>]

from the root of a checkout, on the card. Set-up is a benchmark run's
(``harness.CellRun.setup``). Then ``--pairs`` pairs of whole passes of
the job with the program's tracer (``repro_torch.core.trace``) off and
on, in turns (off, on, on, off, ...), each pass's seeds/s. Then the two
traced passes of ``--trace 1``, the tracer on and cleared for each: a
whole pass with the card's activity traced, and ``harness.GAP_EPOCHS``
epochs with the host's operators too. The readers of the span metrics
(``metrics/<name>.json`` below) read a Context that carries the two
exports (``spans``, ``gap_spans``) and the second pass's device trace
(``gap_trace``, ``gap_slice``).

The last line of standard output is one JSON object: the device, the
metrics, ``spans`` (self ms by span name an epoch of the whole pass),
``idle_by_span`` (the card's idle ms an epoch by the innermost span open
on the runner thread, in each traced pass), ``stage_parts_ms``,
``step_ms`` (steps a staging thread's stage overlapped, partly, or
not), the counters, the on/off passes, and an off span site's cost on
this host. Nothing is judged: the benchmark's runs do that.
"""
import sys
import time

T_START = time.perf_counter()
# run as a script, this file's folder heads sys.path: put the checkout
# there instead, so that the benchmark's modules are found as
# ``perfbench.*`` only
_HERE = __import__("os").path.dirname(__import__("os").path.abspath(__file__))
if sys.path and __import__("os").path.abspath(sys.path[0]) == _HERE:
    sys.path[0] = __import__("os").path.dirname(_HERE)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import timeit  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

#: the span metrics, each ``metrics/<name>.json``
METRICS = ("run_prologue_ms", "stage_compile_ms", "stage_hot_set_ms",
           "stage_collate_ms", "step_host_ms", "idle_await_stage_ms",
           "idle_in_step_ms", "h2d_mb_per_kseed")


def traced_passes(run, tracer):
    """The two traced passes of ``harness.CellRun.traced_pass``, the
    program's tracer on and cleared for each. -> (whole-pass export, its
    device trace, gap-pass export, its device trace, its slice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import harness, trace

    r, cuda = run.runner, run.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(run.device)
    try:
        tracer.clear()
        tracer.enable()
        with profile(activities=[ProfilerActivity.CUDA if cuda
                                 else ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            r.run(r.params, r.opt_state, 0, run.E)
            sync()
            wall = time.perf_counter() - t0
        whole = tracer.export()
        whole_trace = trace.collect_device(prof, wall)
        tracer.clear()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            with record_function(trace.SLICE):
                r.run(r.params, r.opt_state, 0,
                      min(harness.GAP_EPOCHS, run.E))
                sync()
        gap = tracer.export()
    finally:
        tracer.disable()
        tracer.clear()
    gap_trace, start, end = trace.collect(prof)
    return whole, whole_trace, gap, gap_trace, (start, end)


def on_off_passes(run, tracer, pairs: int):
    """Whole passes with the tracer off and on in turns -> [[on, s]]."""
    r, out = run.runner, []
    for k in range(2 * pairs):
        on = k % 4 in (1, 2)
        tracer.clear()
        if on:
            tracer.enable()
        t = time.perf_counter()
        r.run(r.params, r.opt_state, 0, run.E)
        out.append([on, time.perf_counter() - t])
        tracer.disable()
    tracer.clear()
    return out


def off_cost_ns(tracer) -> float:
    """One off span site (``with span(...)`` over nothing) less a bare
    call, in ns a call on this host."""
    def site():
        with tracer.span("step.exchange"):
            pass

    def bare():
        pass
    n = 200_000
    t = [min(timeit.repeat(f, number=n, repeat=5)) for f in (site, bare)]
    return (t[0] - t[1]) / n * 1e9


def main(argv=None, device=None) -> int:
    """``device``: None for the card (exits 2 without one); the tests
    pass the CPU for a tiny cell."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from perfbench import run as bench
    bench._environment()

    import torch

    from perfbench import harness, manifest, spans
    from repro_torch.core import trace as tracer

    cell = manifest.load_cell(args.workload, ROOT)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the probe runs on the card",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    run = harness.CellRun(cell, args.seed, device)
    run.setup()
    setup_s = time.perf_counter() - T_START
    passes = on_off_passes(run, tracer, args.pairs)
    gc.unfreeze()
    whole, whole_trace, gap, gap_trace, gap_slice = traced_passes(run,
                                                                  tracer)
    ctx = harness.Context(cell, {}, run.warm, 1.0,
                          run.seeds_per_epoch * len(run.warm), run.summary)
    ctx.spans, ctx.gap_spans = whole, gap
    ctx.gap_trace, ctx.gap_slice = gap_trace, gap_slice
    metrics = {}
    for name in METRICS:
        spec = json.loads((ROOT / "perfbench" / "metrics"
                           / f"{name}.json").read_text())
        metrics[name] = harness.load_reader(ROOT, spec["reader"]).read(
            ctx, spec)

    def epochs(export):
        return sum(s["name"] == "runner.epoch" for s in export["spans"])

    def idle_ms(export, tr, start, end):
        got = spans.idle_by_span(export["spans"], tr.busy_intervals(),
                                 start, end)
        return {k: v / 1e6 / epochs(export)
                for k, v in sorted(got.items(), key=lambda kv: -kv[1])}
    runs = [s for s in whole["spans"] if s["name"] == "runner.run"]
    steps = spans.step_ms_by_overlap(whole["spans"])
    rate = {k: [run.seeds_per_epoch * run.E / s for on, s in passes
                if on == (k == "on")] for k in ("off", "on")}
    out = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "workload": args.workload, "seed": args.seed, "setup_s": setup_s,
        "metrics": metrics,
        "spans": spans.self_ms(whole["spans"], epochs(whole)),
        "idle_by_span": {
            "gap_pass": idle_ms(gap, gap_trace, *gap_slice),
            "whole_pass": idle_ms(whole, whole_trace, runs[0]["start_ns"],
                                  runs[-1]["end_ns"])},
        "busy_s": {"whole_pass": whole_trace.busy_s,
                   "gap_pass": gap_trace.busy_s},
        "stage_parts_ms": spans.stage_parts_ms(whole["spans"]),
        "step_ms": {k: {"n": len(v),
                        "mean": statistics.fmean(v) if v else None,
                        "median": statistics.median(v) if v else None}
                    for k, v in steps.items()},
        "counters": whole["counters"], "gap_counters": gap["counters"],
        "passes_on_off": passes,
        "seeds_per_s": {k: {"median": statistics.median(v), "all": v}
                        for k, v in rate.items()},
        "off_span_site_ns": off_cost_ns(tracer),
    }
    line = json.dumps(out, default=float)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
