"""Where a cell's rate swings: one process sets a cell up once, then
measures slices of whole passes of the job in turns under host
conditions, each slice beside the host's readings (``hostinfo``).

    python3 perfbench/host_ab.py --workload <cell> --seed <n> \
        [--slice-seconds 8] [--reps 3] [--conds base,pin_cores,...]

Conditions: ``base`` (as a run), ``pin_cores`` (every thread of the
process on one logical CPU of each physical core), ``pin2`` (on the
first two), ``pin1`` (on the first), ``switch`` (the interpreter's
thread switch interval at 0.5 ms), ``threads`` (PyTorch's intra-op
threads at the CPU count). With ``--cap`` every library gets one
thread (``OMP_NUM_THREADS`` and its kin at 1); a run leaves them be.
One JSON line a slice; the benchmark's runs do not use this.
"""
import sys
import time

_HERE = __import__("os").path.dirname(__import__("os").path.abspath(__file__))
if sys.path and __import__("os").path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(_HERE).parent))


def _set_affinity(cpus) -> None:
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except OSError:
            pass        # a thread that ended meanwhile


def _one_per_core(cpus):
    seen, out = set(), []
    for c in sorted(cpus):
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/"
                      "thread_siblings_list") as f:
                sib = f.read().strip()
        except OSError:
            sib = str(c)
        if sib not in seen:
            seen.add(sib)
            out.append(c)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--slice-seconds", type=float, default=8.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--conds", default="base,pin_cores,pin2,switch,threads")
    ap.add_argument("--cap", action="store_true")
    args = ap.parse_args()
    from perfbench import run as run_mod
    run_mod._environment()
    if args.cap:
        for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                  "OPENBLAS_NUM_THREADS"):
            os.environ[k] = "1"
    import torch

    import repro_torch  # noqa: F401
    from perfbench import harness, hostinfo, manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = manifest.load_cell(args.workload, run_mod.ROOT)
    run = harness.CellRun(cell, args.seed, dev)
    run.setup()
    all_cpus = sorted(os.sched_getaffinity(0))
    cores = _one_per_core(all_cpus)
    print(json.dumps({"layout": hostinfo.layout(), "cores": cores,
                      "threads": torch.get_num_threads(),
                      "cap": args.cap}), flush=True)
    n0 = torch.get_num_threads()
    sw0 = sys.getswitchinterval()
    apply = {"base": lambda: None,
             "pin_cores": lambda: _set_affinity(cores),
             "pin2": lambda: _set_affinity(cores[:2]),
             "pin1": lambda: _set_affinity(cores[:1]),
             "switch": lambda: sys.setswitchinterval(5e-4),
             "threads": lambda: torch.set_num_threads(len(all_cpus))}

    def undo():
        _set_affinity(all_cpus)
        sys.setswitchinterval(sw0)
        torch.set_num_threads(n0)
    conds = args.conds.split(",")
    r, e = run.runner, run.next_epoch
    for rep in range(args.reps):
        order = conds[rep % len(conds):] + conds[:rep % len(conds)]
        for cond in order:
            apply[cond]()
            h0 = hostinfo.snapshot()
            t0 = time.perf_counter()
            reps = []
            while time.perf_counter() - t0 < args.slice_seconds:
                reps += r.run(r.params, r.opt_state, e, run.E)
                e = 0
            wall = time.perf_counter() - t0
            h = hostinfo.delta(h0, hostinfo.snapshot())
            undo()
            walls = sorted(x.wall_time_s for x in reps)
            print(json.dumps({
                "rep": rep, "cond": cond,
                "seeds_per_s": run.seeds_per_epoch * len(reps) / wall,
                "epochs": len(reps), "epoch_wall_med": walls[len(walls) // 2],
                "exposed_ms": 1e3 * sum(x.exposed_stage_s for x in reps)
                / len(reps), **h}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
