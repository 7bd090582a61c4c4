"""Readings that the limits of ``correct`` are set from, on the card at
a cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12

For each seed: the program's set-up and its epochs (as a run makes
them; no measured window), judged against the reference as a run
judges it (the sound readings), and the reference's training numbers
against three stand-ins put in the program's place: the control (the
same reference with TF32 matrix products, the precision below the
configuration's float32), half of each batch left out of the loss, and
the rows pulled from other workers left out (zeros). A state left
unchanged reads 1 by construction and needs no run. The graph, the
program's partition and the reference's partition are made once and
shared by the seeds. One JSON line per seed, then the extremes.
"""
import sys
import time

T0 = time.perf_counter()
_HERE = __import__("os").path.dirname(__import__("os").path.abspath(__file__))
if sys.path and __import__("os").path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(_HERE).parent))
from perfbench.run import ROOT, _environment  # noqa: E402


def look(losses, p0, p, mu, ref_p0, ref):
    """Per-step loss gaps and per-leaf norm gaps, for the look at which
    number separates sound runs from the control."""
    import torch

    from perfbench.reference import check

    def nrm(t):
        return float(torch.linalg.vector_norm(t.double().cpu()))
    out = {"steps": check.loss_gaps(losses, ref["losses"])}
    for name, a, b in (("update", {k: p[k].cpu() - p0[k].cpu() for k in p},
                        {k: ref["params"][k].cpu() - ref_p0[k].cpu()
                         for k in p}),
                       ("moment", {k: mu[k].cpu() for k in mu},
                        {k: ref["mu"][k].cpu() for k in mu})):
        out[name] = {k: [abs(nrm(a[k]) - nrm(b[k])) / nrm(b[k]),
                         nrm(a[k] - b[k]) / nrm(b[k])] for k in a}
        ga = torch.cat([a[k].reshape(-1) for k in a])
        gb = torch.cat([b[k].reshape(-1) for k in a])
        out[name]["global"] = [abs(nrm(ga) - nrm(gb)) / nrm(gb),
                               nrm(ga - gb) / nrm(gb)]
    out["grad0_norms"] = {k: nrm(v) for k, v in ref["grad0"].items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--base", type=int, default=2 ** 31 + 101)
    args = ap.parse_args()
    _environment()
    import torch

    import repro_torch  # noqa: F401
    from perfbench import harness, manifest
    from perfbench.reference import check

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = manifest.load_cell(args.workload, ROOT)
    # the training numbers need set-up's epochs only; the exact numbers
    # are 0 in a sound run by construction
    cell.traffic["check_epochs"] = 0
    prebuilt = owner = None
    rows = []
    for i in range(args.seeds):
        seed = args.base + 7919 * i
        run = harness.CellRun(cell, seed, dev)
        run.setup(prebuilt)
        prebuilt = (run.graph, run.pg)
        run.reports = []
        sound = run.judge(owner)
        owner = run.ref_owner
        run.free()
        ref, row = run.ref_train, {"seed": seed, "sound": sound}
        row["sound_look"] = look(run.warm_losses, run.p0, run.warm_p,
                                 run.warm_mu, run.ref_p0, ref)
        for name, kw in (("control_tf32", {"tf32": True}),
                         ("half_batch", {"half_batch": True}),
                         ("no_exchange", {"no_exchange": True})):
            alt = run.reference_training(**kw)
            row[name] = check.training_numbers(
                alt["losses"], run.ref_p0, alt["params"], alt["mu"],
                run.ref_p0, ref)
            row[name + "_look"] = look(alt["losses"], run.ref_p0,
                                       alt["params"], alt["mu"], run.ref_p0,
                                       ref)
        row["info"] = run.info
        rows.append(row)
        print(json.dumps(row, default=float), flush=True)
        del run
    keys = ("loss_gap", "moment_gap", "update_gap", "update_diff")
    out = {"lower": {k: max(r["sound"][k] for r in rows) for k in keys}}
    for f in ("control_tf32", "half_batch", "no_exchange"):
        out[f] = {k: min(r[f][k] for r in rows) for k in keys}
    print("extremes " + json.dumps(out), flush=True)
    print(f"calibration wall {time.perf_counter() - T0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
