"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, then ``info`` (set-up
split, window, reference timings) and, last, ``checks``: each number
compared with the reference beside its limit. The same numbers are the
last lines of standard error.

Exits non-zero without a result when there is no CUDA device, when the
card has fewer devices than the cell asks for, when the program cannot
be imported, and when the process has loaded JAX or the JAX package.
"""
import sys
import time

T_START = time.perf_counter()
# run as a script, this file's folder heads sys.path: take it off, so
# that the benchmark's modules are found as ``perfbench.*`` only
_HERE = __import__("os").path.dirname(__import__("os").path.abspath(__file__))
if sys.path and __import__("os").path.abspath(sys.path[0]) == _HERE:
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is
    one of ``FORBIDDEN``, compared whole: ``repro_torch`` passes."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _environment() -> None:
    """Caches inside the checkout, and no JAX behind a library's back.
    The libraries' thread counts are left as a user's job has them."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from perfbench import harness, manifest

    cell = manifest.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (sets float32 matmuls: no TF32)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_START, ROOT)
    found = forbidden_modules()
    if found:
        print(f"the run loaded forbidden modules: {found}", file=sys.stderr)
        return 3
    log("info " + json.dumps(result["info"], default=str))
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    bad = [k for k, m in result["metrics"].items()
           if not math.isfinite(m["value"])]
    if bad:
        print(f"non-finite metrics {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
