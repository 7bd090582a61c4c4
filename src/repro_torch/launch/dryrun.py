"""The dry-run matrix: every (arch x input shape) combination on the
production meshes, shape only -- the port of ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]

The reference lowers and compiles each combination with explicit
shardings and reads its compiler's memory and cost analyses and the
collectives of the partitioned program. PyTorch has no SPMD partitioner,
so the port's record is cut down to what it can state exactly, one JSON
file a combination, with the reference's keys where a counterpart
exists:

  * ``memory.argument_size_bytes`` / ``output_size_bytes``: one
    device's shards of the step's inputs / outputs under their
    ``dist.shardings`` specs, byte for byte (an output the reference
    leaves to its partitioner is counted with its batch dim over the
    data axes); ``temp_size_bytes`` is null: no compiler to ask.
  * ``cost.flops``: ``torch.utils.flop_counter.FlopCounterMode`` over
    the port's own step on the ``meta`` device (matmuls, batched
    matmuls, convolutions; no elementwise work) at 0 and 1 repeats of
    the layer pattern, extrapolated to the config's repeats exactly,
    divided by the mesh's devices; ``cost.flops_global`` is the
    undivided count.
  * ``collectives``: null -- the port's model paths over a mesh run
    in-process and have no partitioner whose collectives could be
    counted (``collectives_note``).
  * ``fits_hbm`` and ``roofline``: computed from the numbers above and
    the H100 constants of ``launch.mesh``, not measured.

Nothing here allocates device memory, and importing the module sets no
environment variable.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_arch
from repro_torch.dist.mesh import dp_axes
from repro_torch.dist.shardings import Spec, fit_spec, shard_bytes
from repro_torch.launch.mesh import (HBM_BW, HBM_BYTES, PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.specs import cost_variant_cfg, make_dryrun_spec

COLLECTIVES_NOTE = (
    "not counted: the port's model paths over a mesh run in-process (the "
    "model shards are slices of one device's tensors) and the port has no "
    "SPMD partitioner whose collectives could be counted; the GNN's "
    "process-group collectives are counted by launch.dryrun_gnn")
MEMORY_NOTE = (
    "argument/output bytes: one device's shards under the dist.shardings "
    "specs, exact; temp: null, no compiler to ask (the card measures a "
    "step's peak where it runs one)")
FLOPS_NOTE = (
    "flops is per device (flops_global / devices); flops_global is "
    "FlopCounterMode over the step traced on the meta device: matmul, "
    "bmm, convolution FLOPs only")
COMPUTED_NOTE = (
    "fits_hbm (argument_size_bytes <= HBM_BYTES) and roofline (the larger "
    "of flops / PEAK_FLOPS_BF16 and (argument + output bytes) / HBM_BW) are "
    "computed from this record and the H100 SXM data sheet, not measured")


def _default_spec(mesh, t: torch.Tensor) -> Spec:
    """An output the reference leaves to its partitioner: batch dim over
    the data axes where it divides, else replicated."""
    if t.dim() == 0:
        return Spec()
    return fit_spec(mesh, (dp_axes(mesh),), tuple(t.shape))


def _fill_specs(mesh, tree, specs):
    """``specs`` with every ``None`` replaced by ``_default_spec`` of the
    matching leaf (or of every leaf of the matching subtree)."""
    if specs is None:
        if isinstance(tree, torch.Tensor):
            return _default_spec(mesh, tree)
        if isinstance(tree, dict):
            return {k: _fill_specs(mesh, v, None) for k, v in tree.items()}
        return [_fill_specs(mesh, v, None) for v in tree]
    if isinstance(tree, torch.Tensor):
        return specs
    if isinstance(tree, dict):
        return {k: _fill_specs(mesh, v, specs[k]) for k, v in tree.items()}
    return [_fill_specs(mesh, v, s) for v, s in zip(tree, specs,
                                                    strict=True)]


def argument_bytes(spec, mesh) -> int:
    """Per-device bytes of the step's inputs under their specs."""
    return shard_bytes(mesh, list(spec.args), list(spec.in_shardings))


def trace_flops(fn, args) -> Tuple[int, object]:
    """-> (FLOPs counted over ``fn(*args)``, its output)."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return int(counter.get_total_flops()), out


def step_outputs(spec):
    """The step's outputs as shape-only tensors, from its kind: train
    (params, opt_state, loss), prefill next-token logits (B, V), decode
    (logits (B, 1, V), states) -- what the traced step returns (the
    tests hold the two equal)."""
    cfg, B = spec.meta["cfg"], spec.meta["batch"]

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    kind = spec.meta["kind"]
    if kind == "train":
        return (spec.args[0], spec.args[1], f32())
    if kind == "prefill":
        return f32(B, cfg.vocab_size)
    return (f32(B, 1, cfg.vocab_size), spec.args[1])


def repeat_cfgs(cfg):
    """-> (cfg at 0 repeats, cfg at 1 repeat, R) for the FLOP
    count, or None where the repeats do not all do the same work as one
    another (an encoder of another depth than the decoder's repeats).
    Each repeat of the pattern runs the same blocks on the same shapes,
    so the step's FLOPs are exactly f(0) + R * (f(1) - f(0)); the tail
    blocks and the encoder (one layer a repeat) are kept in both."""
    R = cfg.num_repeats
    if cfg.kind == "encdec" and cfg.num_enc_layers != R:
        return None
    tail = len(cfg.tail)

    def with_r(r):
        changes = dict(num_layers=len(cfg.pattern) * r + tail)
        if cfg.kind == "encdec":
            changes["num_enc_layers"] = r
        return dataclasses.replace(cfg, **changes)

    return with_r(0), with_r(1), R


def _apply_opt(cfg, opt: str):
    changes = {}
    if "seqshard" in opt:
        changes["seq_shard_attn"] = True
    if "resident" in opt:
        changes["moe_resident_experts"] = True
    return dataclasses.replace(cfg, **changes)


def run_one(arch: str, shape: str, multi_pod: bool, cfg=None,
            S: Optional[int] = None, B: Optional[int] = None,
            opt: str = "", mesh=None) -> dict:
    """One combination's record; ``mesh`` (default the production mesh)
    may be any mesh the model functions take. FLOPs are counted over the
    step at 0 and 1 repeats of the pattern and extrapolated to R exactly
    (``repeat_cfgs``; the whole step is traced where it does not apply):
    an MoE block over a 16-way data axis runs 256 in-process routings a
    layer, some 2 s of shape-only trace a layer."""
    mesh = mesh if mesh is not None else \
        make_production_mesh(multi_pod=multi_pod)
    cfg = cfg or get_arch(arch)
    if opt:
        cfg = _apply_opt(cfg, opt)
    spec = make_dryrun_spec(arch, shape, mesh, cfg=cfg, S=S, B=B)
    devices = mesh.size
    rec = {"arch": arch, "shape": shape,
           "mesh": "x".join(str(n) for n in mesh.shape.values()),
           "devices": devices, "kind": spec.meta["kind"],
           "S": spec.meta["seq"], "B": spec.meta["batch"],
           "attn_variant": spec.meta.get("attn_variant", "full")}
    arg_bytes = argument_bytes(spec, mesh)
    t0 = time.perf_counter()
    variants = repeat_cfgs(cfg)
    if variants is None:
        count, out = trace_flops(spec.fn, spec.args)
        source = "trace of the whole step"
    else:
        f0, f1 = (trace_flops(v.fn, v.args)[0] for v in (
            make_dryrun_spec(arch, shape, mesh, cfg=c, S=S, B=B)
            for c in variants[:2]))
        count, out = f0 + variants[2] * (f1 - f0), step_outputs(spec)
        source = (f"traces at 0 and 1 repeats of the pattern, "
                  f"f(0) + {variants[2]} * (f(1) - f(0))")
    rec["trace_s"] = time.perf_counter() - t0
    out_specs = _fill_specs(mesh, out, spec.out_shardings)
    out_bytes = shard_bytes(mesh, out, out_specs)
    rec["memory"] = {"argument_size_bytes": arg_bytes,
                     "output_size_bytes": out_bytes,
                     "temp_size_bytes": None,
                     "generated_code_size_bytes": None,
                     "note": MEMORY_NOTE}
    rec["cost"] = {"flops": count / devices, "flops_global": count,
                   "source": source, "note": FLOPS_NOTE}
    rec["collectives"] = None
    rec["collectives_note"] = COLLECTIVES_NOTE
    compute_ms = count / devices / PEAK_FLOPS_BF16 * 1e3
    memory_ms = (arg_bytes + out_bytes) / HBM_BW * 1e3
    rec["fits_hbm"] = arg_bytes <= HBM_BYTES
    rec["roofline"] = {"bound_ms": max(compute_ms, memory_ms),
                       "compute_ms": compute_ms, "memory_ms": memory_ms,
                       "bound_by": ("operations" if compute_ms >= memory_ms
                                    else "bytes")}
    rec["computed_note"] = COMPUTED_NOTE
    pc = spec.meta["cfg"].param_counts()
    rec["params_total"] = pc["total"]
    rec["params_active"] = pc["active"]
    rec["tokens"] = spec.meta["batch"] * (spec.meta["seq"]
                                          if spec.meta["kind"] != "decode"
                                          else 1)
    return rec


#: cost-variant grid (roofline): r repeats x small S (+ B split for decode)
CV_GRID = {
    "train": [("train_4k", r, S, 16) for r in (1, 2)
              for S in (512, 1024, 2048)],
    "prefill": [("prefill_32k", r, S, 16) for r in (1, 2)
                for S in (512, 1024, 2048)],
    "decode": ([("decode_32k", r, S, 16) for r in (1, 2)
                for S in (1024, 2048, 4096)]
               + [("decode_32k", r, 1024, 32) for r in (1, 2)]),
}


def run_cost_variants(archs: Iterable[str], out_dir: str) -> None:
    for a in archs:
        for kind, grid in CV_GRID.items():
            for shape, r, S, B in grid:
                tag = f"{a}__cv_{kind}_r{r}_S{S}_B{B}"
                path = os.path.join(out_dir, tag + ".json")
                if os.path.exists(path):
                    continue
                cfg = cost_variant_cfg(get_arch(a), r, S)
                print(f"[cv] {tag} ...", flush=True)
                try:
                    rec = run_one(a, shape, False, cfg=cfg, S=S, B=B)
                    rec["cv"] = {"kind": kind, "r": r, "S": S, "B": B}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"  ok {rec['trace_s']:.1f}s "
                          f"flops {rec['cost']['flops']:.3e}")
                except Exception as e:
                    print(f"  FAIL: {e}")
                    traceback.print_exc()


def _one(job: Tuple[str, str, bool, str]) -> dict:
    a, s, multi_pod, opt = job
    rec = run_one(a, s, multi_pod, opt=opt)
    # a shape-only trace never touches a card: CUDA stays uninitialised
    # in the process that ran it
    rec["cuda_initialized"] = torch.cuda.is_initialized()
    return rec


def run_matrix(combos: Sequence[Tuple[str, str, bool]], opt: str = "",
               jobs: int = 1) -> List[dict]:
    """``run_one`` of every (arch, shape, multi_pod) in ``combos``, in
    order; with ``jobs`` > 1 in that many spawned processes (the
    shape-only trace is host-bound and single-threaded)."""
    work = [(a, s, mp, opt) for a, s, mp in combos]
    if jobs <= 1:
        return [_one(w) for w in work]
    import concurrent.futures as cf
    import multiprocessing as mp
    with cf.ProcessPoolExecutor(jobs,
                                mp_context=mp.get_context("spawn")) as ex:
        return list(ex.map(_one, work))


def tag_of(arch: str, shape: str, multi_pod: bool, opt: str = "") -> str:
    tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    return tag + ("__opt-" + opt.replace(",", "-") if opt else "")


def summary(rec: Dict) -> str:
    """One line: argument GiB a device, fits, FLOPs a device, bound."""
    return (f"{rec['arch']} {rec['shape']} {rec['mesh']}: "
            f"args {rec['memory']['argument_size_bytes'] / 2**30:.3f} "
            f"GiB/device, fits_hbm {rec['fits_hbm']}, "
            f"flops {rec['cost']['flops']:.4e}/device, roofline "
            f"{rec['roofline']['bound_ms']:.3f} ms "
            f"({rec['roofline']['bound_by']}; computed), "
            f"trace {rec['trace_s']:.2f} s")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cost-variants", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma list: seqshard,resident")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ARCH_NAMES if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    os.makedirs(args.out, exist_ok=True)
    if args.cost_variants:
        run_cost_variants(archs, args.out)
        return

    todo = []
    for a in archs:
        for s in shapes:
            path = os.path.join(args.out, tag_of(a, s, args.multi_pod,
                                                 args.opt) + ".json")
            if os.path.exists(path):
                print(f"[skip] {os.path.basename(path)} (exists)")
            else:
                todo.append((a, s))
    failures = []
    for a, s in todo:
        tag = tag_of(a, s, args.multi_pod, args.opt)
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            rec = run_one(a, s, args.multi_pod, opt=args.opt)
            with open(os.path.join(args.out, tag + ".json"), "w") as f:
                json.dump(rec, f, indent=1)
            print("  ok: " + summary(rec))
        except Exception as e:
            failures.append((tag, str(e)))
            print(f"  FAIL: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e.splitlines()[0] if e else "")
        raise SystemExit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
