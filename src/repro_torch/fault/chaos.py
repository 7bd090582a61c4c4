"""Chaos harness: sweep seeded fault plans through the host-sim runner
AND the online serving tier (the port of ``repro/fault/chaos.py``).

``python -m repro_torch.fault.chaos --seed N`` runs the tiny-graph
RapidGNN scenario (worker 0 of a 4-way greedy partition, 3 epochs, disk
spill ON so the spill heal path is exercised) once CLEAN to get the
oracle loss curve, then once per named host profile and per
``random_plan`` drawn from the chaos pool. The robustness contract
(DESIGN.md §10) is binary per run:

  * the run COMPLETES -> its loss curve must be BIT-equal to the oracle
    (every tolerated fault recovers losslessly), or
  * the run raises one of the TYPED fault-plane errors -- never a raw
    numpy/OS error, never a hang, never a silent divergence.

Steps train on the torch ``--device`` (``cuda`` by default, raising
without a card; ``cpu`` on request) through the ``gather_agg`` kernel,
forward and backward, which is deterministic on the card: bit-equality
with the oracle means something there too.

A final checkpoint-atomicity drill crashes ``save_run_state`` between
the arrays commit and the manifest commit and proves ``LATEST`` still
resolves to the previous, bit-intact checkpoint.

The SERVE sweep (DESIGN.md §11) then drills ``repro_torch.serve.gnn``:
a fixed request stream is replayed through a fresh service per plan
(``SERVE_SWEEP`` profiles + ``random_serve_plan`` draws), all sharing
ONE ``ServeProgram``. Per request the contract is ternary: the response
is bit-equal to the clean single-request oracle (stale responses must
ALSO bit-match their snapshot rows against the authoritative table), or
the request was shed/failed with a TYPED serving error. Anything else
-- divergence, an untyped leak, a snapshot that lies -- fails the run,
and ``trace_count`` must stay 1 across the whole sweep.

Any violation prints a ``recovery FAILED`` line and the CLI exits
non-zero. Fault plans are Philox-keyed from the CLI seed (§2.2 RNG
contract), so every sweep replays bit-exactly.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.fault.inject import active_plan
from repro_torch.fault.plan import (FaultPlan, InjectedCrash, InjectedFault,
                                    plan_from_profile, random_plan,
                                    random_serve_plan)

#: named host-side profiles the sweep always covers (chaos adds random
#: plans on top). ``ckpt-crash``/``run-crash`` are exercised by the
#: checkpoint drill / device suite, not the host epoch loop.
HOST_SWEEP = ("pull-flaky", "pull-dead", "prefetch-flaky",
              "prefetch-fatal", "prefetch-hang", "csec-loss",
              "spill-rot", "spill-trunc", "spill-gone")

#: named serving profiles the serve sweep always covers.
SERVE_SWEEP = ("serve-pull-flaky", "serve-pull-dead", "serve-warm-flaky",
               "serve-warm-dead", "serve-warm-hang", "serve-warm-stale",
               "serve-queue-shed")

#: the scenario's model: GraphSAGE, hidden 32, fan-outs (5, 5)
FANOUTS = (5, 5)


#: the ONLY exceptions a faulted run may surface: the fault-plane's own
#: errors plus the typed detection/supervision errors of each site.
#: PrefetchStall subclasses TimeoutError; TransientFault/FatalFault/
#: InjectedCrash subclass InjectedFault.
def _allowed_errors() -> tuple:
    from repro_torch.core.prefetch import (PrefetchWorkerError,
                                           SecondaryCacheError)
    from repro_torch.core.schedule import SpillCorruptError
    from repro_torch.train.checkpoint import CheckpointCorruptError
    return (InjectedFault, PrefetchWorkerError, SecondaryCacheError,
            SpillCorruptError, CheckpointCorruptError, TimeoutError)


def _config(g):
    from repro_torch.models import GNNConfig
    return GNNConfig(kind="sage", in_dim=g.feat_dim, hidden_dim=32,
                     num_classes=g.num_classes, num_layers=2,
                     fanouts=FANOUTS, agg_backend="kernel")


def _initial_params(cfg, device):
    """The sweep's parameters, from seed 42 (as the reference's
    ``jax.random.key(42)``; the draws differ between the packages)."""
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator().manual_seed(42), device)


class _Chaos:
    """One shared scenario (graph, partition, train step) reused by
    every plan in the sweep; each run rebuilds its schedule in a fresh
    spill dir so file damage never leaks across runs."""

    def __init__(self, device):
        from repro_torch.graph import (KHopSampler, load_dataset,
                                       partition_graph)
        from repro_torch.models import make_train_step
        from repro_torch.train import AdamW

        self.device = device
        self.g = load_dataset("tiny")
        self.pg = partition_graph(self.g, 4, "greedy")
        self.sampler = KHopSampler(self.g, fanouts=list(FANOUTS),
                                   batch_size=16)
        self.cfg = _config(self.g)
        self.opt = AdamW(lr=3e-3)
        self.step = make_train_step(self.cfg, self.opt)

    def run(self, plan: Optional[FaultPlan],
            stall_timeout_s: float = 0.5) -> np.ndarray:
        from repro_torch.core import (NetworkModel, RapidGNNRunner,
                                      ShardedFeatureStore, build_schedule)
        from repro_torch.models import batch_to_device

        losses: List[float] = []
        params = _initial_params(self.cfg, self.device)
        box = {"p": params, "o": self.opt.init(params)}

        def train_fn(feats, cb):
            batch = batch_to_device(cb, feats, self.device)
            box["p"], box["o"], aux = self.step(box["p"], box["o"], batch)
            losses.append(float(aux["loss"]))
            return losses[-1]

        with tempfile.TemporaryDirectory() as td, active_plan(plan):
            # schedule build is INSIDE the plan scope: spill_write
            # damage lands at build time, detection+heal at epoch load
            ws = build_schedule(self.sampler, self.pg, worker=0, s0=42,
                                num_epochs=3, n_hot=64, spill_dir=td)
            store = ShardedFeatureStore(self.pg, worker=0,
                                        net=NetworkModel(enabled=False))
            RapidGNNRunner(ws, store, batch_size=16, train_fn=train_fn,
                           stall_timeout_s=stall_timeout_s).run()
        return np.asarray(losses, np.float64)


def _allowed_serve_errors() -> tuple:
    from repro_torch.serve.gnn import (Overloaded, ServeClosed,
                                       ServePullError, WarmerError)
    return (InjectedFault, Overloaded, ServePullError, WarmerError,
            ServeClosed, TimeoutError)


class _ServeChaos:
    """One shared serving scenario: a fixed Philox-keyed request stream
    replayed through a FRESH service per plan (fresh queue -> rid j ==
    stream index j, so oracles key by stream position), with one shared
    ``ServeProgram`` across every run.

    Shape: three 4-request phases with a synchronous warm cycle between
    them, so each plan exercises the full tier ladder -- phase A runs
    uncached, B runs against generation 1, C against generation 2 (or
    degraded stale/uncached when a warm was killed)."""

    N_PHASES = 3
    PHASE_REQS = 4

    def __init__(self, device):
        from repro_torch.graph import (KHopSampler, load_dataset,
                                       partition_graph)
        from repro_torch.graph.sampler import rng_from

        self.device = device
        self.g = load_dataset("tiny")
        self.pg = partition_graph(self.g, 4, "greedy")
        self.sampler = KHopSampler(self.g, fanouts=list(FANOUTS),
                                   batch_size=8)
        self.cfg = _config(self.g)
        self.params = _initial_params(self.cfg, device)
        n = self.N_PHASES * self.PHASE_REQS
        self.streams = [
            rng_from(4242, j).integers(0, self.g.num_nodes,
                                       size=1 + j % 8).astype(np.int64)
            for j in range(n)]
        self.program = None       # built by the first service

    def _make_service(self):
        from repro_torch.serve.gnn import GNNInferenceService
        svc = GNNInferenceService(
            self.pg, self.sampler, self.cfg, self.params, s0=42,
            worker=0, n_hot=64,
            max_batch_requests=self.PHASE_REQS,
            high_water=self.PHASE_REQS,
            default_timeout_s=30.0, device=self.device,
            program=self.program)
        self.program = svc.program
        return svc

    def oracles(self) -> List[np.ndarray]:
        svc = self._make_service()
        try:
            return [svc.oracle(s, rid=j)
                    for j, s in enumerate(self.streams)]
        finally:
            svc.close()

    def run(self, plan: FaultPlan, oracles: List[np.ndarray]) -> Dict:
        """Replay the stream under ``plan``; -> per-run summary with
        ``failures`` naming every contract breach."""
        from repro_torch.serve.gnn import WarmerError
        allowed = _allowed_serve_errors()
        svc = self._make_service()
        counts = {"ok": 0, "shed": 0, "typed": 0, "stale": 0}
        failures: List[str] = []
        try:
            with active_plan(plan):
                for phase in range(self.N_PHASES):
                    lo = phase * self.PHASE_REQS
                    pending = {}
                    for j in range(lo, lo + self.PHASE_REQS):
                        try:
                            pending[j] = svc.submit(self.streams[j])
                        except allowed:
                            counts["shed"] += 1
                    try:
                        served = 0
                        while served < len(pending):
                            served += svc.step(timeout=0.1)
                    except allowed:
                        pass      # per-request errors re-checked below
                    for j, p in pending.items():
                        try:
                            resp = p.result(timeout=1.0)
                        except allowed:
                            counts["typed"] += 1
                            continue
                        except BaseException as exc:
                            failures.append(
                                f"req {j}: untyped "
                                f"{type(exc).__name__}")
                            continue
                        err = self._verify(j, resp, oracles)
                        if err:
                            failures.append(err)
                        else:
                            counts["ok"] += 1
                            counts["stale"] += int(resp.stale)
                    if phase < self.N_PHASES - 1:
                        try:
                            svc.warmer.warm_now()
                        except WarmerError:
                            pass  # degrade: stale/uncached tier next
        except BaseException as exc:
            failures.append(f"sweep leaked {type(exc).__name__}: {exc}")
        finally:
            svc.close()
        counts["health"] = svc.health()
        counts["failures"] = failures
        return counts

    def _verify(self, j: int, resp, oracles) -> Optional[str]:
        if not np.array_equal(resp.logits, oracles[j]):
            return (f"req {j}: tier={resp.tier} logits diverge from the "
                    f"clean oracle")
        if resp.stale:
            c = resp.served_cache
            if c is None:
                return f"req {j}: stale response without a snapshot"
            if not np.array_equal(c.feats, self.g.features[c.ids]):
                return (f"req {j}: stale snapshot rows diverge from the "
                        f"authoritative table")
        return None


def _serve_sweep(seed: int, fast: bool, log: Callable[[str], None],
                 device, n_random: Optional[int] = None) -> Dict:
    sc = _ServeChaos(device)
    oracles = sc.oracles()
    log(f"[chaos] serve oracle: {len(oracles)} requests")
    if n_random is None:
        n_random = 2 if fast else 6
    plans = [plan_from_profile(p, seed=seed) for p in SERVE_SWEEP]
    plans += [random_serve_plan(seed, i) for i in range(n_random)]
    runs: List[Dict] = []
    bad: List[str] = []
    for plan in plans:
        out = sc.run(plan, oracles)
        for f in out["failures"]:
            log(f"recovery FAILED: serve plan {plan.name}: {f}")
        if out["failures"]:
            bad.append(plan.name)
        if plan.name == "serve-warm-stale" and out["stale"] == 0:
            bad.append(plan.name)
            log("recovery FAILED: serve plan serve-warm-stale never "
                "exercised the stale tier")
        fires = plan.total_fires()
        runs.append({"plan": plan.name, "fires": fires,
                     "ok": out["ok"], "shed": out["shed"],
                     "typed": out["typed"], "stale": out["stale"],
                     "snapshot": plan.snapshot()})
        log(f"[chaos] {plan.name:18s} fires={fires:2d} "
            f"ok={out['ok']:2d} shed={out['shed']} typed={out['typed']} "
            f"stale={out['stale']}")
    traces = sc.program.trace_count if sc.program else 0
    if traces != 1:
        bad.append("trace-count")
        log(f"recovery FAILED: serve sweep ran {traces} static input "
            f"shapes (static-shape collation guarantees exactly 1)")
    return {"runs": runs, "failed_plans": bad, "trace_count": traces,
            "ok": not bad}


def _checkpoint_drill(log: Callable[[str], None]) -> bool:
    """Crash ``save_run_state`` between arrays and manifest commits:
    ``LATEST`` must keep naming the previous step, which must load back
    bit-equal."""
    from repro_torch.train import latest_step, load_run_state, save_run_state

    tree1 = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "b": np.zeros(3, np.float32)}
    tree2 = {"w": tree1["w"] + 1.0, "b": tree1["b"] + 1.0}
    with tempfile.TemporaryDirectory() as td:
        save_run_state(td, tree1, step=1)
        crashed = False
        try:
            with active_plan(plan_from_profile("ckpt-crash")):
                save_run_state(td, tree2, step=2)
        except InjectedCrash:
            crashed = True
        ok = crashed and latest_step(td) == 1
        if ok:
            like = {"w": np.zeros((2, 3), np.float32),
                    "b": np.zeros(3, np.float32)}
            tree, step = load_run_state(td, like)
            ok = (step == 1
                  and np.array_equal(np.asarray(tree["w"]), tree1["w"])
                  and np.array_equal(np.asarray(tree["b"]), tree1["b"]))
    if not ok:
        log("recovery FAILED: checkpoint atomicity drill -- a crash "
            "mid-commit must leave LATEST on the previous bit-intact "
            "checkpoint")
    return ok


def run_chaos(seed: int = 0, fast: bool = False,
              n_random: Optional[int] = None,
              log: Callable[[str], None] = print,
              serve_only: bool = False, device=None) -> Dict:
    """Run the full sweep on ``device`` (``None`` means ``cuda``;
    raises without a card); returns a JSON-ready summary with
    ``ok=True`` iff every run either recovered bit-exactly or raised a
    typed error, and the checkpoint drill passed. ``serve_only`` runs
    just the serving sweep."""
    device = resolve_device(device)
    if serve_only:
        serve = _serve_sweep(seed, fast, log, device, n_random=n_random)
        log(f"[chaos] {len(serve['runs'])} serve plans, "
            f"{len(serve['failed_plans'])} failures")
        return {"seed": seed, "runs": [], "checkpoint_drill": None,
                "failed_plans": serve["failed_plans"], "serve": serve,
                "ok": serve["ok"]}
    ch = _Chaos(device)
    oracle = ch.run(None)
    log(f"[chaos] oracle: {oracle.shape[0]} steps, "
        f"final loss {oracle[-1]:.6f}")

    plans = [plan_from_profile(p, seed=seed) for p in HOST_SWEEP]
    if n_random is None:
        n_random = 2 if fast else 8
    plans += [random_plan(seed, i) for i in range(n_random)]
    allowed = _allowed_errors()

    runs: List[Dict] = []
    bad: List[str] = []
    for plan in plans:
        try:
            losses = ch.run(plan)
        except allowed as exc:
            outcome = f"typed:{type(exc).__name__}"
        except BaseException as exc:   # untyped leak == contract breach
            outcome = f"untyped:{type(exc).__name__}"
            bad.append(plan.name)
            log(f"recovery FAILED: plan {plan.name} leaked an untyped "
                f"error {exc!r}")
        else:
            if (losses.shape == oracle.shape
                    and np.array_equal(losses, oracle)):
                outcome = "bit-equal"
            else:
                outcome = "diverged"
                bad.append(plan.name)
                log(f"recovery FAILED: plan {plan.name} completed with "
                    f"a loss curve diverging from the oracle")
        fires = plan.total_fires()
        runs.append({"plan": plan.name, "fires": fires,
                     "outcome": outcome,
                     "snapshot": plan.snapshot()})
        log(f"[chaos] {plan.name:18s} fires={fires:2d} {outcome}")

    ckpt_ok = _checkpoint_drill(log)
    serve = _serve_sweep(seed, fast, log, device)
    ok = not bad and ckpt_ok and serve["ok"]
    log(f"[chaos] {len(runs)} train plans ({len(bad)} failures), "
        f"{len(serve['runs'])} serve plans "
        f"({len(serve['failed_plans'])} failures), "
        f"checkpoint drill {'OK' if ckpt_ok else 'FAILED'}")
    return {"seed": seed, "oracle_steps": int(oracle.shape[0]),
            "runs": runs, "checkpoint_drill": ckpt_ok,
            "failed_plans": bad, "serve": serve, "ok": ok}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="RapidGNN fault-injection chaos sweep (PyTorch port)")
    ap.add_argument("--seed", type=int, default=0,
                    help="Philox seed keying every fault plan")
    ap.add_argument("--fast", action="store_true",
                    help="2 random plans instead of 8")
    ap.add_argument("--plans", type=int, default=None,
                    help="override the random-plan count")
    ap.add_argument("--serve-only", action="store_true",
                    help="run only the serving sweep")
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep trains and serves on "
                         "(cuda | cpu)")
    args = ap.parse_args(argv)
    out = run_chaos(seed=args.seed, fast=args.fast, n_random=args.plans,
                    serve_only=args.serve_only, device=args.device)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
