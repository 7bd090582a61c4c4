"""Seeded deterministic fault plans (DESIGN.md §10).

A ``FaultPlan`` is a seed plus an ordered tuple of ``FaultRule``s.
Every injection decision is drawn through the §2.2 RNG contract --
``rng_from(seed, FAULT_SALT, site, kind, rule_index, attempt, epoch,
worker, index)`` -- so a decision depends only on WHERE the probe sits
(site + context + attempt number), never on when a thread happens to
reach it: a fault schedule replays bit-exactly across runs and across
arbitrary thread interleavings. The ``attempt`` field is load-bearing --
without it a "transient" fault would re-fire identically on every
retry and never clear.

Sites are string names; ``derive_seed`` takes int64 fields only, so
names enter the key as their crc32 (stable across processes, unlike
``hash``).
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.graph.sampler import rng_from

#: domain-separation constant: fault draws can never collide with
#: sampler draws keyed from the same base seed
FAULT_SALT = 0x666C7464  # "fltd"

#: every named injection probe in the runtime (site -> where it lives)
SITES = {
    "stage": "dist/runner.py background epoch staging",
    "stage_cache": "dist/runner.py staged C_s/C_sec device buffers",
    "prefetch": "core/prefetch.py Prefetcher batch assembly",
    "csec": "core/prefetch.py SecondaryCacheBuilder",
    "spill_write": "core/schedule.py SpillWriter npz output",
    "pull": "core/fetch.py sync_pull",
    "checkpoint": "train/checkpoint.py save commit point",
    "run_crash": "dist/runner.py epoch boundary after checkpoint",
    # -- online serving sites (repro_torch.serve.gnn, DESIGN.md §11) -------------
    "serve_pull": "serve/gnn/service.py residual sync-pull per micro-batch",
    "serve_warm": "serve/gnn/warmer.py hot-cache warm cycle",
    "serve_queue": "serve/gnn/admission.py request admission",
}

#: kinds that damage a file operand instead of raising
FILE_KINDS = ("corrupt", "truncate", "drop")
KINDS = ("error", "fatal", "hang", "crash") + FILE_KINDS


class InjectedFault(RuntimeError):
    """Base of every injected failure."""


class TransientFault(InjectedFault):
    """Retryable failure: clears on a later attempt (rule.max_attempt)."""


class FatalFault(InjectedFault):
    """Non-retryable worker failure."""


class InjectedCrash(InjectedFault):
    """Simulated process death (the kill -9 analogue): supervision must
    NOT absorb it -- it propagates so crash-resume paths get exercised."""


def _tag(name: str) -> int:
    return zlib.crc32(name.encode())


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule: fire ``kind`` at ``site`` with probability
    ``p`` whenever the context predicates match. ``max_attempt`` bounds
    transience: the rule only fires while ``attempt <= max_attempt``,
    so retry loops clear it (a large value models a persistent fault).
    ``delay_s`` is the hang duration for ``kind="hang"``."""
    site: str
    kind: str
    p: float = 1.0
    epochs: Optional[Tuple[int, ...]] = None
    workers: Optional[Tuple[int, ...]] = None
    indices: Optional[Tuple[int, ...]] = None
    max_attempt: int = 0
    delay_s: float = 0.05

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(have {sorted(SITES)})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(have {KINDS})")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError(f"p={self.p} outside [0, 1]")
        for f in ("epochs", "workers", "indices"):
            v = getattr(self, f)
            if v is not None:
                object.__setattr__(self, f, tuple(int(x) for x in v))

    def matches(self, attempt: int, epoch: int, worker: int,
                index: int) -> bool:
        if attempt > self.max_attempt:
            return False
        if self.epochs is not None and epoch not in self.epochs:
            return False
        if self.workers is not None and worker not in self.workers:
            return False
        if self.indices is not None and index not in self.indices:
            return False
        return True


class FaultPlan:
    """Deterministic fault schedule + thread-safe fire counters."""

    def __init__(self, seed: int, rules: Sequence[FaultRule],
                 name: str = "custom"):
        self.seed = int(seed)
        self.rules = tuple(rules)
        self.name = name
        self._lock = threading.Lock()
        self._fired: Dict[Tuple[str, str], int] = {}

    def decide(self, site: str, attempt: int = 0, epoch: int = -1,
               worker: int = -1, index: int = -1) -> Optional[FaultRule]:
        """First matching rule that fires for this context, else None.
        The Bernoulli draw is keyed by the full (site, kind, rule,
        attempt, ctx) tuple -- pure function of the context, independent
        of call order."""
        for i, rule in enumerate(self.rules):
            if rule.site != site:
                continue
            if not rule.matches(attempt, epoch, worker, index):
                continue
            if rule.p < 1.0:
                u = rng_from(self.seed, FAULT_SALT, _tag(site),
                             _tag(rule.kind), i, attempt, epoch, worker,
                             index).random()
                if u >= rule.p:
                    continue
            with self._lock:
                k = (site, rule.kind)
                self._fired[k] = self._fired.get(k, 0) + 1
            return rule
        return None

    def fires(self, site: Optional[str] = None,
              kind: Optional[str] = None) -> int:
        with self._lock:
            return sum(n for (s, k), n in self._fired.items()
                       if (site is None or s == site)
                       and (kind is None or k == kind))

    def total_fires(self) -> int:
        return self.fires()

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f"{s}:{k}": n for (s, k), n in
                    sorted(self._fired.items())}


# ---------------------------------------------------------------------------
# named profiles (the fault campaign / chaos axes)
# ---------------------------------------------------------------------------

#: one rule-set per named failure mode; keep device-backend and
#: host-backend profile names DISJOINT (apart from "none") so a fault
#: campaign never cross-pairs two differently-faulted backends.
PROFILES: Dict[str, Tuple[FaultRule, ...]] = {
    "none": (),
    # -- device runner sites ------------------------------------------------
    "stage-flaky": (FaultRule("stage", "error", epochs=(1,)),),
    "stage-dead": (FaultRule("stage", "error", epochs=(1,),
                             max_attempt=99),),
    "stage-deadline": (FaultRule("stage", "hang", epochs=(1,),
                                 delay_s=0.4),),
    "cache-loss": (FaultRule("stage_cache", "drop", epochs=(1,)),),
    "ckpt-crash": (FaultRule("checkpoint", "crash", epochs=(2,)),),
    "run-crash": (FaultRule("run_crash", "crash", epochs=(2,)),),
    # -- host-sim sites -----------------------------------------------------
    "pull-flaky": (FaultRule("pull", "error", epochs=(1,)),),
    "pull-dead": (FaultRule("pull", "error", max_attempt=99),),
    "prefetch-flaky": (FaultRule("prefetch", "error", epochs=(1,),
                                 indices=(0,)),),
    "prefetch-fatal": (FaultRule("prefetch", "fatal", epochs=(1,),
                                 indices=(0,)),),
    "prefetch-hang": (FaultRule("prefetch", "hang", epochs=(1,),
                                indices=(0,), delay_s=0.3),),
    "csec-loss": (FaultRule("csec", "error", epochs=(0,)),),
    "spill-rot": (FaultRule("spill_write", "corrupt", epochs=(1,)),),
    "spill-trunc": (FaultRule("spill_write", "truncate", epochs=(1,)),),
    "spill-gone": (FaultRule("spill_write", "drop", epochs=(1,)),),
    # -- online serving sites (repro_torch.serve.gnn) -----------------------------
    # serve probes carry the request id in ``index`` and the warm
    # generation in ``epoch``, so rules can target specific requests /
    # warm cycles. Transient pull faults clear under the service's
    # retry budget; "dead" variants exhaust it (typed ServePullError /
    # stale-tier degradation).
    "serve-pull-flaky": (FaultRule("serve_pull", "error"),),
    "serve-pull-dead": (FaultRule("serve_pull", "error", indices=(1,),
                                  max_attempt=99),),
    "serve-warm-flaky": (FaultRule("serve_warm", "error"),),
    "serve-warm-dead": (FaultRule("serve_warm", "error", max_attempt=99),),
    "serve-warm-hang": (FaultRule("serve_warm", "hang", delay_s=0.05),),
    # persistent failure of warm GENERATION 2 only: generation 1
    # succeeds, so the service holds a last-good snapshot and must
    # degrade to the STALE tier (flagged responses) rather than fail
    "serve-warm-stale": (FaultRule("serve_warm", "error", epochs=(2,),
                                   max_attempt=99),),
    "serve-queue-shed": (FaultRule("serve_queue", "error", p=0.5),),
}


def plan_from_profile(name: str, seed: int = 0) -> FaultPlan:
    if name not in PROFILES:
        raise ValueError(f"unknown fault profile {name!r} "
                         f"(have {sorted(PROFILES)})")
    return FaultPlan(seed, PROFILES[name], name=name)


#: (site, kind) pool the chaos harness samples host-side plans from --
#: every entry is a fault the host runtime claims to tolerate (recover
#: bit-exactly) or to surface as a TYPED error.
CHAOS_POOL: Tuple[Tuple[str, str], ...] = (
    ("pull", "error"),
    ("prefetch", "error"),
    ("prefetch", "fatal"),
    ("prefetch", "hang"),
    ("csec", "error"),
    ("spill_write", "corrupt"),
    ("spill_write", "truncate"),
    ("spill_write", "drop"),
)


def random_plan(seed: int, i: int, num_epochs: int = 3) -> FaultPlan:
    """Chaos plan #i for ``seed``: 1-3 rules drawn from ``CHAOS_POOL``
    via the keyed stream, so plan #i is identical on every machine."""
    rng = rng_from(seed, FAULT_SALT, _tag("chaos-plan"), i)
    rules = []
    for _ in range(int(rng.integers(1, 4))):
        site, kind = CHAOS_POOL[int(rng.integers(0, len(CHAOS_POOL)))]
        rules.append(FaultRule(
            site, kind,
            p=(0.5, 1.0)[int(rng.integers(0, 2))],
            epochs=(int(rng.integers(0, num_epochs)),),
            indices=(0,) if site == "prefetch" else None,
            max_attempt=int(rng.integers(0, 2)),
            delay_s=0.15))
    return FaultPlan(seed, rules, name=f"chaos-{i}")


#: (site, kind) pool for the SERVING chaos sweep. Kept SEPARATE from
#: the training ``CHAOS_POOL`` on purpose: mixing serve sites into the
#: training pool would dilute both sweeps' fault density, and a
#: training run never reaches a serve site (nor vice versa), so a
#: mixed plan wastes half its rules. "hang" doubles as the
#: deadline-pressure generator.
SERVE_CHAOS_POOL: Tuple[Tuple[str, str], ...] = (
    ("serve_pull", "error"),
    ("serve_warm", "error"),
    ("serve_warm", "hang"),
    ("serve_queue", "error"),
)


def random_serve_plan(seed: int, i: int) -> FaultPlan:
    """Serving chaos plan #i: 1-3 rules from ``SERVE_CHAOS_POOL`` on an
    independent keyed stream (tag differs from ``random_plan``, so the
    two sweeps never correlate). Probability and transience vary; no
    epoch predicate -- serve probes carry the warm generation there,
    which the drawn plan should hit regardless of its value."""
    rng = rng_from(seed, FAULT_SALT, _tag("serve-chaos-plan"), i)
    rules = []
    for _ in range(int(rng.integers(1, 4))):
        site, kind = SERVE_CHAOS_POOL[
            int(rng.integers(0, len(SERVE_CHAOS_POOL)))]
        rules.append(FaultRule(
            site, kind,
            p=(0.5, 1.0)[int(rng.integers(0, 2))],
            max_attempt=int(rng.integers(0, 2)),
            delay_s=0.02))
    return FaultPlan(seed, rules, name=f"serve-chaos-{i}")
