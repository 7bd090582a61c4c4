"""Injection runtime: the process-wide active plan + ``fault_point``.

``fault_point(site, ...)`` is the probe the runtime calls at each named
fault site. With no plan active it is a no-op returning ``None`` (the
production path: one dict read under a lock). With a plan active, the
plan's keyed Bernoulli decides -- deterministically in the site context,
never in wall-clock or thread order -- whether to raise a typed fault,
sleep (hang), damage the file operand, or report an advisory loss.

File damage goes through plain ``open``/``os`` byte surgery on purpose:
npz-level IO is sanctioned only inside the schedule spill module
(SPILL-SAFETY), and a corruptor that understood the format would be
weaker than one that flips raw bytes anyway.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Iterator, Optional, Tuple

from repro_torch.fault.plan import (FILE_KINDS, FAULT_SALT, FatalFault,
                                    FaultPlan, InjectedCrash, TransientFault,
                                    _tag)
from repro_torch.graph.sampler import rng_from

_lock = threading.Lock()
_active: Optional[FaultPlan] = None


def activate(plan: FaultPlan) -> None:
    global _active
    with _lock:
        _active = plan


def deactivate() -> None:
    global _active
    with _lock:
        _active = None


def current() -> Optional[FaultPlan]:
    with _lock:
        return _active


@contextlib.contextmanager
def active_plan(plan: Optional[FaultPlan]) -> Iterator[Optional[FaultPlan]]:
    """Scope a plan over a run; always deactivates, even on the typed
    errors the plan itself throws."""
    if plan is not None:
        activate(plan)
    try:
        yield plan
    finally:
        if plan is not None:
            deactivate()


def fault_point(site: str, path: Optional[str] = None, attempt: int = 0,
                epoch: int = -1, worker: int = -1,
                index: int = -1) -> Optional[str]:
    """The probe. Returns the fired kind for advisory/file faults, None
    when nothing fires; raises for error/fatal/crash kinds."""
    plan = current()
    if plan is None:
        return None
    rule = plan.decide(site, attempt=attempt, epoch=epoch, worker=worker,
                       index=index)
    if rule is None:
        return None
    ctx = (f"site={site} epoch={epoch} worker={worker} index={index} "
           f"attempt={attempt}")
    if rule.kind == "hang":
        time.sleep(rule.delay_s)
        return "hang"
    if rule.kind == "error":
        raise TransientFault(f"injected transient fault: {ctx}")
    if rule.kind == "fatal":
        raise FatalFault(f"injected fatal fault: {ctx}")
    if rule.kind == "crash":
        raise InjectedCrash(f"injected crash: {ctx}")
    # file kinds: damage the operand when there is one, else advisory
    # (e.g. the stage_cache site "drops" in-memory buffers by signalling
    # the owner, which rebuilds without them)
    if path is not None:
        _damage_file(path, rule.kind, plan.seed, epoch=epoch,
                     worker=worker)
    return rule.kind


def retry_call(fn: Callable[[int], object], retries: int,
               base_delay_s: float = 1e-3,
               retry_on: Tuple[type, ...] = (TransientFault,),
               on_retry: Optional[Callable[[int], None]] = None):
    """Bounded retry with exponential backoff: ``fn(attempt)`` is called
    with attempts 0..retries; the last failure propagates. ``on_retry``
    runs before each re-attempt (counter hooks)."""
    for a in range(retries + 1):
        try:
            return fn(a)
        except retry_on:
            if a >= retries:
                raise
            if on_retry is not None:
                on_retry(a)
            time.sleep(base_delay_s * (2 ** a))


def _damage_file(path: str, kind: str, seed: int, epoch: int = -1,
                 worker: int = -1) -> None:
    """Raw-byte spill damage: drop, halve, or flip one keyed byte."""
    assert kind in FILE_KINDS, kind
    if kind == "drop":
        if os.path.exists(path):
            os.remove(path)
        return
    size = os.path.getsize(path)
    if kind == "truncate":
        os.truncate(path, max(size // 2, 1))
        return
    # corrupt: flip one byte at a deterministic keyed offset, past the
    # zip local-file header so the archive still opens and the damage
    # lands in payload (caught by the per-array crc32, not the opener)
    lo = min(64, size - 1)
    off = int(rng_from(seed, FAULT_SALT, _tag("corrupt-offset"), epoch,
                       worker).integers(lo, size))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
