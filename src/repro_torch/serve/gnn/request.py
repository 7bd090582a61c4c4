"""Request/response types for the online GNN inference tier (DESIGN.md §11).

A request is a set of seed node ids plus a latency budget; a response is
the seed logits plus the PROVENANCE the robustness contract needs:
which degradation tier served it (``fresh`` / ``stale`` / ``uncached``),
the exact cache snapshot consulted (so the staleness contract --
"features bit-equal to the snapshot served from" -- is testable), and
whether the deadline was met. Failures are TYPED: overload sheds as
``Overloaded`` at admission, a dead residual pull surfaces as
``ServePullError``, teardown fails pendings with ``ServeClosed`` --
a caller can always tell "degraded but correct" from "no answer".
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.cache import FeatureCache

#: degradation-tier ladder (DESIGN.md §11): fresh hot cache -> stale
#: last-good snapshot (warmer down; flagged) -> uncached sync pull.
TIER_FRESH = "fresh"
TIER_STALE = "stale"
TIER_UNCACHED = "uncached"
TIERS = (TIER_FRESH, TIER_STALE, TIER_UNCACHED)


class ServeError(RuntimeError):
    """Base of every typed serving failure."""


class Overloaded(ServeError):
    """Admission rejected the request: queue past the high-water mark
    (load shedding) or an injected admission fault. Retryable by the
    client after backoff; never enqueued, never counted as served."""


class ServeClosed(ServeError):
    """The service is (being) torn down; the request was not served."""


class WarmerError(ServeError):
    """The background cache warmer exhausted its retry budget; the
    service keeps serving from the last-good snapshot (``stale`` tier)
    while the warmer keeps retrying -- this error is advisory in the
    background loop and raised only from synchronous ``warm_now()``."""


class ServePullError(ServeError):
    """A residual sync pull failed past the retry budget (or past the
    deadline-pressure fast-fail), so the response would have violated
    bit-equality; the request fails typed instead of serving garbage."""


@dataclasses.dataclass
class InferenceRequest:
    """One client request: seed nodes + absolute monotonic deadline.

    ``rid`` keys the sampling stream (``rng_from(s0, w, SERVE_EPOCH,
    rid)``), so a request's sampled computation graph is a pure function
    of (service seed, rid, seeds) -- independent of which micro-batch it
    lands in, which is what makes the batched response bit-equal to the
    single-request oracle.
    """
    rid: int
    seeds: np.ndarray                 # (B,) int64 global node ids
    deadline: float                   # absolute time.monotonic() seconds
    submitted_at: float

    @property
    def remaining(self) -> float:
        return self.deadline - time.monotonic()


@dataclasses.dataclass
class InferenceResponse:
    rid: int
    logits: np.ndarray                # (B, num_classes) float32
    tier: str                         # TIER_FRESH | TIER_STALE | TIER_UNCACHED
    stale: bool                       # True iff served off-generation
    deadline_missed: bool
    cache_generation: int             # warm generation consulted (-1: none)
    #: the exact global-id snapshot consulted (None on the uncached
    #: tier) -- the staleness contract is verified against THIS object
    served_cache: Optional[FeatureCache]
    latency_s: float

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"unknown tier {self.tier!r} (have {TIERS})")


class PendingResponse:
    """Single-slot future handed back by ``submit()``.

    Thread contract: the dispatcher thread fulfils it exactly once
    (result or typed error) under the lock; any number of client
    threads may ``result()``. A deadline-bounded wait that expires
    raises ``TimeoutError`` -- distinct from a *served-late* response,
    which still resolves (flagged ``deadline_missed``).
    """

    def __init__(self, rid: int):
        self.rid = rid
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._response: Optional[InferenceResponse] = None
        self._error: Optional[BaseException] = None

    def fulfill(self, response: InferenceResponse) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._response = response
            self._done.set()

    def fail(self, error: BaseException) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._error = error
            self._done.set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> InferenceResponse:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"request {self.rid} unresolved after {timeout}s")
        with self._lock:
            if self._error is not None:
                raise self._error
            assert self._response is not None
            return self._response
