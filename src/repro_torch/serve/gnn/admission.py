"""Bounded admission queue with load shedding (DESIGN.md §11).

Overload policy: admission fails FAST and TYPED. Past the high-water
mark the queue sheds with ``Overloaded`` instead of buffering unbounded
work it cannot serve before deadlines -- the client owns the retry
decision. The ``serve_queue`` fault site sits at admission (before the
depth check), so an injected admission fault is indistinguishable from
organic overload to the client: same typed rejection, same ``shed``
counter, which is exactly the degraded behaviour the chaos harness
verifies.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.fault.inject import fault_point
from repro_torch.fault.plan import InjectedFault
from repro_torch.serve.gnn.request import (InferenceRequest, Overloaded,
                                           PendingResponse, ServeClosed)


class AdmissionQueue:
    """FIFO of (request, pending) pairs, bounded by ``high_water``."""

    def __init__(self, high_water: int, worker: int = 0):
        if high_water < 1:
            raise ValueError(f"high_water must be >= 1, got {high_water}")
        self.high_water = int(high_water)
        self.worker = worker
        self._dq: Deque[Tuple[InferenceRequest, PendingResponse]] = \
            collections.deque()
        self._lock = threading.Lock()
        self._ready = threading.Condition(self._lock)
        self._closed = False
        self._next_rid = 0
        self._shed = 0

    # -- client side --------------------------------------------------------
    def submit(self, seeds: np.ndarray,
               timeout_s: float) -> PendingResponse:
        """Admit one request or raise typed ``Overloaded``/``ServeClosed``.

        The fault probe runs OUTSIDE the lock (a "hang" rule sleeps) and
        before the depth check; both rejection paths count as shed.
        """
        with self._lock:
            if self._closed:
                raise ServeClosed("admission after close()")
            rid = self._next_rid
            self._next_rid += 1
        try:
            fault_point("serve_queue", worker=self.worker, index=rid)
        except InjectedFault as exc:
            with self._lock:
                self._shed += 1
            raise Overloaded(
                f"request {rid} shed: admission fault") from exc
        now = time.monotonic()
        req = InferenceRequest(
            rid=rid, seeds=np.asarray(seeds, dtype=np.int64),
            deadline=now + float(timeout_s), submitted_at=now)
        pending = PendingResponse(rid)
        with self._lock:
            if self._closed:
                raise ServeClosed("admission after close()")
            if len(self._dq) >= self.high_water:
                self._shed += 1
                raise Overloaded(
                    f"request {rid} shed: queue depth {len(self._dq)} at "
                    f"high-water mark {self.high_water}")
            self._dq.append((req, pending))
            self._ready.notify()
        return pending

    # -- dispatcher side ----------------------------------------------------
    def pop_batch(self, max_n: int, timeout: Optional[float] = None
                  ) -> List[Tuple[InferenceRequest, PendingResponse]]:
        """Up to ``max_n`` admitted requests, FIFO. Blocks up to
        ``timeout`` for the first one (None: no wait); empty list means
        nothing arrived or the queue closed."""
        with self._lock:
            if not self._dq and timeout and not self._closed:
                self._ready.wait(timeout=timeout)
            out = []
            while self._dq and len(out) < max_n:
                out.append(self._dq.popleft())
            return out

    def depth(self) -> int:
        with self._lock:
            return len(self._dq)

    @property
    def shed(self) -> int:
        with self._lock:
            return self._shed

    def close(self) -> List[Tuple[InferenceRequest, PendingResponse]]:
        """Idempotent: reject future submits, drain and return the
        backlog (the service fails each pending typed)."""
        with self._lock:
            self._closed = True
            out = list(self._dq)
            self._dq.clear()
            self._ready.notify_all()
            return out
