"""The port's tracer: named spans and counters, kept in memory, on the
clock of ``torch.profiler``'s host events.

One tracer serves the process, off by default. ``span(name, **attrs)``
is a context manager around work; ``count(name, n)`` adds to a counter;
``enable()``, ``disable()`` and ``clear()`` switch and reset recording;
``export()`` returns ``{"spans": [...], "counters": {...}}``.

A span's ``start_ns`` and ``end_ns`` are ``time.time_ns()`` stamps:
Kineto stamps its host events on that clock, and the device activities
of a trace are aligned to it, so spans and a profiler trace share one
time line without a ``record_function`` (which costs several
microseconds an enter/exit even with no profiler running, and which the
profiler does not record on a thread started before it). A recorded
span is a dict: ``name``, ``start_ns``, ``end_ns``, ``thread`` (its
thread's name), ``thread_id``, ``id``, ``parent`` (the id of the
innermost span open on the same thread, or of an explicit ``cause`` on
another thread; None at the top) and ``attrs``. A span takes its
parent's attrs under its own, so the spans of one epoch share its
``epoch`` and those of one step its ``step``.

Off, ``span`` costs one check and records nothing. ``timed`` is the
same span for sites that feed a report's timing: it reads the clock
twice whether the tracer is on or not, and ``seconds`` is the report's
number, so the report and the trace cannot disagree.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, Optional


class Span:
    """One interval of work on one thread. ``seconds`` is its length."""

    __slots__ = ("name", "attrs", "cause", "start_ns", "end_ns", "id",
                 "parent", "_rec")

    def __init__(self, name: str, attrs: Dict[str, Any],
                 cause: Optional["Span"], rec: bool):
        self.name, self.attrs, self.cause, self._rec = name, attrs, cause, rec
        self.id: Optional[int] = None
        self.parent: Optional[int] = None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        if self._rec:
            TRACER._open(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._rec:
            TRACER._close(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Off:
    """What ``span`` hands out while the tracer is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class Tracer:
    """The spans closed and the counters added while ``on``."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._spans: List[Dict[str, Any]] = []
        self._counters: Dict[str, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _open(self, sp: Span) -> None:
        st = self._stack()
        up = sp.cause if sp.cause is not None and sp.cause.id is not None \
            else (st[-1] if st else None)
        if up is not None:
            sp.parent = up.id
            sp.attrs = {**up.attrs, **sp.attrs}
        sp.id = next(self._ids)
        st.append(sp)

    def _close(self, sp: Span) -> None:
        st = self._stack()
        if st and st[-1] is sp:
            st.pop()
        t = threading.current_thread()
        rec = {"name": sp.name, "start_ns": sp.start_ns,
               "end_ns": sp.end_ns, "thread": t.name,
               "thread_id": t.ident, "id": sp.id, "parent": sp.parent,
               "attrs": sp.attrs}
        with self._lock:
            self._spans.append(rec)

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self._counters = {}

    def export(self) -> Dict[str, Any]:
        with self._lock:
            return {"spans": sorted(self._spans,
                                    key=lambda s: (s["start_ns"], s["id"])),
                    "counters": dict(self._counters)}


#: the process's tracer
TRACER = Tracer()


def span(name: str, cause: Optional[Span] = None, **attrs):
    """A span of ``name`` around a ``with`` block (nothing while off).
    ``cause``: the span on another thread that this work serves."""
    if not TRACER.on:
        return _OFF
    return Span(name, attrs, cause, True)


def timed(name: str, cause: Optional[Span] = None, **attrs) -> Span:
    """``span`` that reads the clock while off too: its ``seconds`` is
    a report's timing."""
    return Span(name, attrs, cause, TRACER.on)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (nothing while off)."""
    if TRACER.on:
        TRACER.add(name, n)


def enable() -> None:
    TRACER.on = True


def disable() -> None:
    TRACER.on = False


def clear() -> None:
    TRACER.clear()


def export() -> Dict[str, Any]:
    """``{"spans": [span dicts by start], "counters": {name: total}}``."""
    return TRACER.export()
