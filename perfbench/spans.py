"""Reading the program's own spans and counters: the exports of
``repro_torch.core.trace`` taken over a traced pass.

A span is a dict with ``name``, ``start_ns``, ``end_ns`` (the clock of
the profiler's host events, to which its device activities are
aligned), ``thread_id``, ``id``, ``parent`` and ``attrs``. The runner
thread is the one that ran ``runner.run``; the staging thread's spans
hang off it by ``parent`` across threads.

  * ``self_ms``: a span's self time is its length less the part of it
    that its children on the same thread cover, summed by name;
  * ``innermost``: the runner thread's time line cut where the
    innermost open span changes;
  * ``idle_by_span``: the card's idle time in a slice, by the innermost
    span open on the runner thread over it (``OUTSIDE`` where none is);
  * ``idle_within``: the card's idle time while the runner thread is
    inside a span of one name (its children included);
  * ``stage_parts_ms``, ``step_ms_by_overlap``, ``per_kseed``: what the
    readers and the probe report.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

OUTSIDE = "outside any span"
Interval = Tuple[int, int]


def length_ns(s) -> int:
    return s["end_ns"] - s["start_ns"]


def runner_thread(spans) -> Optional[int]:
    """The thread id of the ``runner.run`` spans (None without one)."""
    for s in spans:
        if s["name"] == "runner.run":
            return s["thread_id"]
    return None


def _union(iv: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def self_ns(spans) -> Dict[int, int]:
    """{span id: its length less the union of its same-thread children's
    intervals, clipped to it}. A child on another thread (a ``cause``)
    runs beside its parent and takes nothing from it."""
    by_id = {s["id"]: s for s in spans}
    kids: Dict[int, List[Interval]] = defaultdict(list)
    for s in spans:
        p = by_id.get(s["parent"])
        if p is not None and p["thread_id"] == s["thread_id"]:
            kids[p["id"]].append((max(s["start_ns"], p["start_ns"]),
                                  min(s["end_ns"], p["end_ns"])))
    return {s["id"]: length_ns(s) - sum(b - a for a, b in
                                         _union(kids[s["id"]]))
            for s in spans}


def self_ms(spans, per: float = 1.0) -> Dict[str, float]:
    """Self milliseconds summed by span name, over ``per``."""
    own = self_ns(spans)
    tot: Dict[str, int] = defaultdict(int)
    for s in spans:
        tot[s["name"]] += own[s["id"]]
    return {k: v / 1e6 / per for k, v in sorted(tot.items())}


def innermost(spans) -> List[Tuple[int, int, str]]:
    """One thread's spans (nested, as ``with`` blocks are) -> the
    disjoint, ordered (start, end, name) pieces of their union, each
    named by the innermost span open over it."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []       # (end, name), outermost first
    t = 0

    def close_until(x: int) -> None:
        nonlocal t
        while stack and stack[-1][0] <= x:
            e, name = stack.pop()
            if e > t:
                out.append((t, e, name))
            t = max(t, e)

    for s in sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"])):
        a = s["start_ns"]
        close_until(a)
        if stack and a > t:
            out.append((t, a, stack[-1][1]))
        stack.append((s["end_ns"], s["name"]))
        t = a
    close_until(float("inf"))
    return out


def idle_intervals(busy: Sequence[Interval], start: int,
                   end: int) -> List[Interval]:
    """The gaps between the card's busy intervals (sorted, disjoint)
    inside [start, end)."""
    out: List[Interval] = []
    edge = start
    for a, b in busy:
        if a >= end:
            break
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    if end > edge:
        out.append((edge, end))
    return out


class _Cover:
    """Sorted, disjoint intervals; ``over(a, b)``: how much of [a, b)
    they cover (two binary searches)."""

    def __init__(self, iv: Sequence[Interval]):
        self.iv = list(iv)
        self.starts = [a for a, _ in self.iv]
        self.pre = [0]
        for a, b in self.iv:
            self.pre.append(self.pre[-1] + b - a)

    def _upto(self, x) -> int:
        i = bisect.bisect_right(self.starts, x)
        if i == 0:
            return 0
        a, b = self.iv[i - 1]
        return self.pre[i - 1] + min(x, b) - a

    def over(self, a, b) -> int:
        return self._upto(b) - self._upto(a)


def idle_by_span(spans, busy: Sequence[Interval], start: int,
                 end: int) -> Dict[str, int]:
    """The card's idle nanoseconds in [start, end) by the innermost span
    open on the runner thread; ``OUTSIDE`` where it is in none."""
    tid = runner_thread(spans)
    idle = _Cover(idle_intervals(busy, start, end))
    tot: Dict[str, int] = defaultdict(int)
    for a, b, name in innermost([s for s in spans
                                 if s["thread_id"] == tid]):
        n = idle.over(a, b)
        if n:
            tot[name] += n
    tot[OUTSIDE] = idle.pre[-1] - sum(tot.values())
    return dict(tot)


def idle_within(spans, name: str, busy: Sequence[Interval], start: int,
                end: int) -> int:
    """The card's idle nanoseconds in [start, end) while the runner
    thread is inside a span called ``name``."""
    tid = runner_thread(spans)
    idle = _Cover(idle_intervals(busy, start, end))
    return sum(idle.over(a, b) for a, b in _union(
        (s["start_ns"], s["end_ns"]) for s in spans
        if s["name"] == name and s["thread_id"] == tid))


def stage_parts_ms(spans) -> Dict[str, float]:
    """Milliseconds a staged epoch (the staging thread's ``runner.stage``
    spans; the bootstrap's are left out) of each ``stage.*`` part and of
    the whole stage."""
    stages = [s for s in spans if s["name"] == "runner.stage"
              and not s["attrs"].get("bootstrap")]
    if not stages:
        return {}
    tot: Dict[str, int] = defaultdict(int)
    for s in spans:
        if s["name"].startswith("stage.") and \
                not s["attrs"].get("bootstrap"):
            tot[s["name"]] += length_ns(s)
    tot["runner.stage"] = sum(length_ns(s) for s in stages)
    return {k: v / 1e6 / len(stages) for k, v in sorted(tot.items())}


def step_ms_by_overlap(spans) -> Dict[str, List[float]]:
    """``epoch.step`` lengths in ms, split by how a staging thread's
    ``runner.stage`` overlapped each: ``overlapped`` (the whole step),
    ``partly``, ``alone`` (none)."""
    tid = runner_thread(spans)
    stages = _Cover(_union((s["start_ns"], s["end_ns"]) for s in spans
                           if s["name"] == "runner.stage"
                           and s["thread_id"] != tid))
    out: Dict[str, List[float]] = {"overlapped": [], "partly": [],
                                   "alone": []}
    for s in spans:
        if s["name"] != "epoch.step":
            continue
        n = stages.over(s["start_ns"], s["end_ns"])
        key = ("alone" if n == 0 else "overlapped" if n == length_ns(s)
               else "partly")
        out[key].append(length_ns(s) / 1e6)
    return out


def per_kseed(n: float, seeds: float) -> Optional[float]:
    """``n`` per thousand seeds."""
    return n / (seeds / 1e3) if seeds > 0 else None


def spans_of(ctx, key: str) -> List[dict]:
    """The spans of the tracer export a Context carries under ``key``
    (``spans``: the whole-job traced pass; ``gap_spans``: the pass
    traced with the host's operators); [] where it carries none."""
    return (getattr(ctx, key, None) or {}).get("spans", [])
