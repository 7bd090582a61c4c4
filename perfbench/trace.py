"""Reading a ``torch.profiler`` trace of a slice of the run.

``collect_device`` reads a trace of the card's activity alone over a
span whose wall the caller measured. ``collect`` reads one with the
host's operators too, whose slice is the host interval of a
``record_function`` marker. From the device activities (kernels,
copies, memsets) inside the slice:
the union of their intervals (the device's busy time), the time of
kernels by name, the device operations that took most time, and the
idle gaps between busy intervals, each named by what the host was
doing when the gap closed: the PyTorch operator that launched the next
device activity, or ``launch <kernel>`` for a kernel launched outside
any operator (the port's own kernels go out through ``ctypes``).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

SLICE = "perfbench.slice"


def base_name(name: str) -> str:
    """A kernel's own name: the identifier before its template or
    argument list, without namespaces or a return type
    (``void ns::gather_agg_kernel<4, 8>(...)`` -> ``gather_agg_kernel``)."""
    head = name.replace("(anonymous namespace)", "anonymous")
    for stop in ("<", "("):
        i = head.find(stop)
        if i > 0:
            head = head[:i]
    head = head.split()[-1] if head.split() else head
    return head.split("::")[-1]


@dataclasses.dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int
    host_op: str        # what launched it ("" when unknown)


@dataclasses.dataclass
class TraceData:
    window_s: float
    events: List[DeviceEvent]       # clipped to the slice

    def busy_intervals(self) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for e in sorted(self.events, key=lambda e: e.start_ns):
            if out and e.start_ns <= out[-1][1]:
                if e.end_ns > out[-1][1]:
                    out[-1] = (out[-1][0], e.end_ns)
            else:
                out.append((e.start_ns, e.end_ns))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def kernel_seconds(self, names: Iterable[str]) -> float:
        want = set(names)
        return sum(e.end_ns - e.start_ns for e in self.events
                   if base_name(e.name) in want) * 1e-9

    def device_ops(self, top: int = 10) -> List[List]:
        tot: Dict[str, int] = defaultdict(int)
        for e in self.events:
            tot[e.name[:160]] += e.end_ns - e.start_ns
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-9] for k, v in best]

    def idle_gaps(self, slice_start: int, slice_end: int,
                  top: int = 10) -> List[List]:
        """Idle seconds summed by what the host launched next."""
        evs = sorted(self.events, key=lambda e: e.start_ns)
        tot: Dict[str, int] = defaultdict(int)
        edge, i = slice_start, 0
        for a, b in self.busy_intervals():
            while evs[i].start_ns < a:
                i += 1
            if a > edge:
                e = evs[i]
                tot[e.host_op or f"launch {base_name(e.name)}"] += a - edge
            edge = max(edge, b)
        if slice_end > edge:
            tot["after the last device activity"] += slice_end - edge
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[k, v * 1e-9] for k, v in best]


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return (e.device_type() == DeviceType.CUDA and e.name() != SLICE
            and not (hasattr(e, "is_user_annotation")
                     and e.is_user_annotation()))


def collect_device(prof, wall_s: float) -> TraceData:
    """Every device activity of a trace taken over a span of
    ``wall_s`` seconds, unclipped (the trace holds that span alone)."""
    return TraceData(window_s=wall_s, events=[
        DeviceEvent(name=e.name(), start_ns=e.start_ns(),
                    end_ns=e.start_ns() + e.duration_ns(), host_op="")
        for e in prof.profiler.kineto_results.events() if _is_device(e)])


def collect(prof) -> Tuple[TraceData, int, int]:
    """-> (the slice's trace, slice start ns, slice end ns)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    ops: Dict[int, str] = {}
    dev = []
    start = end = None
    for e in events:
        dt = e.device_type()
        if dt == DeviceType.CPU:
            if e.name() == SLICE:
                start = e.start_ns()
                end = start + e.duration_ns()
                ops[e.correlation_id()] = ""
            elif e.linked_correlation_id() == 0:
                ops[e.correlation_id()] = e.name()
        elif _is_device(e):
            dev.append(e)       # kernels, copies, memsets; no ranges
    if start is None:
        raise RuntimeError(f"the trace has no {SLICE!r} marker")
    out = []
    for e in dev:
        a = max(e.start_ns(), start)
        b = min(e.start_ns() + e.duration_ns(), end)
        if b > a:
            out.append(DeviceEvent(name=e.name(), start_ns=a, end_ns=b,
                                   host_op=ops.get(e.linked_correlation_id(),
                                                   "")))
    return TraceData(window_s=(end - start) * 1e-9, events=out), start, end
