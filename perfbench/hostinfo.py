"""Readings of the host around a span of the run, from this process and
from ``/proc`` (read only): what the process spent (CPU seconds,
context switches), what the machine's CPUs spent in all and lost to
the hypervisor (steal), their clock, and where the process may run.
They explain a rate that swings; no metric is read from them."""
from __future__ import annotations

import os
import resource
import time
from typing import Dict, List


def _proc_stat() -> List[int]:
    """The aggregate ``cpu`` line of ``/proc/stat`` in clock ticks: user,
    nice, system, idle, iowait, irq, softirq, steal, ..."""
    try:
        with open("/proc/stat") as f:
            return [int(x) for x in f.readline().split()[1:]]
    except OSError:
        return []


def _mhz() -> List[float]:
    try:
        with open("/proc/cpuinfo") as f:
            return [float(l.split(":")[1]) for l in f
                    if l.startswith("cpu MHz")]
    except OSError:
        return []


def snapshot() -> Dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "user": ru.ru_utime,
            "sys": ru.ru_stime, "vcs": ru.ru_nvcsw, "ivcs": ru.ru_nivcsw,
            "stat": _proc_stat(), "mhz": _mhz()}


def delta(a: Dict, b: Dict) -> Dict[str, float]:
    """What passed from snapshot ``a`` to ``b``: the process's CPU
    seconds and context switches, and the machine's busy and steal
    seconds summed over its CPUs, and its mean clock at ``b``."""
    hz = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100
    out = {"wall_s": b["t"] - a["t"], "cpu_s": (b["user"] - a["user"])
           + (b["sys"] - a["sys"]), "ctx_vol": b["vcs"] - a["vcs"],
           "ctx_invol": b["ivcs"] - a["ivcs"]}
    if a["stat"] and b["stat"]:
        d = [y - x for x, y in zip(a["stat"], b["stat"])]
        out["machine_busy_s"] = (d[0] + d[1] + d[2] + d[5] + d[6]) / hz
        out["machine_steal_s"] = (d[7] if len(d) > 7 else 0) / hz
    if b["mhz"]:
        out["mhz_mean"] = sum(b["mhz"]) / len(b["mhz"])
    return out


def layout() -> Dict:
    """The CPUs this process may use, and the SMT siblings of each."""
    out: Dict = {"cpus": os.cpu_count()}
    if hasattr(os, "sched_getaffinity"):
        out["affinity"] = sorted(os.sched_getaffinity(0))
    sib = []
    for c in out.get("affinity", []):
        try:
            with open(f"/sys/devices/system/cpu/cpu{c}/topology/"
                      "thread_siblings_list") as f:
                sib.append(f.read().strip())
        except OSError:
            break
    if sib:
        out["siblings"] = sorted(set(sib))
    return out
