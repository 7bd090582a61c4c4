"""``BENCHMARK.json`` and the data files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Everything that belongs to one of them, or to one per-layer
metric, is a file of its own under ``perfbench/``, found by name:

  * ``configs/<config>.json`` (the path the manifest gives),
  * ``traffic/<traffic>.json``,
  * ``metrics/<metric>.json``, which names its reader, a module
    ``readers/<reader>.py``,
  * ``limits/<cell>.json``, the limits of the comparison that decides
    ``correct`` in that cell.

So a later configuration, traffic mix, cell or metric is added by new
files and new entries, and no file here is edited for it.
"""
from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
END_TO_END_SOURCES = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]     # manifest entry + "spec" (its file)
    limits: Dict[str, float]
    root: Path


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: Path = ROOT) -> Dict[str, Any]:
    return _read(Path(root) / "BENCHMARK.json")


def _reports(metric: Dict[str, Any], cell: str,
             end_to_end_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in end_to_end_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    config = _read(root / configs[w["config"]]["file"])
    data = root / "perfbench"
    traffic = _read(data / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    per_layer = []
    for m in man["per_layer"]:
        if _reports(m, name, e2e_names):
            per_layer.append(dict(m, spec=_read(
                data / "metrics" / f"{m['name']}.json")))
    limits = _read(data / "limits" / f"{name}.json")
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, limits=limits, root=root)


def check_names(man: Dict[str, Any]) -> List[str]:
    """The manifest's names, units and sources against the contract's
    character sets -> a list of problems (empty when sound)."""
    bad: List[str] = []

    def name(x: Optional[str], what: str):
        if not isinstance(x, str) or not NAME_RE.fullmatch(x):
            bad.append(f"{what}: bad name {x!r}")

    for c in man["configs"]:
        name(c["name"], "config")
        for k in c["reduced"]:
            name(k, f"config {c['name']} reduced")
    for w in man["workloads"]:
        name(w["name"], "workload")
        name(w["config"], f"workload {w['name']} config")
        name(w["traffic"], f"workload {w['name']} traffic")
        if w["chips"] not in (1, 4):
            bad.append(f"workload {w['name']}: chips {w['chips']}")
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            name(m["name"], group)
            if not UNIT_RE.fullmatch(m["unit"]):
                bad.append(f"{group} {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"{group} {m['name']}: better {m['better']!r}")
            ok = END_TO_END_SOURCES if group == "end_to_end" else SOURCES
            if m["source"] not in ok:
                bad.append(f"{group} {m['name']}: source {m['source']!r}")
    return bad
