"""A benchmark root for tests: a copy of ``BENCHMARK.json`` and the
benchmark's data files in a temporary directory, with a tiny cell added
the way a later change adds one, by new files and new entries only."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from perfbench.manifest import ROOT

#: the tiny cell's limits: exact numbers 0, training numbers well above
#: what a sound CPU run reads (under 1e-5) and well below each planted
#: fault's reading
TINY_LIMITS = {"partition_mismatch": 0, "schedule_mismatch": 0,
               "hot_set_mismatch": 0, "miss_rows_gap": 0,
               "wire_rows_short": 0, "loss_gap": 1e-4, "moment_gap": 1e-4,
               "update_gap": 1e-4, "update_diff": 1e-4}

TINY = {"dataset": "tiny", "num_nodes": 1000, "avg_degree": 8.0,
        "feat_dim": 32, "num_classes": 8, "num_clusters": 8, "zipf_a": 1.0,
        "p_intra": 0.7, "train_frac": 0.5, "hidden_dim": 32, "n_hot": 64,
        "epochs": 3}


def copy_root(dst: Path) -> Path:
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"),
                    dirs_exist_ok=True)
    return dst


def first_config(root: Path) -> str:
    """The configuration of the manifest's first cell."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    return man["workloads"][0]["config"]


def add_cell(root: Path, config: str, traffic: str, *, config_over: dict,
             traffic_spec: dict, limits: dict, base_config: str = "",
             metrics=None) -> str:
    """New config, traffic and limits files and a new cell entry; the
    config starts from ``base_config`` (by default the first cell's);
    the per-layer metrics that list their cells get the new cell
    appended to that list (a new entry's field, no file edited). -> the
    cell's name."""
    data = root / "perfbench"
    man = json.loads((root / "BENCHMARK.json").read_text())
    base_config = base_config or first_config(root)
    cfg = json.loads((data / "configs" / f"{base_config}.json").read_text())
    cfg.update(config_over)
    (data / "configs" / f"{config}.json").write_text(json.dumps(cfg))
    (data / "traffic" / f"{traffic}.json").write_text(
        json.dumps(traffic_spec))
    name = f"{config}.{traffic}"
    (data / "limits" / f"{name}.json").write_text(json.dumps(limits))
    if config not in {c["name"] for c in man["configs"]}:
        man["configs"].append({"name": config, "source": "test",
                               "file": f"perfbench/configs/{config}.json",
                               "reduced": [], "why": "a test"})
    man["workloads"].append({"name": name, "config": config,
                             "traffic": traffic, "chips": 1, "why": "test"})
    for m in man["per_layer"]:
        if "workloads" in m and (metrics is None or m["name"] in metrics):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return name


def tiny_root(dst: Path, schedule: str = "ahead") -> tuple:
    """-> (root, cell) of a tiny GraphSAGE cell on a 1,000-node graph."""
    root = copy_root(dst)
    cell = add_cell(root, "sage-tiny", f"b64-{schedule}",
                    config_over=TINY,
                    traffic_spec={"batch_size": 64, "schedule": schedule,
                                  "compiler": "device", "check_epochs": 1},
                    limits=TINY_LIMITS)
    return root, cell
