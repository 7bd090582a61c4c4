"""The manifest against the benchmark's contract, and every file it
names present under ``perfbench/``."""
import json
import re

import pytest

from perfbench import manifest
from perfbench.harness import load_reader

MAN = manifest.load_manifest()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|(_dim|_rank)$|feat|fanout|classes")


def test_top_level_keys_and_command():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_units_sources():
    assert manifest.check_names(MAN) == []


@pytest.mark.parametrize("bad", ["has space", "a/b", "é", "-lead", "x" * 65])
def test_name_rule_refuses(bad):
    assert not manifest.NAME_RE.fullmatch(bad)


@pytest.mark.parametrize("unit", ["tokens per second", "µs", "x" * 17])
def test_unit_rule_refuses(unit):
    assert not manifest.UNIT_RE.fullmatch(unit)


def test_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert set(e2e) == {"train_seeds_per_s", "setup_s"}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in manifest.END_TO_END_SOURCES


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_and_metrics(cell):
    c = manifest.load_cell(cell)
    assert c.chips == 1
    assert {m["name"] for m in c.end_to_end} == {"train_seeds_per_s",
                                                  "setup_s"}
    assert len(c.per_layer) == 10
    for m in c.per_layer:
        assert m["moves"] == "train_seeds_per_s"
        assert hasattr(load_reader(manifest.ROOT, m["spec"]["reader"]),
                       "read")
    for k, v in c.limits.items():
        assert v >= 0, k
    assert c.traffic["schedule"] in ("ahead", "lazy")


@pytest.mark.parametrize("entry", MAN["configs"], ids=lambda e: e["name"])
def test_config_reduced_keys(entry):
    cfg = json.loads((manifest.ROOT / entry["file"]).read_text())
    assert entry["file"].startswith("perfbench/")
    for k in entry["reduced"]:
        assert k in cfg, k
        assert not WIDTH.search(k), k
    for k in ("feat_dim", "num_classes"):
        assert cfg[k] == cfg["published"][k]
    assert cfg["hidden_dim"] == 256 and cfg["fanouts"] == [25, 10]


def test_files_are_named_by_names():
    ok = re.compile(r"[A-Za-z0-9_.\-/]+")
    for p in (manifest.ROOT / "perfbench").rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert ok.fullmatch(str(p.relative_to(manifest.ROOT))), p
    assert len(json.dumps(MAN).encode()) < 64 * 1024
