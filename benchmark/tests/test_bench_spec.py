"""BENCHMARK.json against the benchmark's contract, and the discovery of
configurations, traffic files and metric readers by name."""

import re

import pytest

from benchmark import run
from benchmark.tests.helpers import ROOT, load, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    s = spec()
    assert set(s) == KEYS
    assert 1 <= len(s["command"]) <= 32 and all(map(_text_ok, s["command"]))
    assert s["paths"] == ["benchmark"]
    for p in s["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    n = len(s["workloads"])
    assert 2 + 14 * n * (s["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert 2 + 14 * 24 * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    s = spec()
    names = [e["name"] for e in s[section]]
    assert len(set(names)) == len(names)
    for e in s[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads", "per_layer"):
                assert _text_ok(e[key]), (e["name"], key)


def test_cells_configs_and_metrics_agree():
    s = spec()
    configs = {c["name"] for c in s["configs"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    cells = {c["name"] for c in s["workloads"]}
    pairs = {(c["config"], c["traffic"]) for c in s["workloads"]}
    assert len(pairs) == len(s["workloads"])
    assert {c["config"] for c in s["workloads"]} == configs
    for c in s["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1
        assert NAME.match(c["traffic"])
    assert "setup_s" in e2e
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in s["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        layers.setdefault(m["layer"], set()).add(m["name"])
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in s["per_layer"])
    for m in s["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_configs_and_traffic_found_by_name():
    s = spec()
    for c in s["configs"]:
        f = load(c["file"])
        assert c["file"].startswith("benchmark/configs/")
        assert f["name"] == c["name"]
        assert f["reduced"] == c["reduced"] and f["assumed"]
        assert (ROOT / "benchmark" / "programs"
                / f"{f['program']}.py").exists()
        assert set(f["limits"]) <= {"labels_mismatch", "prob_gap",
                                    "tables_mismatch", "drift_gap",
                                    "ids_mismatch"}
        for key in c["reduced"]:
            assert NAME.match(key) and key in f
    for cell in s["workloads"]:
        t = load(f"benchmark/traffic/{cell['traffic']}.json")
        assert t["generator"] == "voronoi_membranes"


@pytest.mark.parametrize("name", [m["name"] for m in spec()["end_to_end"]
                                  + spec()["per_layer"]])
def test_every_metric_has_a_reader(name):
    assert callable(run.reader(ROOT, name))


def test_reader_prefers_a_file_of_the_full_name(tmp_path):
    base = tmp_path / "benchmark" / "metrics"
    base.mkdir(parents=True)
    (base / "fam.py").write_text("def read(ctx, name):\n    return 1\n")
    (base / "fam.special.py").write_text("def read(ctx, name):\n    return 2\n")
    assert run.reader(tmp_path, "fam.other")(None, "fam.other") == 1
    assert run.reader(tmp_path, "fam.special")(None, "fam.special") == 2
    with pytest.raises(FileNotFoundError):
        run.reader(tmp_path, "nothing.here")


def test_file_names_under_paths():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = str(path.relative_to(ROOT))
        assert PATH.match(rel), rel
