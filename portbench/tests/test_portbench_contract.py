"""BENCHMARK.json against the benchmark's contract, and the harness's
files found by name."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)


def test_entry_keys_and_texts():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    texts = ([c["source"] for c in BENCH["configs"]]
             + [x["why"] for x in BENCH["configs"] + BENCH["workloads"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len({c["source"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(m, w["name"]) and m["moves"] in e2e
                   for m in BENCH["per_layer"])


def test_moves_is_reported_by_each_of_its_cells():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", sorted(cells)):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def _has_def(path: Path, name: str) -> bool:
    tree = ast.parse(path.read_text())
    return any(isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == name
               for n in tree.body)


def test_files_found_by_name():
    """Each part of a cell is a file named in its configuration or its
    mix, with the entry ``run.py`` calls."""
    here = ROOT / "portbench"
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/configs/")
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in cfg["reduced"])
        assert _has_def(here / "generators" / f"{cfg['generator']}.py", "make")
        assert (here / "marginals" / f"{cfg['table']}.json").is_file()
        assert _has_def(here / "builds" / f"{cfg['build']}.py", "build")
        assert _has_def(here / "reference" / f"{cfg['reference']}.py", "truth")
        assert _has_def(here / "checks" / f"{cfg['check']}.py", "judge")
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        mix = json.loads((here / "traffic" / f"{w['traffic']}.json").read_text())
        assert _has_def(here / "modes" / f"{mix['mode']}.py", "Driver")
    for m in METRICS:
        assert _has_def(here / "metrics" / f"{m['name']}.py", "read")


def test_per_layer_metrics_of_one_layer_agree():
    layers = {m["layer"] for m in BENCH["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


@pytest.mark.parametrize("name", [m["name"] for m in METRICS
                                  if m["unit"] == "%"])
def test_shares_are_named_as_shares(name):
    assert name.endswith(("_roofline", "_share"))
