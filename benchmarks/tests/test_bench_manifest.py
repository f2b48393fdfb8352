"""BENCHMARK.json and every file it names parse and keep to the contract:
the keys, the names and units, the files of each configuration, traffic,
limits and per-layer metric, the metrics each cell reports, and the chip
time of a full check."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    assert len(BENCH["command"]) <= 32 and all(LINE.match(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert LINE.match(entry[key]), (entry["name"], key)
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def test_setup_s():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0] and setup[0]["bound"] <= 0.25


def _reports(cell, metric):
    return cell in metric.get("workloads", [cell])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_and_metrics(cell):
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    configs = {c["name"]: c for c in BENCH["configs"]}
    cfg_file = ROOT / configs[w["config"]]["file"]
    assert cfg_file.relative_to(ROOT).parts[0] in BENCH["paths"]
    cfg = json.loads(cfg_file.read_text())
    assert cfg["name"] == w["config"] and cfg["source"] == configs[w["config"]]["source"]
    assert "assumed" in cfg
    traffic = json.loads((ROOT / "benchmarks/workloads" / f"{w['traffic']}.json").read_text())
    assert (ROOT / "benchmarks/modes" / f"{traffic['mode']}.py").is_file()
    limits = json.loads((ROOT / "benchmarks/limits" / f"{cell}.json").read_text())["limits"]
    assert limits and all(v > 0 for v in limits.values())
    e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(cell, m)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])
             or ("workloads" not in m and m["moves"] in e2e)]
    assert layer
    for m in layer:
        assert m["moves"] in e2e, (m["name"], cell)
        assert (ROOT / "benchmarks/metrics" / f"{m['name']}.py").is_file()


def test_every_config_used_and_metric_moves_exists():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", [])) <= cells


def test_file_names_under_paths():
    allowed = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            if "__pycache__" in f.parts:
                continue
            assert allowed.match(str(f.relative_to(ROOT))), f


def test_roofline_metrics_are_shares():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"] or m["name"].startswith("device_idle"):
            assert m["unit"] == "%"
