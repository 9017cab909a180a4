"""BENCHMARK.json against the benchmark's contract, and every cell,
configuration, traffic mix and per-layer metric found by its name."""
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "bench/run.py"] and len(SPEC["command"]) <= 32
    assert 1 <= len(SPEC["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell, 1200 s spare
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == want, (group, e["name"])
            assert NAME.match(e["name"])
            for text in ("why", "layer", "source"):
                if text in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    metrics = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert not metrics & set(CELLS)


def test_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(CELLS)
        assert all(c in e2e[m["moves"]].get("workloads", CELLS) for c in m["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_and_files(cell):
    c = harness.load_cell(cell)
    e2e = [m["name"] for m in c.end_to_end()]
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer()
    assert c.entry["chips"] in (1, 4) and 1 <= len(c.entry["why"]) <= 200
    assert c.config["name"] == c.entry["config"] and c.traffic["name"] == c.entry["traffic"]
    assert (ROOT / "bench" / "traffic" / f"{c.traffic['kind']}.py").exists()
    assert set(c.workload["limits"]) and all(v > 0 for v in c.workload["limits"].values())
    assert c.workload["config"] == c.entry["config"] and c.workload["traffic"] == c.entry["traffic"]
    for m in c.per_layer():
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("conf", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    path = ROOT / conf["file"]
    assert path.parts[len(ROOT.parts)] == "bench" and path.exists()
    data = json.loads(path.read_text())
    assert data["name"] == conf["name"] and data["source"] == conf["source"]
    assert set(conf["reduced"]) == set(data["reduced"])
    assert (ROOT / "bench" / "reference" / f"{data['reference']}.py").exists()
    assert any(w["config"] == conf["name"] for w in SPEC["workloads"])


def test_a_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A cell, a traffic mix and a per-layer metric added as new files and
    entries load and run with no edit to any file already there."""
    shutil.copytree(ROOT / "bench", tmp_path / "bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "olmo-1b.train_short", "config": "olmo-1b", "traffic": "train_short",
                              "chips": 1, "why": "a test's cell"})
    spec["per_layer"].append({"name": "steps_traced", "unit": "count", "better": "higher", "source": "device_trace",
                              "layer": "train step", "moves": "train_tokens_per_s",
                              "workloads": ["olmo-1b.train_short"]})
    spec["end_to_end"][0]["workloads"].append("olmo-1b.train_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = json.loads((ROOT / "bench" / "traffic" / "train_2k.json").read_text())
    (tmp_path / "bench" / "traffic" / "train_short.json").write_text(json.dumps({**mix, "name": "train_short"}))
    cell = json.loads((ROOT / "bench" / "workloads" / "olmo-1b.train_2k.json").read_text())
    (tmp_path / "bench" / "workloads" / "olmo-1b.train_short.json").write_text(json.dumps(
        {**cell, "name": "olmo-1b.train_short", "traffic": "train_short"}))
    (tmp_path / "bench" / "metrics" / "steps_traced.py").write_text("def read(ctx):\n    return ctx['steps']\n")
    from bench.testing import ARCH, TRAFFIC
    import torch
    cell = harness.load_cell("olmo-1b.train_short", root=tmp_path, seed=5, seconds=0.1, trace=True,
                             device=torch.device("cpu"),
                             overrides={"config": {"arch": ARCH}, "traffic": TRAFFIC["train"]})
    assert [m["name"] for m in cell.per_layer()] == ["steps_traced"]
    line = harness.run_cell(cell)
    assert line["metrics"]["steps_traced"]["value"] == cell.traffic["trace_steps"]
