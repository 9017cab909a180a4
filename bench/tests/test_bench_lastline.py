"""The result line of a run driven on the CPU at a small size: its keys in
order, the cell's metrics by name and unit, the compared numbers last."""
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.testing import smoke_cell  # noqa: E402


@pytest.mark.parametrize("name,trace", [("olmo-1b.train_2k", True), ("rwkv6-1.6b-variant.train_4k", False),
                                        ("rwkv6-1.6b-variant.serve_code", False),
                                        ("rwkv6-1.6b-variant.serve_code", True)])
def test_last_line(name, trace):
    cell = smoke_cell(name, trace=trace)
    last, errs = harness.finish(harness.run_cell(cell), "a card, 700 W")
    line = json.loads(last)
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else [])
    assert list(line) == keys + ["card", "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    want = cell.per_layer() if trace else cell.end_to_end()
    units = {m["name"]: m["unit"] for m in want}
    assert set(line["metrics"]) <= set(units)
    if not trace:  # a CPU run has no device trace: the readers of device time find nothing
        assert set(line["metrics"]) == set(units)
    for m, v in line["metrics"].items():
        assert v["unit"] == units[m] and isinstance(v["value"], float) and v["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(cell.workload["limits"])
    for k, c in line["checks"].items():
        assert c["limit"] == cell.workload["limits"][k] and 0 <= c["value"] <= c["limit"]
    assert errs == [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in line["checks"].items()]
