"""A dry run of the harness on the CPU at the cut configuration: the
result line has its keys (correct, attempted, failed, metrics, device)
and the cell's end-to-end metrics with BENCHMARK.json's units, every
number compared is printed beside its limit on the last lines, and the
JSON is strict (no NaN or
infinity). On the card (`gpu`), the same cut run through the card's
kernels."""

import json
import math

import pytest

from conftest import ROOT, run_cut

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _well_formed(res, platform):
    lines, extra = res.pop("_lines"), res.pop("_extra")
    line = json.dumps(res, allow_nan=False)
    back = json.loads(line)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True, back["checks"]
    assert back["attempted"] > 0 and back["failed"] == 0
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"]}
    assert set(back["metrics"]) == set(units)
    for name, m in back["metrics"].items():
        assert m["unit"] == units[name]
        assert math.isfinite(m["value"]) and m["value"] > 0
    dev = back["device"]
    assert dev["platform"] == platform and dev["count"] == 1
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert len(lines) == len(back["checks"])
    for line_, (name, c) in zip(lines, back["checks"].items()):
        assert line_.startswith(f"check {name} ") and "limit" in line_
        assert c["answers"] > 0
    assert extra["window_frames"] == back["attempted"]
    return back


def test_dry_run_on_the_cpu_prints_a_well_formed_line():
    _well_formed(run_cut(seed=2**45 + 17, seconds=3), "cpu")


@pytest.mark.gpu
def test_cut_run_on_the_card(card):
    back = _well_formed(run_cut(seed=2**45 + 19, seconds=3, device="cuda:0"), "gpu")
    assert back["device"]["memory_peak_bytes"] > 0
