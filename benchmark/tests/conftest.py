"""Shared pieces of the benchmark's own tests: the CPU cut of the cells
(benchmark/tests/cut/, the 320x240 scene and 10/4/256 window of
tests/test_torch_system.py), a run of it, and the `card` fixture of the
tests marked `gpu`.

    python -m pytest benchmark/tests -q               # on the CPU
    python -m pytest benchmark/tests -q -m gpu        # on the card"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
CUT = Path(__file__).resolve().parent / "cut"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cut_cell(config: str = "cut_vio", traffic: str = "cut_steady", limits_from: str = "euroc_mav"):
    """(spec, workload entry, configuration, traffic) of a cut cell: the
    benchmark's BENCHMARK.json, and the cut configuration holding the
    limits of the full-size configuration `limits_from`."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((CUT / f"{config}.json").read_text())
    full = json.loads((ROOT / "benchmark" / "configs" / f"{limits_from}.json").read_text())
    cfg["correct_limits"] = dict(full["correct_limits"])
    traffic_d = json.loads((CUT / f"{traffic}.json").read_text())
    wl = {"name": "euroc_mav_vio.steady", "config": config, "traffic": traffic, "chips": 1}
    return spec, wl, cfg, traffic_d


def run_cut(seed: int, seconds: int = 4, device: str = "cpu", fault=None, control=False,
            config: str = "cut_vio", traffic: str = "cut_steady"):
    """One run of the cut cell (harness.run_cell), small thread pools."""
    import torch

    from benchmark import harness

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return harness.run_cell("euroc_mav_vio.steady", seed, seconds, False, time.perf_counter(),
                                device=device, cell_data=cut_cell(config, traffic), fault=fault,
                                control=control)
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA card, or a skip with the reason."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
