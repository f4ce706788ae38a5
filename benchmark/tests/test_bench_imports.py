"""What a run may load, on the CPU.

- harness.forbidden_modules compares whole top-level names: `jax.numpy`,
  `jaxlib`, `flax.linen`, `isvins_tpu.config` and the repository's
  top-level scripts are caught; `isvins_tpu_torch.system`, whose name
  begins with the JAX package's, and `jaxtyping` are not;
- importing the harness, the readers, the reference and the port's System,
  as a run does, loads none of them (a fresh interpreter);
- the reference imports nothing of the port;
- `python3 -m benchmark.run` prints no result and exits non-zero without a
  CUDA card, and in a directory that holds only BENCHMARK.json and
  benchmark/."""

import shutil
import subprocess
import sys

import pytest

from benchmark import harness

from conftest import ROOT


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("isvins_tpu", True), ("isvins_tpu.config", True), ("chip_smoke", True),
    ("bench", True), ("realism_reference", True),
    ("isvins_tpu_torch", False), ("isvins_tpu_torch.system", False), ("jaxtyping", False),
    ("benchmark.run", False), ("numpy", False)])
def test_forbidden_by_whole_top_level_name(name, bad):
    assert (harness.forbidden_modules({name: None}) == [name]) is bad


def _fresh(code: str, cwd=ROOT):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_a_run_loads_no_forbidden_module():
    r = _fresh("import sys; sys.path.insert(0, '.')\n"
               "from benchmark import harness, capture, trace, control\n"
               "from benchmark.reference import check\n"
               "import benchmark.metrics.common\n"
               "for m in ('trk_dispatch_ms_p50', 'k4_linstep_roofline'): harness.load_reader(m)\n"
               "from isvins_tpu_torch.system import System\n"
               "import isvins_tpu_torch.posegraph.builder, isvins_tpu_torch.estimator.estimator\n"
               "print(harness.forbidden_modules())")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    r = _fresh("import sys; sys.path.insert(0, '.')\n"
               "import benchmark.reference.check, benchmark.reference.precision\n"
               "print(sorted(m for m in sys.modules if m.split('.')[0] in "
               "('isvins_tpu_torch', 'isvins_tpu', 'jax')))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "euroc_mav.revisit",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_run_in_a_bare_checkout_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "euroc_mav.revisit",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
