"""The benchmark of isvins_tpu_torch (see run.py and BENCHMARK.json)."""
