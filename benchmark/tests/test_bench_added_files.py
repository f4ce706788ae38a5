"""What a later configuration brings as new files and new BENCHMARK.json
entries, on the CPU: a kernel's roofline with its work as a function of
the window's shapes, the launches under a span of its own
(spans.launches_under), the solver's `_proj_ops` alias reading through to
ops.proj while the capture is installed, and a per-layer metric added
with its reader and a test of its own passing the readers' checks."""

import copy
import importlib
import importlib.util
import sys
import types

import pytest
import torch

from benchmark import harness, spans
from benchmark.capture import Captures
from benchmark.metrics import common

import test_bench_metrics as readers
import test_bench_spans as hand


def _k1_work(shapes):
    """K1's work as a later reader would keep it in its own file."""
    N = shapes["N"]
    return N * ((21 + 28) * 4 + 1) + 7 * 4, 600 * N


def test_roofline_takes_the_kernels_work_as_a_function():
    sh = common.window_shapes(readers.EUROC)
    assert common.kernel_bound_s(_k1_work, sh) == common.kernel_bound_s("proj_rows", sh)
    ctx = readers._full_ctx()
    by_name = common.roofline_pct(ctx, "proj_rows", ("proj_rows_kernel",), "proj_rows_kernel")
    by_work = common.roofline_pct(ctx, _k1_work, ("proj_rows_kernel",), "proj_rows_kernel")
    assert by_work == by_name == harness.load_reader("k1_proj_rows_roofline")(ctx)
    assert common.roofline_pct(readers._ctx(), _k1_work, ("proj_rows_kernel",),
                               "proj_rows_kernel") is None
    with pytest.raises(KeyError):
        common.kernel_work("proj_rows_ex", sh)  # a name kernel_work does not know


def test_launches_under_a_span_prefix():
    ctx = hand._ctx(excluded={"sys.frame": [(2, 3)]})
    assert spans.launches_under(ctx, "est.") == 1.5
    assert spans.launches_under(ctx, "est.") == harness.load_reader("est_launches_per_frame")(ctx)
    assert spans.launches_under(ctx, "trk.") == harness.load_reader("trk_launches_per_frame")(ctx)
    # a child span's prefix alone: est.solve_device's two launches, est.marginalize's one
    assert spans.launches_under(ctx, "est.solve") == 2 / 2
    assert spans.launches_under(ctx, "est.marginalize") == 1 / 2
    # the frame thread's calls alone: est.marg_job's on the marginalization
    # worker and the pose-graph worker's pg.* are not counted
    assert spans.launches_under(ctx, "est.marg") == 1 / 2
    assert spans.launches_under(ctx, "pg.") == 0
    bare = hand._ctx()
    bare["trace"]["host_events"] = [e for e in hand._host() if not e[2].startswith(hand.perf.ANCHOR)]
    assert spans.launches_under(bare, "est.") is None  # no anchor: nothing joined
    assert spans.launches_under({"trace": None}, "est.") is None


class _Estimator:
    def _install_solution(self, *args):
        return None

    def _marg_compute(self, *args):
        return None


class _Tracker:
    def collect(self):
        return {}


def _rows_args(n=5):
    g = torch.Generator().manual_seed(3)
    pts_i = torch.cat([torch.randn(n, 2, generator=g) * 0.2, torch.ones(n, 1)], 1)
    pts_j = torch.cat([torch.randn(n, 2, generator=g) * 0.2, torch.ones(n, 1)], 1)
    q = torch.nn.functional.normalize(torch.randn(4, n, 4, generator=g), dim=-1)
    P = torch.randn(2, n, 3, generator=g) * 0.1
    return (pts_i, pts_j, P[0], q[0], P[1], q[1], torch.zeros(3), torch.tensor([0.0, 0, 0, 1]),
            torch.rand(n, generator=g) + 0.2, torch.ones(n, dtype=torch.bool))


def test_capture_alias_reads_every_other_name_through_to_ops_proj(monkeypatch):
    from isvins_tpu_torch.ops import proj as proj_mod
    from isvins_tpu_torch.solver import window as win_mod

    before = {n: getattr(win_mod, n) for n in ("_proj_ops", "imu_rows", "linstep",
                                               "build_normal_equations",
                                               "projection_residual_jacobians")}
    cap = Captures(types.SimpleNamespace(estimator=_Estimator(), tracker=_Tracker(),
                                         pgbuilder=None))
    cap.install()
    try:
        alias = win_mod._proj_ops
        public = [n for n in dir(proj_mod) if not n.startswith("_") and n != "proj_rows"]
        assert "proj_rows_ref" in public
        for n in public:
            assert getattr(alias, n) is getattr(proj_mod, n), n
        # a function added to ops.proj later is reached through the alias as it is
        monkeypatch.setattr(proj_mod, "proj_rows_ex", lambda *a: a, raising=False)
        assert alias.proj_rows_ex is proj_mod.proj_rows_ex
        with pytest.raises(AttributeError):
            getattr(alias, "no_such_function")
        # proj_rows is K1's wrapper: the module's outputs, copied at the picked call
        assert alias.proj_rows is not proj_mod.proj_rows
        args = _rows_args()
        for a, b in zip(alias.proj_rows(*args), proj_mod.proj_rows(*args)):
            assert torch.equal(a, b)
        assert cap.kernels["proj_rows"] == []  # not armed: nothing copied
        cap.armed, cap._pick, cap._calls = True, {"proj_rows": 0}, {}
        out = alias.proj_rows(*args)
        assert len(cap.kernels["proj_rows"]) == 1
        assert torch.equal(cap.kernels["proj_rows"][0]["out"][0], out[0])
    finally:
        cap.uninstall()
    assert win_mod._proj_ops is proj_mod
    assert win_mod._proj_ops.proj_rows is proj_mod.proj_rows
    assert {n: getattr(win_mod, n) for n in before} == before


READER = '''"""zz_added_launches_per_frame: the launches under est.solve_device."""

from benchmark import spans


def read(ctx):
    return spans.launches_under(ctx, "est.solve")
'''


def test_an_added_metric_passes_the_readers_checks_with_a_test_of_its_own(tmp_path, monkeypatch):
    """A per-layer entry added in a copy of the spec (BENCHMARK.json is
    not written), its reader in a file of its own and a test file that
    reads it pass the readers' checks; without that test file, or with
    one that only names the metric, they fail."""
    import benchmark.metrics as metrics

    name = "zz_added_launches_per_frame"
    (tmp_path / "readers").mkdir()
    (tmp_path / "readers" / f"{name}.py").write_text(READER)
    own = tmp_path / "test_zz_added.py"
    own.write_text("from benchmark import harness\n\nimport test_bench_spans as hand\n\n\n"
                   "def test_reading():\n"
                   f"    assert harness.load_reader('{name}')(hand._ctx()) == 1.0\n")
    # a file that only names the metric, in a comment, reads nothing
    named = tmp_path / "test_zz_named.py"
    named.write_text(f"# {name}: load_reader is called elsewhere\n")
    monkeypatch.setattr(metrics, "__path__", [*metrics.__path__, str(tmp_path / "readers")])
    importlib.invalidate_caches()
    spec = copy.deepcopy(readers.SPEC)
    spec["per_layer"].append({"name": name, "unit": "launches/frame", "better": "lower",
                              "source": "device_trace", "layer": "estimator",
                              "moves": "frames_per_s", "workloads": ["euroc_mav_vio.steady"]})
    names = [m["name"] for m in spec["per_layer"]]
    # the test files but this one, which names the metric
    others = [f for f in readers.other_test_files() if f.name != "test_bench_added_files.py"]
    try:
        assert set(readers.WANT) <= set(names)
        assert all(readers.reads_none_on_nothing(n) for n in names)
        assert readers.readers_without_a_test(names, others + [own]) == []
        assert readers.readers_without_a_test(names, others) == [name]
        assert readers.readers_without_a_test(names, others + [named]) == [name]
        # a span reader: held to the None-where-nothing cases, the clocks' join included
        assert hand._reads_spans(importlib.import_module(f"benchmark.metrics.{name}"), set())
        assert hand._reads_the_join(name)
        hand._reads_none_where_there_is_nothing(name)
        # the added test file runs and reads the metric's value
        mod = importlib.util.module_from_spec(importlib.util.spec_from_file_location("zz", own))
        mod.__spec__.loader.exec_module(mod)
        mod.test_reading()
    finally:
        sys.modules.pop(f"benchmark.metrics.{name}", None)
