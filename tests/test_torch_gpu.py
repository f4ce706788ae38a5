"""The CUDA kernels K1-K4 of isvins_tpu_torch on the card, held against
their plain PyTorch versions on the same card inputs at the product shapes.

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch and CUDA:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Each test decides inside itself whether a card is present and skips with a
reason when there is none (deciding at import time would let xdist workers
collect different tests)."""

import pytest
import torch

from isvins_tpu_torch import ops
from isvins_tpu_torch.solver.proj_fast import eval_proj_rows

D = 276  # 15 B + 6 at the product window B = 18

# (kernel, plain version, rtol, atol(ref)): the tolerances of the reference's
# own kernel tests (tests/test_pallas_ops.py)
CASES = {
    "proj_rows": (ops.proj_rows, eval_proj_rows, 3e-4, lambda r: 1e-4),
    "imu_rows": (ops.imu_rows, ops.imu_rows_ref, 1e-5, lambda r: 2e-6 * float(r.abs().max())),
    "schur_corr": (ops.schur_corr, ops.schur_corr_ref, 2e-5, lambda r: 2e-3),
    "linstep": (ops.linstep, lambda *a: ops.linstep_ref(*a, D), 2e-3,
                lambda r: 2e-3 * float(r.abs().max())),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python -m pytest --noconftest -m gpu "
                    "tests/test_torch_gpu.py)")
    from isvins_tpu_torch.device import resolve_device

    return resolve_device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(name):
    """One launch of the kernel, counted once, equal to its plain version
    within the reference's tolerance."""
    dev = _card()
    import chip_smoke

    inp = chip_smoke.kernel_inputs(dev)[name]
    kern, plain, rtol, atol = CASES[name]
    before = ops.KERNELS[name].launches
    out = kern(*inp)
    torch.cuda.synchronize()
    assert ops.KERNELS[name].launches == before + 1
    for o, r in zip(out, plain(*inp)):
        torch.testing.assert_close(o, r, rtol=rtol, atol=atol(r))


@pytest.mark.gpu
def test_wrappers_raise_on_bad_cuda_input():
    """A CUDA tensor the kernel cannot take raises; nothing falls back."""
    dev = _card()
    x = torch.zeros((8, 3), dtype=torch.float64, device=dev)
    with pytest.raises(TypeError):  # f64
        ops.proj_rows(x, x, x, x[:, :3], x, x, x[0], x[0], x[:, 0], x[:, 0] > 0)
    W = torch.zeros((4, 50), dtype=torch.float32, device=dev).T  # not contiguous
    h = torch.ones(50, dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        ops.schur_corr(W, h, h)
    with pytest.raises(ValueError):  # wrong shape
        ops.schur_corr(W.contiguous(), h[:10], h)


@pytest.mark.gpu
def test_solve_window_on_card_runs_through_kernels():
    """An f32 window solve on the card launches K1/K2 once per evaluation
    and K3/K4 once per LM iteration, and reaches the cost of the plain
    solve on the CPU within 1e-3 relative (different summation orders in
    an f32 LM that is not converged after 10 iterations)."""
    dev = _card()
    from isvins_tpu_torch.parallel.sharded import make_batch_problem
    from isvins_tpu_torch.solver import WindowDims, solve_window

    dims = WindowDims(10, 4, 128, 512)

    def args(device):
        prob = make_batch_problem(1, dims, torch.float32, device=device)
        squeeze = lambda t: (type(t)(*(squeeze(x) for x in t)) if isinstance(t, tuple)
                             else t[0].contiguous())
        return [squeeze(x) for x in prob[:4]] + list(prob[4:])

    ops.reset_launch_counts()
    info = {}
    st, cost = solve_window(*args(dev), dims, iters=10, info=info)
    torch.cuda.synchronize()
    it = info["iterations"]
    assert ops.launch_counts() == {"proj_rows": it + 1, "imu_rows": it + 1,
                                   "schur_corr": it, "linstep": it}
    assert all(bool(torch.isfinite(a).all()) for a in st)
    _, cost_cpu = solve_window(*args("cpu"), dims, iters=10)
    assert abs(float(cost) - float(cost_cpu)) <= 1e-3 * float(cost_cpu)
