"""Hand-written Hopper kernels of the port (CUDA C++ under csrc/, bound
through ctypes) and their plain PyTorch versions.

| kernel     | wrapper                    | plain version                  | replaces (JAX)                           |
|------------|----------------------------|--------------------------------|------------------------------------------|
| K1         | proj.proj_rows             | proj.proj_rows_ref             | ops/proj_pallas.proj_rows_pallas         |
| K2         | imu.imu_rows               | imu.imu_rows_ref               | ops/imu_pallas.imu_rows_pallas           |
| K3         | schur.schur_corr           | schur.schur_corr_ref           | ops/schur_pallas.schur_corr_pallas       |
| K4         | linstep.linstep            | linstep.linstep_ref            | ops/linstep_pallas.linstep_pallas        |
| K5         | chol_batched.chol_solve_batched | chol_batched.chol_solve_batched_ref | ops/linstep_pallas.chol_solve_batched_pallas |
| K6         | hamming.retrieval_scores   | hamming.retrieval_scores_ref   | ops/hamming_pallas.retrieval_scores_pallas |
| K7         | schur.schur_reduce         | schur.schur_reduce_ref         | ops/schur_pallas.schur_reduce_pallas     |

K1-K4 run in the estimator's steady solve; K1, K2 and K5 in the batched
multi-sequence solve (solver.solve_window_batched through
linstep.linstep_batched); K6 in the pose graph's keyframe retrieval
(posegraph/keyframe_db.KeyframeDB.query); K7 has no caller in the package,
as its TPU kernel has none. A wrapper given CPU
tensors returns its plain version; given CUDA tensors it launches its kernel
or raises. Each wrapper counts its launches in a plain integer attribute
`<wrapper>.launches`.

On the CPU the plain versions are held against the JAX package
(`python -m pytest tests/test_torch_ops.py tests/test_torch_parallel.py`,
the latter for K5, K7 and the batched step). On the card
`python3 chip_smoke.py` builds the kernels and holds each against its plain
version (phase `kernels`), then drives them: K1-K4 in `solve`, `slice` and
`posegraph`, K6 in `posegraph`, K1, K2 and K5 in `multiseq`, K7 and K5 in
`reduce`; `python -m pytest --noconftest -m gpu tests/test_torch_gpu.py`
runs the kernel tests there.
"""

from .chol_batched import chol_solve_batched, chol_solve_batched_ref  # noqa: F401
from .hamming import retrieval_scores, retrieval_scores_ref  # noqa: F401
from .imu import imu_rows, imu_rows_ref  # noqa: F401
from .linstep import linstep, linstep_batched, linstep_ref  # noqa: F401
from .proj import proj_rows, proj_rows_ref  # noqa: F401
from .schur import schur_corr, schur_corr_ref, schur_reduce, schur_reduce_ref  # noqa: F401

KERNELS = {
    "proj_rows": proj_rows,
    "imu_rows": imu_rows,
    "schur_corr": schur_corr,
    "linstep": linstep,
    "chol_solve_batched": chol_solve_batched,
    "retrieval_scores": retrieval_scores,
    "schur_reduce": schur_reduce,
}

# the kernels the estimator's steady solve launches, and those of the
# batched multi-sequence solve (K6 is the pose graph's)
SOLVE_KERNELS = ("proj_rows", "imu_rows", "schur_corr", "linstep")
BATCHED_SOLVE_KERNELS = ("proj_rows", "imu_rows", "chol_solve_batched")


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
