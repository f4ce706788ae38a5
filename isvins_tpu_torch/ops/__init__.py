"""Hand-written Hopper kernels of the steady frame path (CUDA C++ under
csrc/, bound through ctypes) and their plain PyTorch versions.

| kernel     | wrapper                 | plain version                  | replaces (JAX)                        |
|------------|-------------------------|--------------------------------|---------------------------------------|
| K1         | proj.proj_rows          | solver.proj_fast.eval_proj_rows| ops/proj_pallas.proj_rows_pallas      |
| K2         | imu.imu_rows            | imu.imu_rows_ref               | ops/imu_pallas.imu_rows_pallas        |
| K3         | schur.schur_corr        | schur.schur_corr_ref           | ops/schur_pallas.schur_corr_pallas    |
| K4         | linstep.linstep         | linstep.linstep_ref            | ops/linstep_pallas.linstep_pallas     |

A wrapper given CPU tensors returns its plain version; given CUDA tensors it
launches its kernel or raises. Each wrapper counts its launches in a plain
integer attribute `<wrapper>.launches`.
"""

from .imu import imu_rows, imu_rows_ref  # noqa: F401
from .linstep import linstep, linstep_ref  # noqa: F401
from .proj import proj_rows  # noqa: F401
from .schur import schur_corr, schur_corr_ref  # noqa: F401

KERNELS = {
    "proj_rows": proj_rows,
    "imu_rows": imu_rows,
    "schur_corr": schur_corr,
    "linstep": linstep,
}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
