"""Import-time contract of the PyTorch port: no JAX, full-precision matmuls,
and kernel wrappers that take the plain route for CPU tensors."""

import subprocess
import sys
from pathlib import Path

import torch

from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib, kernels


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import slam_uwv_kalman_filters_tpu_torch\n"
        "from slam_uwv_kalman_filters_tpu_torch.models import fleet_setup, monte_carlo, pose_driver, "
        "pose_fused, pose_ukf, pose_update_fused, velocity_fused, velocity_ukf\n"
        "from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib, dynamics, geodesy, kernels, "
        "linalg_small, manifolds, ukf\n"
        "from slam_uwv_kalman_filters_tpu_torch.parallel import bank\n"
        "from slam_uwv_kalman_filters_tpu_torch import runtime\n"
        "from slam_uwv_kalman_filters_tpu_torch.utils import config, convert, device, memo, validation\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'slam_uwv_kalman_filters_tpu.')) or m in ('slam_uwv_kalman_filters_tpu', 'icra18_mission'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_full_precision_matmuls_after_import():
    import slam_uwv_kalman_filters_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cpu_tensor_takes_plain_route_without_counting():
    cuda_lib.reset_launch_counts()
    a = torch.randn(5, 12, 12, dtype=torch.float64)
    cov = a @ a.transpose(1, 2) + 12 * torch.eye(12, dtype=torch.float64)
    out = kernels.sigma_deltas_banked(cov)
    torch.testing.assert_close(out, kernels.sigma_deltas_plain(cov), rtol=0, atol=0)
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())
    assert "lib" not in cuda_lib._STATE  # nothing was built or loaded
