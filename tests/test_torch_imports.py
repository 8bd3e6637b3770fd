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
        "from slam_uwv_kalman_filters_tpu_torch.models import bottom_fused, bottom_ukf, fleet_setup, indirect_fused, "
        "indirect_pose_ukf, monte_carlo, pose_driver, pose_fused, pose_marker_fused, pose_smoother, pose_ukf, "
        "pose_update_fused, velocity_fused, velocity_ukf\n"
        "from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib, dynamics, geodesy, kernels, "
        "linalg_small, manifolds, ukf\n"
        "from slam_uwv_kalman_filters_tpu_torch.parallel import bank, checkpoint, failover, sharding\n"
        "from slam_uwv_kalman_filters_tpu_torch import runtime\n"
        "from slam_uwv_kalman_filters_tpu_torch.utils import aot, config, convert, delayed_states, device, memo, "
        "metrics, tracing, validation\n"
        "from slam_uwv_kalman_filters_tpu_torch.examples import fleet_monte_carlo, full_stack_auv, icra18_mission, "
        "noise_tuning_sweep, online_estimator\n"
        "from slam_uwv_kalman_filters_tpu_torch.tools import float32_drift, host_paths, roofline\n"
        "assert callable(roofline.measure_mxu) and callable(roofline.count_tick_flops)\n"
        "assert all(callable(getattr(aot, n)) for n in ('export_step', 'serialize', 'deserialize', 'save', 'load'))\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'slam_uwv_kalman_filters_tpu.', 'flax', 'orbax', 'msgpack')) "
        "or m in ('slam_uwv_kalman_filters_tpu', 'icra18_mission', 'fleet_monte_carlo', 'online_estimator', "
        "'noise_tuning_sweep', 'full_stack_auv'))\n"
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
    torch.testing.assert_close(kernels.cholesky_banked(cov), kernels.cholesky_plain(cov), rtol=0, atol=0)
    rhs = torch.randn(5, 12, 3, dtype=torch.float64)
    torch.testing.assert_close(kernels.solve_spd_banked(cov, rhs), kernels.solve_spd_plain(cov, rhs), rtol=0, atol=0)
    assert all(k.launches == 0 for k in cuda_lib.KERNELS.values())
    assert "lib" not in cuda_lib._STATE  # nothing was built or loaded
