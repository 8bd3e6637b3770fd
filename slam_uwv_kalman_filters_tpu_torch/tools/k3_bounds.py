"""K3's float32 launch bound against its time, on the card.

K3 (``csrc/pose_update.cu``) caps its float32 registers at 128 a thread
(``__launch_bounds__(256, 2)``) so that 16 warps fit an SM, and ``ptxas``
spills a little to meet the cap. This script builds a second copy of the
package under ``build/k3_bounds/`` with the cap lifted (``__launch_bounds__(256,
1)``), then times K3 for every model at bank 131 072 in float32 in separate
processes, in the order capped, lifted, lifted, capped, and prints each
build's ``ptxas`` line, warps a block and milliseconds a launch::

    python -m slam_uwv_kalman_filters_tpu_torch.tools.k3_bounds

It needs a card; it builds nothing at import.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CAPPED = "__launch_bounds__(kWarpSize* kMaxWarps, sizeof(T) == 4 ? 2 : 1)"
LIFTED = "__launch_bounds__(kWarpSize* kMaxWarps, 1)"


def time_k3(label: str, nb: int = 131072, reps: int = 5) -> None:
    """Time K3 from the package on ``sys.path`` (float32, every model, shared
    aux) on random SPD covariances with the 53-DOF spread; print the result."""
    import torch

    from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
    from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib

    entry = ""
    for line in cuda_lib.build_info()["ptxas"].splitlines():
        entry = line.split("'")[1] if "Compiling entry" in line and "'" in line else entry
        if "pose_update_model_kernelIf" in entry and ("registers" in line or "stack frame" in line):
            print(label, "ptxas:", line.strip(), flush=True)
    dev, dt, n = torch.device("cuda"), torch.float32, puf.TANGENT_DIM
    gen = torch.Generator(device=dev).manual_seed(1)
    g = torch.randn(4096, n, n, generator=gen, device=dev, dtype=torch.float64)
    c = g @ g.transpose(1, 2) / n + torch.eye(n, device=dev, dtype=torch.float64)
    sd = torch.sqrt(torch.diagonal(c, dim1=1, dim2=2))
    scale = torch.sqrt(10.0 ** (4 * torch.rand(n, generator=gen, device=dev, dtype=torch.float64) - 4))
    c = c / (sd[:, :, None] * sd[:, None, :]) * scale[None, :, None] * scale[None, None, :]
    cov_t = c.permute(2, 1, 0).to(dt).repeat(1, 1, nb // 4096).contiguous()
    mu = torch.zeros(puf.STORAGE_DIM, nb, device=dev, dtype=dt)
    mu[3], mu[19], mu[53] = 1.0, 9.81, 1e-4
    mu[0:3] = torch.randn(3, nb, generator=gen, device=dev)
    mu[7:10] = 0.5 * torch.randn(3, nb, generator=gen, device=dev)
    mscal = torch.rand(119, 1, generator=gen, device=dev).to(dt)
    aux = {"pressure": (101325.0, 0.1, 0.2, -0.3), "water_velocity": (0.3,), "body_efforts": (0.01, 0.02, -0.01)}
    ms = {}
    for model, m in puf.FUSED_MODELS.items():
        z = torch.randn(m, nb, generator=gen, device=dev).to(dt)
        r = (torch.eye(m, device=dev, dtype=dt) * 0.5)[..., None].expand(m, m, nb).contiguous()
        args = (model, z, r, mu, cov_t, puf._scal_block(None, aux.get(model, ()), dt, dev), None,
                mscal if model == "body_efforts" else None)
        puf.update_model_lanes_cuda(*args)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            puf.update_model_lanes_cuda(*args)
        stop.record()
        torch.cuda.synchronize()
        ms[model] = start.elapsed_time(stop) / reps
    warps = [cuda_lib.KERNELS["pose_update_model"].warps_per_block(dt, i, nb) for i in range(len(puf.FUSED_MODELS))]
    print(label, "ms:", " ".join(f"{k}={v:.3f}" for k, v in ms.items()), "warps a block:", warps, flush=True)


def main() -> int:
    if len(sys.argv) == 3:  # one timing process: <root on sys.path> <label>
        sys.path.insert(0, sys.argv[1])
        time_k3(sys.argv[2])
        return 0
    root = PACKAGE.parent
    lifted = root / "build" / "k3_bounds"
    shutil.rmtree(lifted, ignore_errors=True)
    shutil.copytree(PACKAGE, lifted / PACKAGE.name, ignore=shutil.ignore_patterns("__pycache__"))
    src = lifted / PACKAGE.name / "csrc" / "pose_update.cu"
    text = src.read_text()
    if CAPPED not in text:
        raise RuntimeError(f"{src}: the launch bound {CAPPED!r} is not there")
    src.write_text(text.replace(CAPPED, LIFTED))
    roots = {"capped": root, "lifted": lifted}
    build = "from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib; cuda_lib.library()"
    procs = [subprocess.Popen([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(p)!r}); {build}"])
             for p in roots.values()]
    if any(p.wait() for p in procs):
        return 1
    for label in ("capped", "lifted", "lifted", "capped"):
        if subprocess.run([sys.executable, "-m", "slam_uwv_kalman_filters_tpu_torch.tools.k3_bounds",
                           str(roots[label]), label], cwd=roots[label]).returncode:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
