"""Time K11 (the PoseUKF visual-marker update, 4 corners) and K4 (the
generic-h update tail at m = 6) alone on the card.

Operands are made on the card from a seed: mission-like states (moved means,
correlated covariances with the initial covariance's spread); for K11 the
four corners of a marker 6 m ahead seen from each instance's own pose with
1 px of noise; for K4 the states' own sigma deltas (K1's plain version),
measurement deviations about their mean and a χ² gate that rejects some
instances. Each time is the median of three rounds of CUDA events over
``--reps`` launches held behind a spin kernel, so the host's time to enqueue
each launch is hidden. Prints one JSON line: the card's name and power limit
(``nvidia-smi``), the package it timed, then per kernel and bank the
milliseconds a launch and, where the build has the entry, the warps a block.
The script calls only the wrappers' public signatures, so the same file times
an earlier checkout of the package: run it by path with that checkout's root
first on ``PYTHONPATH``.

    python -m slam_uwv_kalman_filters_tpu_torch.tools.marker_tail_times --banks 1 256 131072
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

import slam_uwv_kalman_filters_tpu_torch as package
from slam_uwv_kalman_filters_tpu_torch.models import pose_marker_fused as pmf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import kernels
from slam_uwv_kalman_filters_tpu_torch.ops import manifolds as mf
from slam_uwv_kalman_filters_tpu_torch.tools.pose_step_times import device_ms, operands
from slam_uwv_kalman_filters_tpu_torch.utils.config import CameraConfiguration

CORNERS = ((0.15, 0.15, 0.0), (-0.15, 0.15, 0.0), (-0.15, -0.15, 0.0), (0.15, -0.15, 0.0))
CAM_Q = (0.5, -0.5, 0.5, -0.5)  # the optical axis along body +x


def marker_args(ls, device, gen):
    """K11's operands for lanes state ``ls``: a marker 6 m ahead, facing the
    camera, a 1e-3·I pose prior, pixel covariance 4·I."""
    f64 = torch.float64
    t = lambda v: torch.tensor(v, dtype=f64, device=device)
    pos, q = ls.mu_t[0:3].T.double(), ls.mu_t[3:7].T.double()
    mpos, mrot, cam_p, cam_q = t([6.0, 0.0, 0.0]), t(CAM_Q), t([0.1, -0.05, 0.02]), t(CAM_Q)
    cam = CameraConfiguration()
    corners = t(CORNERS)
    qi, pi = mf.affine_inv(*mf.affine_mul(q, pos, cam_q, cam_p))
    f_cam = mf.affine_apply(qi[:, None], pi[:, None], mf.affine_apply(mrot[None], mpos[None], corners))
    px = torch.stack([cam.fx * f_cam[..., 0] / f_cam[..., 2] + cam.cx, cam.fy * f_cam[..., 1] / f_cam[..., 2] + cam.cy],
                     -1)
    px = px + torch.randn(px.shape, generator=gen, dtype=f64, device=device)
    return pmf.marker_operands(ls, px, 4.0 * torch.eye(2, dtype=f64, device=device), corners, mpos, mrot,
                               1e-3 * torch.eye(6, dtype=f64, device=device), cam, cam_p, cam_q,
                               nb=ls.cov_t.shape[-1])[1]


def tail_args(ls, dtype, device, gen, m: int = 6):
    """K4's operands for lanes state ``ls``: its sigma deltas, deviations of
    0.1 about their mean, R = 0.05·I, every 7th ν far out of a χ² gate."""
    nb = ls.cov_t.shape[-1]
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=dtype, device=device)
    dz = 0.1 * rn(2 * 53 + 1, m, nb)
    nu = 0.3 * rn(m, nb)
    nu[:, ::7] += 10.0
    r = (0.05 * torch.eye(m, dtype=dtype, device=device))[..., None].expand(m, m, nb).contiguous()
    return (kernels.sigma_deltas_lanes_plain(ls.cov_t).contiguous(), (dz - dz.mean(0)).contiguous(), nu, r,
            ls.mu_t, ls.cov_t, 5.991)


def warps(name: str, dtype, *sizes):
    try:
        return cuda_lib.KERNELS[name].warps_per_block(dtype, *sizes)
    except (AttributeError, TypeError, RuntimeError):
        return None  # a build without the entry (one thread per instance)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--banks", type=int, nargs="+", default=[1, 256, 131072])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--kernels", nargs="+", choices=["pose_markers", "pose_update_tail"],
                    default=["pose_markers", "pose_update_tail"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("marker_tail_times needs an NVIDIA GPU")
    device, dtype = torch.device("cuda", 0), getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"card": card, "package": package.__file__, "dtype": args.dtype, "times": []}
    for nb in args.banks:
        gen = torch.Generator(device=device).manual_seed(nb)
        ls, _, _ = operands(nb, dtype, device)
        calls = {}
        if "pose_markers" in args.kernels:
            margs = marker_args(ls, device, gen)
            calls["pose_markers"] = (lambda: pmf.pose_markers_lanes_cuda(*margs), ())
        if "pose_update_tail" in args.kernels:
            targs = tail_args(ls, dtype, device, gen)
            calls["pose_update_tail"] = (lambda: puf.update_tail_cuda(*targs), (6,))
        for name, (fn, sizes) in calls.items():
            reps = args.reps if nb > 4096 else 10 * args.reps
            ms = device_ms(fn, reps)
            per_block = warps(name, dtype, *sizes, nb)
            out["times"].append({"kernel": name, "bank": nb, "ms": ms, "warps_per_block": per_block})
            print(f"{name} bank={nb} {args.dtype}: {ms:.4f} ms", flush=True)
        del ls, calls
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
