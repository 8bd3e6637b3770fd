"""Time K2 (the fused PoseUKF predict, shared and full mode) and K5 (the
whole step on the online chain [acceleration, velocity]) alone on the card.

Operands are mission-like states made on the card from a seed: moved means,
correlated covariances with the initial covariance's spread, a banked
parameter draw for the full mode. Each time is the median of three rounds
of CUDA events over ``--reps`` launches held behind a spin kernel, so the
host's time to enqueue each launch is hidden. Prints one JSON line: the
card's name and power limit (``nvidia-smi``), then per kernel and bank the
milliseconds a launch and, where the build has the entry, the warps a
block. The script calls only the wrappers' public signatures, so the same
file times an earlier checkout of the package (run it from that checkout's
root with ``python -m``).

    python -m slam_uwv_kalman_filters_tpu_torch.tools.pose_step_times --banks 1 256 131072
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from slam_uwv_kalman_filters_tpu_torch.models import pose_fused as pf
from slam_uwv_kalman_filters_tpu_torch.models import pose_ukf as pukf
from slam_uwv_kalman_filters_tpu_torch.models import pose_update_fused as puf
from slam_uwv_kalman_filters_tpu_torch.ops import cuda_lib
from slam_uwv_kalman_filters_tpu_torch.ops import dynamics as dyn
from slam_uwv_kalman_filters_tpu_torch.parallel import bank
from slam_uwv_kalman_filters_tpu_torch.utils.config import default_pose_ukf_config

DT = 0.01
N = 53


def operands(nb: int, dtype, device, seed: int = 0):
    """(lanes state, shared params, banked full-mode operands) at bank nb."""
    f64 = torch.float64
    gen = torch.Generator(device=device).manual_seed(seed)
    state, params = pukf.init_from_pose(
        torch.zeros(3, dtype=f64), torch.eye(3, dtype=f64) * 0.01,
        torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=f64), torch.eye(3, dtype=f64) * 1e-4,
        default_pose_ukf_config(), dyn.default_uwv_parameters(device=device), device=device,
    )
    rn = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float32, device=device)
    g = rn(nb, N, N)
    c = torch.baddbmm(torch.eye(N, device=device).expand(nb, N, N), g, g.transpose(1, 2), alpha=1.0 / N)
    s = torch.sqrt(torch.diagonal(c, dim1=1, dim2=2))
    sd = torch.sqrt(torch.diagonal(state.cov)).float()
    cov = (c / (s[:, :, None] * s[:, None, :]) * sd[None, :, None] * sd[None, None, :]).to(dtype)
    del g, c
    bs = bank.replicate(bank.tree_map(lambda a: a.to(dtype), state), nb)
    bs = bs._replace(mu=bs.mu._replace(position=rn(nb, 3).to(dtype), velocity=(0.5 * rn(nb, 3)).to(dtype)),
                     cov=cov, rotation_rate=(0.01 * rn(nb, 3)).to(dtype))
    p = bank.tree_map(lambda a: a.to(dtype), params)
    draw = lambda *sh: (1.0 + 0.2 * rn(nb, *sh).clamp(-3, 3)).to(dtype)
    bp = bank.tree_map(lambda x: x.expand(nb, *x.shape), p)
    bp = bp._replace(process_noise=bp.process_noise * draw()[:, None, None],
                     water_velocity_scale=bp.water_velocity_scale * draw(),
                     gyro_bias_tau=bp.gyro_bias_tau * draw(), quad_damping_tau=bp.quad_damping_tau * draw())
    return pf.to_lanes(bs), p, pf.banked_predict_operands(bp, DT, dtype)


def device_ms(fn, reps: int, hold: int = 200_000) -> float:
    """Median of three rounds of ``reps`` launches, held behind ``hold`` spin
    cycles per launch (~0.1 ms by default) while the host enqueues them."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(hold * reps)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        rounds.append(start.elapsed_time(stop) / reps)
    return sorted(rounds)[1]


def warps(name: str, dtype, nb: int):
    try:
        return cuda_lib.KERNELS[name].warps_per_block(dtype, nb)
    except (AttributeError, TypeError, KeyError):
        return None  # a build without the entry (one thread per instance)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--banks", type=int, nargs="+", default=[1, 128, 256, 131072])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dtype", choices=["float32", "float64"], default="float32")
    ap.add_argument("--kernels", nargs="+", choices=["pose_predict", "pose_predict_full", "pose_step"],
                    default=["pose_predict", "pose_predict_full", "pose_step"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pose_step_times needs an NVIDIA GPU")
    device, dtype = torch.device("cuda", 0), getattr(torch, args.dtype)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"card": card, "dtype": args.dtype, "times": []}
    for nb in args.banks:
        ls, p, bo = operands(nb, dtype, device)
        shared = pf._predict_operands_shared(p, DT, dtype)
        z_vel = torch.zeros(3, nb, dtype=dtype, device=device)
        z_acc = z_vel.clone()
        z_acc[2] = 9.81  # about the specific force at rest
        r = (torch.eye(3, dtype=dtype, device=device) * 1e-3)[..., None].expand(3, 3, nb).contiguous()
        s6 = torch.cat([puf._scal_block(None, (), dtype, device).T] * 2).contiguous()
        calls = {
            "pose_predict": lambda: pf.predict_lanes_cuda(ls.cov_t, ls.mu_t, ls.rr_t, *shared),
            "pose_predict_full": lambda: pf.predict_lanes_cuda(ls.cov_t, ls.mu_t, ls.rr_t, bo.coeff, bo.offs,
                                                               bo.q0m_t, bo.scal, bo.aux_t),
            "pose_step": lambda: puf.pose_step_lanes_cuda(("acceleration", "velocity"), ls.cov_t, ls.mu_t, ls.rr_t,
                                                          *shared, [z_acc, z_vel], [r, r], s6),
        }
        for name in args.kernels:
            fn = calls[name]
            reps = args.reps if nb > 4096 else 10 * args.reps
            ms = device_ms(fn, reps)
            out["times"].append({"kernel": name, "bank": nb, "ms": ms, "warps_per_block": warps(name, dtype, nb)})
            print(f"{name} bank={nb} {args.dtype}: {ms:.4f} ms", flush=True)
        del ls, bo, calls
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
