"""Online estimation loop on the port: streamed sensor events, lanes state.

The counterpart of ``examples/online_estimator.py``, the deployment shape of
the reference's ROCK component (a host callback per sensor sample):

1. sensors deliver an irregular, slightly out-of-order event stream
   (timestamped gyro at the tick rate, DVL every tenth tick, pressure every
   fifth), made one second at a time from ``numpy.random.default_rng(seed)``;
2. the port's streaming packer (``runtime.StreamPacker``, native or NumPy)
   stages each second's events and releases a dense window of ticks with
   validity masks, and the gyro is forward-filled (``runtime.forward_fill``);
3. a bank of PoseUKF instances advances tick by tick in the kernels' lanes
   layout (``pose_fused.LanesBankState``), never converted in between: a K2
   predict and K3 updates for the tick's DVL and pressure samples, or with
   ``--fused-step`` one K5 launch (predict and the tick's updates) on a tick
   that has a sample.

``--aot`` exports every tick function (``utils.aot``), round-trips it through
bytes and runs the loaded steps: on the card each is a CUDA graph captured on
its first call and replayed after, with no model code in the loop.

Run:
    python -m slam_uwv_kalman_filters_tpu_torch.examples.online_estimator --bank 128 --fused-step
    python -m slam_uwv_kalman_filters_tpu_torch.examples.online_estimator --bank 1 --fused-step --aot
    python -m slam_uwv_kalman_filters_tpu_torch.examples.online_estimator --cpu --bank 4 --seconds 2 --rate 25
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import runtime
from ..models import pose_fused, pose_update_fused
from ..models import pose_ukf as pukf
from ..ops import dynamics as dyn
from ..parallel import bank as bankmod
from ..utils.config import default_pose_ukf_config
from ..utils.device import resolve_device

__all__ = ["GYRO", "DVL", "PRESS", "TRUE_VELOCITY", "DEPTH", "make_event_chunk", "estimator_setup",
           "tick_functions", "exported_ticks", "run_window", "main"]

GYRO, DVL, PRESS = 0, 1, 2
TRUE_VELOCITY = (0.4, -0.1, 0.0)
DEPTH = -12.0
G = 9.8209


def make_event_chunk(rng, t0_us, chunk_s, rate, true_v, depth, g, rho, p_atm):
    """One second of irregular sensor traffic, shuffled out of order (the
    JAX example's generator, draw for draw)."""
    dt_us = int(1e6 / rate)
    ts, ids, payloads = [], [], []
    for k in range(int(chunk_s * rate)):
        t = t0_us + k * dt_us + rng.integers(-dt_us // 4, dt_us // 4)
        ts.append(t)
        ids.append(GYRO)
        payloads.append(np.concatenate([rng.normal(scale=1e-4, size=3), np.zeros(3)]))
        if k % 10 == 0:
            ts.append(t + 1000)
            ids.append(DVL)
            payloads.append(np.concatenate([true_v + rng.normal(scale=2e-3, size=3), np.zeros(3)]))
        if k % 5 == 0:
            p = p_atm - depth * g * rho + rng.normal(scale=50.0)
            ts.append(t + 2000)
            ids.append(PRESS)
            payloads.append(np.asarray([p, 0, 0, 0, 0, 0]))
    order = rng.permutation(len(ts))  # network reordering
    return np.asarray(ts, np.int64)[order], np.asarray(ids, np.int32)[order], np.stack(payloads)[order]


def estimator_setup(bank: int, rate: float, device, dtype=torch.float32):
    """The example's filter (0.5 m position and 1e-4 rad² attitude priors at
    ``DEPTH``, zero rotation rate) replicated ``bank`` times. Returns
    (bank-first state, params, lanes state)."""
    eye = torch.eye(3, dtype=dtype, device=device)
    state, params = pukf.init_from_pose(
        imu_in_nwu_pos=torch.tensor([0.0, 0.0, DEPTH], dtype=dtype, device=device),
        imu_in_nwu_pos_cov=eye * 0.25,
        imu_in_nwu_rot=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device),
        imu_in_nwu_rot_cov=eye * 1e-4,
        config=default_pose_ukf_config(),
        model_parameters=dyn.default_uwv_parameters(dtype=dtype, device=device),
        imu_delta_t=1.0 / rate, dtype=dtype, device=device,
    )
    state = pukf.integrate_rotation_rate(state, torch.zeros(3, dtype=dtype, device=device))
    like = bankmod.replicate(state, bank)
    return like, params, pose_fused.to_lanes(like)


def tick_functions(params, dt: float) -> dict:
    """The six tick functions of the JAX example, each a function of
    tensors only (what ``--aot`` exports): ``predict(ls, rr)``, ``dvl(ls,
    z)``, ``press(ls, z)`` and the whole steps ``step_dvl(ls, rr, z)``,
    ``step_press(ls, rr, z)``, ``step_both(ls, rr, zv, zp)``."""
    dtype, device = params.process_noise.dtype, params.process_noise.device
    r_dvl = torch.eye(3, dtype=dtype, device=device) * 1e-4
    r_press = torch.eye(1, dtype=dtype, device=device) * 2500.0
    press_aux = (params.atmospheric_pressure, 0.0, 0.0, 0.0)
    dvl_up = lambda z: pose_update_fused.StepUpdate("velocity", z, r_dvl)
    press_up = lambda z: pose_update_fused.StepUpdate("pressure", z, r_press, None, press_aux)

    def predict(ls, rr):
        return pose_fused.predict_lanes(pose_fused.set_rotation_rate_lanes(ls, rr), params, dt)

    def dvl(ls, z):
        return pose_update_fused.update_model_lanes("velocity", ls, z, r_dvl)[0]

    def press(ls, z):
        return pose_update_fused.update_model_lanes("pressure", ls, z, r_press, aux=press_aux)[0]

    def step(ls, rr, updates):
        return pose_update_fused.step_lanes(pose_fused.set_rotation_rate_lanes(ls, rr), params, dt, updates)[0]

    return {
        "predict": predict, "dvl": dvl, "press": press,
        "step_dvl": lambda ls, rr, z: step(ls, rr, [dvl_up(z)]),
        "step_press": lambda ls, rr, z: step(ls, rr, [press_up(z)]),
        "step_both": lambda ls, rr, zv, zp: step(ls, rr, [dvl_up(zv), press_up(zp)]),
    }


def exported_ticks(ticks: dict, ls, fused_step: bool) -> tuple[dict, dict]:
    """Each tick function exported at the bank's shapes, serialized and
    loaded back (``utils.aot``), as the JAX example's ``--aot`` does: the
    separate ticks always, the whole steps with ``fused_step``. Returns the
    loaded steps by name and the export seconds and artifact bytes."""
    from ..utils import aot

    nb, dtype, device = ls.cov_t.shape[-1], ls.cov_t.dtype, ls.cov_t.device
    rr, zv, zp = (torch.zeros((nb, m), dtype=dtype, device=device) for m in (3, 3, 1))
    examples = {"predict": (ls, rr), "dvl": (ls, zv), "press": (ls, zp)}
    if fused_step:
        examples.update(step_dvl=(ls, rr, zv), step_press=(ls, rr, zp), step_both=(ls, rr, zv, zp))
    loaded, export_s, nbytes = {}, 0.0, 0
    for name, example in examples.items():
        t0 = time.perf_counter()
        blob = aot.serialize(aot.export_step(ticks[name], *example))
        export_s += time.perf_counter() - t0
        nbytes += len(blob)
        loaded[name] = aot.deserialize(blob)
    return loaded, {"export_s": export_s, "artifact_bytes": nbytes}


def run_window(ticks: dict, ls, values, valid, gyro_vals, fused_step: bool):
    """Dispatch one released window tick by tick against the lanes state;
    every tick's inputs are copied from the host as the JAX example's are."""
    nb, dtype, device = ls.cov_t.shape[-1], ls.cov_t.dtype, ls.cov_t.device
    lanes = lambda x: torch.from_numpy(np.tile(x, (nb, 1))).to(device=device, dtype=dtype)
    for k in range(values.shape[1]):
        rr = lanes(gyro_vals[k, :3])
        zv = lanes(values[DVL, k, :3]) if valid[DVL, k] else None
        zp = lanes(values[PRESS, k, :1]) if valid[PRESS, k] else None
        if fused_step and zv is not None and zp is not None:
            ls = ticks["step_both"](ls, rr, zv, zp)
        elif fused_step and zv is not None:
            ls = ticks["step_dvl"](ls, rr, zv)
        elif fused_step and zp is not None:
            ls = ticks["step_press"](ls, rr, zp)
        else:
            ls = ticks["predict"](ls, rr)
            if zv is not None:
                ls = ticks["dvl"](ls, zv)
            if zp is not None:
                ls = ticks["press"](ls, zp)
    return ls


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    """Run the estimator; returns its figures, the final lanes state
    (``lanes``), its bank-first form (``state``) and, with ``--aot``, the
    loaded steps (``loaded``). Raises where the
    velocity error reaches 0.02 m/s, and, without ``--cpu``, on a machine
    without a card."""
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bank", type=int, default=1024)
    p.add_argument("--seconds", type=int, default=10)
    p.add_argument("--rate", type=float, default=100.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (the plain versions of the kernels)")
    p.add_argument("--fused-step", action="store_true",
                   help="predict and the tick's sensor updates in one launch (K5, step_lanes)")
    p.add_argument("--aot", action="store_true",
                   help="export every tick function, round-trip it through bytes and run the loaded steps "
                        "(CUDA graphs on the card)")
    args = p.parse_args(argv)

    device = torch.device("cpu") if args.cpu else resolve_device(None)
    dtype = torch.float32
    rng = np.random.default_rng(args.seed)
    dt = 1.0 / args.rate
    n_ticks = int(args.rate)  # one-second windows
    cfg = default_pose_ukf_config()
    rho, p_atm = float(cfg.hydrostatics.water_density), float(cfg.hydrostatics.atmospheric_pressure)
    true_v = np.array(TRUE_VELOCITY)
    like, params, ls = estimator_setup(args.bank, args.rate, device, dtype)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={name} bank={args.bank} native_packer={runtime.native_available()} "
          f"fused_step={args.fused_step} aot={args.aot}")

    ticks = tick_functions(params, dt)
    loaded, figures = {}, {}
    if args.aot:
        loaded, figures = exported_ticks(ticks, ls, args.fused_step)
        ticks = {**ticks, **loaded}
        print(f"exported {len(loaded)} tick functions in {figures['export_s']:.1f} s, "
              f"{figures['artifact_bytes']} bytes")

    last_gyro = np.zeros(3)  # the gyro is an input: a tick without an event keeps the last rate
    total_events = 0
    wall = steady_wall = 0.0
    steady_chunks = 0
    packer = runtime.StreamPacker(np.asarray([3, 3, 1], np.int32), t0_us=0, dt_us=int(1e6 / args.rate),
                                  window_ticks=n_ticks, payload_stride=6)
    for sec in range(args.seconds):
        ts, ids, payloads = make_event_chunk(rng, int(sec * 1e6), 1.0, args.rate, true_v, DEPTH, G, rho, p_atm)
        total_events += len(ts)
        t_start = time.perf_counter()
        packer.push(ts, ids, payloads)
        widx, values, valid = packer.pop(force=True)
        if widx != sec:
            raise AssertionError(f"online estimator: window {widx} released for second {sec}")
        gyro_vals, _ = runtime.forward_fill(values[GYRO], valid[GYRO], last_gyro)
        last_gyro = gyro_vals[-1, :3].copy()
        ls = run_window(ticks, ls, values, valid, gyro_vals, args.fused_step)
        _sync(device)
        chunk_wall = time.perf_counter() - t_start
        wall += chunk_wall
        if sec > 0:  # the first second builds the kernels (or captures the graphs)
            steady_wall += chunk_wall
            steady_chunks += 1
        if sec in (0, args.seconds - 1):
            v = pose_fused.from_lanes(ls, like).mu.velocity[0].double().cpu().numpy()
            print(f"t={sec + 1:3d}s  chunk wall={chunk_wall * 1e3:6.0f} ms  v=({v[0]:+.3f},{v[1]:+.3f},{v[2]:+.3f})")

    state = pose_fused.from_lanes(ls, like)
    v = state.mu.velocity[0].double().cpu().numpy()
    err = float(np.abs(v - true_v).max())
    rt = steady_chunks / steady_wall if steady_chunks else args.seconds / wall
    print(f"{total_events} events, {packer.dropped} dropped; steady state {rt:.3f}x real time at "
          f"{args.rate:.0f} Hz x bank {args.bank} (first second {wall - steady_wall:.3f} s)")
    print(f"final velocity error: {err:.4f} m/s")
    if loaded:
        figures.update(captures=sum(t.captures for t in loaded.values()),
                       replays=sum(t.replays for t in loaded.values()),
                       capture_s=sum(t.capture_s for t in loaded.values()))
    if not err < 0.02:
        raise AssertionError(f"online estimator diverged: velocity error {err} m/s")
    print("ONLINE OK")
    return {"device": name, "bank": args.bank, "real_time_factor": rt, "first_second_s": wall - steady_wall,
            "velocity_error_m_s": err, "events": total_events, "dropped": int(packer.dropped),
            "native_packer": bool(packer.native), **figures, "lanes": ls, "state": state, "loaded": loaded}


if __name__ == "__main__":
    main()
